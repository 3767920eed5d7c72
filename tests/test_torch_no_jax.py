"""The port stands alone: with JAX and the JAX package made unimportable,
every module of orbslam3_tpu_torch imports (the visual-inertial ones
among them) and one small frame runs through FusedSlam on the CPU under the
stereo configuration and under the stereo-inertial one (the machine with
the card has no JAX)."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "orbslam3_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["orbslam3_tpu"] = None
import orbslam3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(orbslam3_tpu_torch.__path__, "orbslam3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from orbslam3_tpu_torch.frontend.orb import OrbConfig
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.map.slam_map import MapCapacity
from orbslam3_tpu_torch.models.fused import BENCH_CFG, MODE_OK, SLICE_CFG, FusedSlam
from orbslam3_tpu_torch.models.tracker import TrackConfig
world = SyntheticWorld(SyntheticConfig(width=256, height=160, fx=160.0, fy=160.0,
                                       n_landmarks=300, duration=0.2, cam_hz=10.0))
left, right = world.render_frame(0.0)
for base in (SLICE_CFG, BENCH_CFG):
    cfg = base._replace(orb=OrbConfig(n_features=128, n_levels=2),
                        cap=MapCapacity(max_kf=8, n_feat=128, max_mp=1024, max_obs=4),
                        track=TrackConfig(p_local=512), ba_points=512)
    slam = FusedSlam(world.cam, cfg, device="cpu")
    out = slam.process_frame(left, right, *world.imu_window(0.0, 0.0), 0.0)
    assert int(out.mode) == MODE_OK and bool(out.is_kf), out
for name in ("optim.vi_ba", "optim.imu_init", "optim.robust_pose", "map.triangulation",
             "map.mapping_ops"):
    assert "orbslam3_tpu_torch." + name in names, name
assert not any(k == "jax" or k.startswith(("jax.", "orbslam3_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("modules", len(names))
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[-1]) >= 25


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import orbslam3_tpu\b(?!_torch)|"
                     r"from orbslam3_tpu(\.|\s))", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    hits += [str(ROOT / "chip_smoke.py")] * bool(pat.search((ROOT / "chip_smoke.py").read_text()))
    assert not hits, hits
