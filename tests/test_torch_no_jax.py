"""The port stands alone: with JAX and the JAX package made unimportable,
every module of orbslam3_tpu_torch imports (the visual-inertial ones
among them) and one small frame runs through FusedSlam on the CPU under the
stereo configuration and under the stereo-inertial one, then one chunk of
two frames, one compaction pass and one checkpoint round trip (the machine
with the card has no JAX); a loop closer built from a vocabulary services
one keyframe and drains, global BA takes a step, and FusedSlam builds and
warms up its loop closer."""
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
import os, tempfile
from orbslam3_tpu_torch.map.checkpoint import load_map, save_map
from orbslam3_tpu_torch.map.compaction import compact_map
slam = FusedSlam(world.cam, cfg, chunk=2, device="cpu")
assert slam.process_frame(left, right, *world.imu_window(0.0, 0.0), 0.0) is None
out = slam.process_frame(*world.render_frame(0.1), *world.imu_window(0.0, 0.1), 0.1)
assert out.p.shape == (2, 3) and out.mode.tolist() == [MODE_OK, MODE_OK], out
st, kf_map, mp_map = compact_map(slam.map)
assert int(st.n_kf) == int(slam.map.kf_valid.sum()) >= 1 and int(kf_map[0]) == 0
with tempfile.TemporaryDirectory() as d:
    save_map(os.path.join(d, "m.npz"), slam.map, slam.ts)
    m2, ts2 = load_map(os.path.join(d, "m.npz"), with_track_state=True, device="cpu")
assert int(m2.n_kf) == int(slam.map.n_kf) and bool((m2.kf_p == slam.map.kf_p).all())
again = FusedSlam.from_state(world.cam, cfg, m2, ts2, chunk=2, device="cpu")
assert again._n_kf == int(slam.map.n_kf)
for name in ("optim.vi_ba", "optim.imu_init", "optim.robust_pose", "map.triangulation",
             "map.mapping_ops", "map.compaction", "map.checkpoint", "viz.export",
             "geometry.se3", "geometry.sim3", "loop.sim3", "loop.vocab", "optim.pose_graph",
             "loop.closer", "parallel.distributed_ba", "utils.logging"):
    assert "orbslam3_tpu_torch." + name in names, name
import numpy as np
from orbslam3_tpu_torch.loop import vocab as vb
from orbslam3_tpu_torch.loop.closer import LoopCloser, LoopConfig
from orbslam3_tpu_torch.parallel.distributed_ba import global_ba, make_point_table
voc = vb.train_vocabulary(np.random.default_rng(0).integers(0, 256, (300, 32)).astype(np.uint8),
                          k=4, levels=2)
closer = LoopCloser(voc, LoopConfig(recent_gap=1))
st, c = closer.on_keyframe(slam.map, 0, slam.cam, multi_map=True)
assert closer.pending_kf == 0 and not c
st, c = closer.drain(st, slam.cam)
assert closer.pending_kf is None and closer.host_syncs == 1 and not c
pts, ids = make_point_table(st, 256, 4)
q, p, X = global_ba(pts, st.kf_q, st.kf_p, st.kf_valid, slam.cam, iters=1)
assert q.shape == st.kf_q.shape
with_loop = FusedSlam(world.cam, cfg, vocabulary=voc, chunk=2, device="cpu", warmup=True,
                      loop_cfg=LoopConfig(vi_refine_points=512))
assert with_loop.loop_closer is not None
assert not any(k == "jax" or k.startswith(("jax.", "orbslam3_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("modules", len(names))
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[-1]) >= 35


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import orbslam3_tpu\b(?!_torch)|"
                     r"from orbslam3_tpu(\.|\s))", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    hits += [str(ROOT / "chip_smoke.py")] * bool(pat.search((ROOT / "chip_smoke.py").read_text()))
    assert not hits, hits
