"""The port stands alone: with JAX and the JAX package made unimportable,
every module of orbslam3_tpu_torch imports (the visual-inertial ones
among them) and one small frame runs through FusedSlam on the CPU under the
stereo configuration and under the stereo-inertial one, then one chunk of
two frames, one compaction pass and one checkpoint round trip (the machine
with the card has no JAX); a loop closer built from a vocabulary services
one keyframe and drains, global BA takes a step (and the same step over a
one-rank gloo group), FusedSlam builds and warms up its loop closer, a
two-session fleet flushes and entry() runs; an EuRoC-format fixture is
written, loaded (images through the native loader, with PIL unimportable
where g++ can build it) and one stereo pair is rectified; the port's
runner scripts import no JAX either. The host-orchestrated SlamSystem tracks
two frames in both configurations, local_ba_step takes a step, a SlamSystem
state is carried into another (interop.carry_slam_system), and
scripts/profile_pipeline_torch.py imports; scripts/view_checkpoint_torch.py
renders a checkpoint, and scripts/eval_suite_torch.py reads the JAX record
(data/eval_reference.json) and builds its table; scripts/scenarios_torch.py
reads its JAX record (data/scenario_reference.json), poisons a tracker
through the port's API and holds a record, and chip_smoke.py (phase 13
among its phases) imports."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "orbslam3_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, shutil, sys
sys.modules["jax"] = None
sys.modules["orbslam3_tpu"] = None
if shutil.which("g++"):
    sys.modules["PIL"] = None
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
from orbslam3_tpu_torch.interop import SLAM_SYSTEM_STATE, carry_slam_system, to_numpy_tree
from orbslam3_tpu_torch.models.local_mapper import local_ba_step
from orbslam3_tpu_torch.models.slam import FrameResult, SlamSystem
import torch
for base in (SLICE_CFG, BENCH_CFG):
    ss = SlamSystem(world.cam, cfg._replace(use_imu=base.use_imu), device="cpu")
    r0 = ss.process_frame(left, right, *world.imu_window(0.0, 0.0), 0.0)
    r1 = ss.process_frame(*world.render_frame(0.1), *world.imu_window(0.0, 0.1), 0.1)
    assert isinstance(r1, FrameResult) and r0.is_keyframe and r1.state == "Ok", (r0, r1)
_, ba = local_ba_step(ss.map, ss.cam, torch.tensor(0, dtype=torch.int32), window=2,
                      max_points=256, iters=1, fixed=0)
assert ba.q.shape == (2, 4)
state = {k: getattr(ss, k) for k in SLAM_SYSTEM_STATE}
state["map"] = to_numpy_tree(state["map"])
ss2 = SlamSystem(world.cam, cfg, device="cpu")
vars(ss2).update(carry_slam_system(state, "cpu"))
assert ss2.last_kf_id == ss.last_kf_id and torch.equal(ss2.map.kf_p, ss.map.kf_p)
import importlib.util
spec = importlib.util.spec_from_file_location("profile_pipeline_torch",
                                              "scripts/profile_pipeline_torch.py")
prof = importlib.util.module_from_spec(spec)
spec.loader.exec_module(prof)
assert "full process_frame" in prof.STAGES
import os, tempfile
from orbslam3_tpu_torch.map.checkpoint import load_map, save_map
from orbslam3_tpu_torch.map.compaction import compact_map
slam = FusedSlam(world.cam, cfg, chunk=2, device="cpu")
assert slam.process_frame(left, right, *world.imu_window(0.0, 0.0), 0.0) is None
out = slam.process_frame(*world.render_frame(0.1), *world.imu_window(0.0, 0.1), 0.1)
assert out.p.shape == (2, 3) and out.mode.tolist() == [MODE_OK, MODE_OK], out
st, kf_map, mp_map = compact_map(slam.map)
assert int(st.n_kf) == int(slam.map.kf_valid.sum()) >= 1 and int(kf_map[0]) == 0
def script(name):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
with tempfile.TemporaryDirectory() as d:
    save_map(os.path.join(d, "m.npz"), slam.map, slam.ts)
    m2, ts2 = load_map(os.path.join(d, "m.npz"), with_track_state=True, device="cpu")
    assert script("view_checkpoint_torch").main([os.path.join(d, "m.npz"),
                                                 os.path.join(d, "m.html"), "--device", "cpu"]) == 0
    assert '"kf": [[' in open(os.path.join(d, "m.html")).read()
es = script("eval_suite_torch")
ref = es.load_reference()
assert ref["small"]["n_frames"] == 32 and len(ref["runs"]) >= 1
rec = es.run_record([(left, right)], [MODE_OK], [1], [0], None, [])
assert es.first_departure(rec, rec) == "none" and len(rec["checksum"]["first"]) == 16
assert "| Stereo (visual only) |" in es.table([dict(mode="stereo", ate_m=0.1, rpe_m=0.01,
    rpe_rad=0.001, fps=2.0, imu_init=None, loops=None)], ["stereo"], 1, 8.0, 8, "cpu")
sc = script("scenarios_torch")
scen = sc.load_reference()["scenarios"]
assert set(sc.RUNS) | {sc.ORBVOC} == set(scen)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.scenario_phase)
from orbslam3_tpu_torch.geometry import quat
sw, scfg, stimes = sc.build(sc.port_pkg(), "poisoned_ransac")
spoil = FusedSlam(sw.cam, scfg, service_every=4, device="cpu")
q0 = spoil.ts.q.clone()
sc.poison(spoil, lambda x: torch.tensor(x, dtype=torch.float32), quat)
assert not torch.equal(spoil.ts.q, q0) and torch.equal(
    spoil.ts.motion_dp, torch.tensor([0.5, 0.5, -0.3]))
assert all(ok for _, ok in sc.holds("kf_capacity_guard", scen["kf_capacity_guard"],
                                    scen["kf_capacity_guard"], None))
assert int(m2.n_kf) == int(slam.map.n_kf) and bool((m2.kf_p == slam.map.kf_p).all())
again = FusedSlam.from_state(world.cam, cfg, m2, ts2, chunk=2, device="cpu")
assert again._n_kf == int(slam.map.n_kf)
for name in ("optim.vi_ba", "optim.imu_init", "optim.robust_pose", "map.triangulation",
             "map.mapping_ops", "map.compaction", "map.checkpoint", "viz.export",
             "geometry.se3", "geometry.sim3", "loop.sim3", "loop.vocab", "optim.pose_graph",
             "loop.closer", "parallel.distributed_ba", "utils.logging", "io.euroc",
             "io.rectify", "io.native", "io.euroc_fixture", "viz.html_view", "viz.live",
             "parallel.multi_session", "parallel.ranks", "entry", "models.slam",
             "models.local_mapper", "interop"):
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
import torch
from orbslam3_tpu_torch.io.euroc import EurocDataset
from orbslam3_tpu_torch.io.euroc_fixture import write_fixture
from orbslam3_tpu_torch.io.rectify import remap_u8, stereo_rectify_maps
with tempfile.TemporaryDirectory() as d:
    ds = EurocDataset(write_fixture(d, duration=0.2, hz=10.0, scale=0.25))
    left, right = ds.stereo_pair_u8(1)
maps = stereo_rectify_maps(ds.cam0.K, ds.cam0.dist, ds.cam0.T_BS, ds.cam1.K, ds.cam1.dist,
                           ds.cam1.T_BS, ds.cam0.resolution)
rect = remap_u8(torch.from_numpy(left), torch.from_numpy(maps.map_x0),
                torch.from_numpy(maps.map_y0))
assert len(ds) == 2 and rect.shape == left.shape == (120, 188) and rect.float().std() > 1
from orbslam3_tpu_torch.parallel.multi_session import MultiSessionSlam
ms = MultiSessionSlam(world.cam, cfg, n_sessions=2, chunk=2, devices=["cpu", "cpu"])
ms.process_frame(0, *world.render_frame(0.0), *world.imu_window(0.0, 0.0), 0.0)
ms.process_frame(1, *world.render_frame(0.0), *world.imu_window(0.0, 0.0), 0.0)
ms.process_frame(0, *world.render_frame(0.1), *world.imu_window(0.0, 0.1), 0.1)
ms.finalize()
assert ms.launches == [1, 1] and ms.trajectory_arrays(1)[1].shape == (1, 3)
import torch.distributed as dist
from orbslam3_tpu_torch.parallel.distributed_ba import distributed_global_ba
from orbslam3_tpu_torch.parallel.ranks import free_port
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                        rank=0)
q1, p1, X1 = distributed_global_ba(pts, st.kf_q, st.kf_p, st.kf_valid, slam.cam, iters=1)
dist.destroy_process_group()
assert torch.equal(q1, q) and torch.equal(p1, p) and torch.equal(X1, X)
from orbslam3_tpu_torch.entry import entry
fn, args = entry(device="cpu")
assert [tuple(o.shape) for o in fn(*args)] == [(4,), (3,), ()]
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
    for script in [ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("*_torch.py"))]:
        hits += [str(script)] * bool(pat.search(script.read_text()))
    assert not hits, hits
