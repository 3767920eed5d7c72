"""Record the JAX runs of scripts/eval_suite.py that the torch port's eval harness is held to.

Runs the JAX package's scripts/eval_suite.py::run_config(seed, 8.0, mode,
chunk=8) on the CPU for seeds 7, 11 and 23 and the seven modes (stereo,
inertial, inertial_easy, loop, extrinsics, revisit, revisit_loop; the
revisit modes run the 24 s world, as eval_suite._get_world forces), and one
short run at the size of tests/test_torch_eval_suite.py (SMALL). For each
run it writes the row run_config returns and, from the run's FusedSlam,
scripts/eval_suite_torch.py::run_record: the frame after which the IMU
initialized, ok_frac, the per-frame tracker mode, keyframe flag and inlier
count, each correction's keyframe pair and times (loop modes), and the
checksums of the first and the last rendered frame. Output:
orbslam3_tpu_torch/data/eval_reference.json; chip_smoke.py (phase 12) and
the tier-1 test hold the port to it. The CPU frames/s in each row is not a
speed figure of any device.

    JAX_PLATFORMS=cpu python scripts/make_eval_reference.py [--jobs 3] [RUN ...]

A RUN is "<mode>:<seed>" or "small". Without RUNs every run is made; each
run is made in a process of its own (one process holding several JAX
FusedSlam compiles runs out of mappable memory), --jobs of them at a time,
and merged into the existing file as it ends.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from eval_suite_torch import MODES, REFERENCE, run_record  # noqa: E402

SEEDS = (7, 11, 23)
DURATION, CHUNK = 8.0, 8
SMALL = dict(seed=11, duration=1.6, mode="inertial")  # 32 frames, 4 chunks
RENDER_WORKERS = 4
# longest first: the loop closer on the 24 s world takes the most CPU time
ORDER = ("revisit_loop", "revisit", "loop", "extrinsics", "inertial", "stereo",
         "inertial_easy")


def _spawn_render(self, times, blackout=None, workers=0):
    """The JAX world's render_sequence with its worker processes spawned:
    forking a process that already runs JAX's threads can deadlock."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from orbslam3_tpu.io.synthetic import _pool_init, _render_one

    blank = np.full((self.cfg.height, self.cfg.width), 127, np.uint8)
    live = [t for t in times if not (blackout is not None and blackout[0] <= t < blackout[1])]
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_pool_init, initargs=(self,)) as ex:
        rendered = dict(zip(live, ex.map(_render_one, live, chunksize=4)))
    return [tuple(x.astype(np.uint8) for x in rendered[t]) if t in rendered else (blank, blank)
            for t in times]


def record_run(seed: int, duration: float, mode: str) -> dict:
    """eval_suite.run_config(seed, duration, mode, chunk=8) with its
    FusedSlam kept: the row and run_record."""
    import eval_suite
    import orbslam3_tpu.models.fused as jf
    from orbslam3_tpu.io.synthetic import SyntheticWorld

    SyntheticWorld.render_sequence = _spawn_render
    kept = []

    class Kept(jf.FusedSlam):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.imu_init_frame = None
            self.corrections = []
            kept.append(self)
            cl = self.loop_closer
            if cl is not None:
                correct = cl._correct

                def recorded(st, kf_id, cand, S_rel, cam, record=True):
                    kf_t = st.kf_time
                    if record:
                        self.corrections.append(dict(
                            kf_id=int(kf_id), cand=int(cand), kf_time=float(kf_t[kf_id]),
                            cand_time=float(kf_t[cand]), frame=self._frames - 1))
                    return correct(st, kf_id, cand, S_rel, cam, record=record)

                cl._correct = recorded

        def _note_init(self):
            if self.imu_init_frame is None and self.imu_initialized:
                self.imu_init_frame = self._frames - 1

        def process_frame(self, *a, **kw):
            out = super().process_frame(*a, **kw)
            self._note_init()
            return out

        def finalize(self):
            out = super().finalize()
            self._note_init()
            return out

    jf.FusedSlam = Kept
    # render before the first JAX computation
    world, times, frames, _ = eval_suite._get_world(seed, duration, mode)
    t0 = time.perf_counter()
    row = eval_suite.run_config(seed, duration, mode, chunk=CHUNK)
    wall = time.perf_counter() - t0
    slam = kept[-1]
    _, outs, _ = slam._flat_outs()
    rec = run_record(frames, [int(o.mode) for o in outs], [int(o.is_kf) for o in outs],
                     [int(o.n_inliers) for o in outs], slam.imu_init_frame, slam.corrections)
    row["cpu_fps"] = row.pop("fps")
    return dict(row, duration_s=duration, chunk=CHUNK, **rec, cpu_wall_s=round(wall, 1))


def dumps(ref: dict) -> str:
    """Indented JSON with each run's per-frame lists on one line each."""
    def one(rec, pad):
        head = {k: v for k, v in rec.items() if k != "per_frame"}
        body = ",\n".join(f'{pad}  "{k}": {json.dumps(v)}' for k, v in head.items())
        pf = ",\n".join(f'{pad}   "{k}": {json.dumps(v)}' for k, v in rec["per_frame"].items())
        return "{\n" + body + f',\n{pad}  "per_frame": {{\n' + pf + f"\n{pad}  }}\n{pad}}}"

    runs = ",\n".join(f'  "{k}": {one(v, "  ")}' for k, v in sorted(ref.get("runs", {}).items()))
    parts = [f' "{k}": {json.dumps(v)}' for k, v in ref.items() if k not in ("runs", "small")]
    if "small" in ref:
        parts.append(f' "small": {one(ref["small"], " ")}')
    parts.append(' "runs": {\n' + runs + "\n }")
    return "{\n" + ",\n".join(parts) + "\n}\n"


def merge(name: str, rec: dict):
    ref = {}
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            ref = json.load(f)
    ref.update(config="scripts/eval_suite.py::run_config: SlamConfig(use_imu=mode != 'stereo', "
                      "kf_max_frames=6, ba_iters=3, ba_window=6, lost_timeout=5.0), "
                      "service_every=8, chunk=8; bench.py::train_world_vocab for the loop "
                      "modes",
               seeds=list(SEEDS), duration_s=DURATION, modes=list(MODES),
               note="the JAX package on the CPU: accuracy reference only; cpu_fps is not a "
                    "speed figure of any device")
    if name == "small":
        ref["small"] = rec
    else:
        ref.setdefault("runs", {})[name] = rec
    with open(REFERENCE, "w") as f:
        f.write(dumps(ref))


def run_one(name: str) -> dict:
    import jax

    if name == "small":
        rec = record_run(SMALL["seed"], SMALL["duration"], SMALL["mode"])
    else:
        mode, seed = name.split(":")
        rec = record_run(int(seed), DURATION, mode)
    rec["backend"] = jax.default_backend()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="*", help='"<mode>:<seed>" or "small"; all when none')
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        (name,) = args.runs
        print(json.dumps(run_one(name)))
        return 0
    names = args.runs or [f"{m}:{s}" for m in ORDER for s in SEEDS] + ["small"]
    queue, running, failed = list(names), {}, []
    while queue or running:
        while queue and len(running) < args.jobs:
            name = queue.pop(0)
            running[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", name],
                stdout=subprocess.PIPE, text=True), time.perf_counter())
        time.sleep(2.0)
        for name, (p, t0) in list(running.items()):
            if p.poll() is None:
                continue
            del running[name]
            out = p.stdout.read().strip().splitlines()
            if p.returncode != 0 or not out:
                failed.append(name)
                print(f"{name}: exit code {p.returncode}", flush=True)
                continue
            rec = json.loads(out[-1])
            merge(name, rec)
            print(f"{name}: {time.perf_counter() - t0:.0f} s, ATE {rec['ate_m']:.4f} m, "
                  f"keyframes {rec['keyframes']}, IMU after frame {rec['imu_init_frame']}, "
                  f"loops {rec['loops']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
