"""Record the JAX references of the torch port's EuRoC-ingest runs.

Writes EuRoC-format fixtures with the JAX package's writer
(scripts/make_euroc_fixture.py::write_fixture) into a temporary directory
and runs the JAX package's own runner on each (scripts/run_euroc.py::run:
EurocDataset -> undistortion and stereo rectification -> FusedSlam at
chunk 1 -> ATE), with its FusedSlam wrapped so that each frame's result is
recorded:

  small   write_fixture(duration=6.0, hz=10.0, scale=0.5, seed=7),
          run(profile="small"): tests/test_euroc_e2e.py's fixture, 60 frames
          at 376x240;
  full    write_fixture(duration=8.0, hz=20.0, scale=1.0, seed=7),
          run(profile="full"): 160 frames at 752x480 with the published
          MH calibration unscaled, SlamConfig(kf_max_frames=6) as real
          sequences run;
  loop    write_fixture(duration=24.0, hz=10.0, scale=0.5, seed=7,
          revisit=True), run(profile="small") with the vocabulary
          tests/test_euroc_e2e.py::_train_fixture_vocab trains from the
          fixture (DBoW2 text) and LoopConfig(bow_min_score_gate=False):
          240 frames, a 3 s blackout with an IMU bias step, a second lap.

For each run: frames, keyframes, the frame after which the IMU initialized,
the share of frames tracked OK, the ATE of the corrected and of the raw
trajectory (both after run_euroc's alignment: positions relative to the
first, against centered ground truth), the per-frame corrected positions,
and for the loop run the loop statistics and one record per correction
(keyframe pair, their times, kind, seam). Writes
orbslam3_tpu_torch/data/euroc_reference.json and the loop run's vocabulary
as orbslam3_tpu_torch/data/euroc_loop_vocab.txt (DBoW2 text), which the
port loads on the card (chip_smoke.py).

    JAX_PLATFORMS=cpu python scripts/make_euroc_reference.py [small|full|loop ...]

With names, only those runs are made and merged into the existing file.
CPU minutes: small ~3, full ~10, loop ~15; accuracy only, the wall times
written are not speed figures.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

DATA = os.path.join(ROOT, "orbslam3_tpu_torch", "data")
OUT = os.path.join(DATA, "euroc_reference.json")
VOCAB = os.path.join(DATA, "euroc_loop_vocab.txt")

RUNS = {
    "small": dict(fixture=dict(duration=6.0, hz=10.0, scale=0.5, seed=7), profile="small"),
    "full": dict(fixture=dict(duration=8.0, hz=20.0, scale=1.0, seed=7), profile="full"),
    "loop": dict(fixture=dict(duration=24.0, hz=10.0, scale=0.5, seed=7, revisit=True),
                 profile="small", loop=True),
}


def recorded_run(seq: str, outdir: str, profile: str, vocab_path=None, loop_cfg=None):
    """scripts/run_euroc.py::run with its FusedSlam recorded."""
    import orbslam3_tpu.models.fused as jfused
    from make_loop_reference import instrument
    from run_euroc import run

    box = {}
    base = jfused.FusedSlam

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            box.update(slam=self, init_frame=None, events=[])
            if self.loop_closer is not None:
                _, box["events"], box["restore"] = instrument(self)

        def process_frame(self, *a, **kw):
            out = super().process_frame(*a, **kw)
            if box["init_frame"] is None and self.imu_initialized:
                box["init_frame"] = self._frames - 1
            return out

    jfused.FusedSlam = Recorded
    t0 = time.perf_counter()
    try:
        result = run(seq, outdir, profile=profile, vocab_path=vocab_path, loop_cfg=loop_cfg)
    finally:
        jfused.FusedSlam = base
        box.get("restore", lambda: None)()
    return result, box, time.perf_counter() - t0


def make(name: str, tmp: str) -> dict:
    from make_euroc_fixture import write_fixture

    from orbslam3_tpu.eval.metrics import ate_rmse
    from orbslam3_tpu.io.euroc import EurocDataset
    from orbslam3_tpu.models.fused import MODE_OK

    spec = RUNS[name]
    root = write_fixture(os.path.join(tmp, name), **spec["fixture"])
    seq = os.path.dirname(root)
    vocab_path, loop_cfg = None, None
    if spec.get("loop"):
        from test_euroc_e2e import _train_fixture_vocab

        from orbslam3_tpu.loop.closer import LoopConfig

        vocab_path = _train_fixture_vocab(seq, VOCAB)
        loop_cfg = LoopConfig(bow_min_score_gate=False)
    result, box, wall = recorded_run(seq, os.path.join(tmp, name + "_out"), spec["profile"],
                                     vocab_path, loop_cfg)
    slam = box["slam"]
    _, ps, _ = slam.trajectory_arrays(corrected=True)
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    gt = EurocDataset(seq).groundtruth_at_frames()
    n = len(ps)
    rec = {"fixture": spec["fixture"], "profile": spec["profile"], **result,
           "ok_frac": float((slam.modes() == MODE_OK).mean()),
           "ate_raw_m": float(ate_rmse(ps_raw - ps_raw[0], gt[:n])),
           "ate_corrected_m": float(ate_rmse(ps - ps[0], gt[:n])),
           "imu_init_frame": box["init_frame"], "n_kf_valid": int(np.asarray(
               slam.map.kf_valid).sum()), "n_mp": int(slam.map.n_mp),
           "cpu_wall_s": round(wall, 1),
           "p": np.round(ps.astype(np.float64), 6).tolist()}
    rec.pop("outdir")
    if slam.loop_closer is not None:
        rec.update(stats=slam.loop_closer.stats._asdict(), corrections=box["events"],
                   vocabulary=os.path.relpath(VOCAB, ROOT),
                   vocabulary_bytes=os.path.getsize(VOCAB))
    return rec


def main():
    import jax

    names = sys.argv[1:] or list(RUNS)
    rec = {}
    if os.path.exists(OUT) and sys.argv[1:]:
        with open(OUT) as f:
            rec = json.load(f)
    rec.update(backend=jax.default_backend(),
               note="accuracy reference only; the CPU wall time is not a speed figure")
    tmp = tempfile.mkdtemp(prefix="euroc_reference_")
    try:
        for name in names:
            t0 = time.perf_counter()
            rec[name] = make(name, tmp)
            print(f"{name}: {time.perf_counter() - t0:.0f} s "
                  + json.dumps({k: v for k, v in rec[name].items() if k != "p"}),
                  file=sys.stderr, flush=True)
            os.makedirs(DATA, exist_ok=True)
            with open(OUT, "w") as f:
                json.dump(rec, f, indent=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
