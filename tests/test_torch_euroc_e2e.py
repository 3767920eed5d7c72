"""EuRoC ingest end to end in the port, on the CPU: fixture (i) of
scripts/make_euroc_reference.py (6 s at 10 Hz, 376x240, the published MH
calibration at half scale, tests/test_euroc_e2e.py's fixture), written by
the port's writer, through scripts/run_euroc_torch.py::run(profile="small",
device="cpu"): EurocDataset -> the native loader's prefetchers ->
rectification -> FusedSlam -> ATE and a TUM export.

Held to the recorded JAX run of the same fixture and profile
(orbslam3_tpu_torch/data/euroc_reference.json, "small") with chip_smoke.py's
band rule: ATE of the corrected and of the raw trajectory within
max(0.02 m, 0.5 * ATE_jax) of the reference's, ok_frac at least the
reference's - 0.05, the IMU initialized after the reference's frame; and
to the JAX test's bars: 60 frames, at least 8 keyframes, the IMU
initialized, a 60x8 TUM file. The full-width fixture (ii) and the loop
fixture (iii) are held on the card (chip_smoke.py)."""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from orbslam3_tpu_torch.eval.metrics import ate_rmse  # noqa: E402
from orbslam3_tpu_torch.io.euroc import EurocDataset  # noqa: E402
from orbslam3_tpu_torch.io.euroc_fixture import write_fixture  # noqa: E402
from orbslam3_tpu_torch.models.fused import MODE_OK  # noqa: E402
import torch_parity  # noqa: E402,F401  (one intra-op thread)

REF = os.path.join(ROOT, "orbslam3_tpu_torch", "data", "euroc_reference.json")


def band(ate_jax: float) -> float:
    return max(0.02, 0.5 * ate_jax)


@pytest.fixture(scope="module")
def run_i(tmp_path_factory):
    from run_euroc_torch import run

    with open(REF) as f:
        ref = json.load(f)["small"]
    out = tmp_path_factory.mktemp("euroc_i")
    seq = os.path.dirname(write_fixture(str(out / "seq"), **ref["fixture"]))
    box = {}
    result = run(seq, str(out / "out"), profile=ref["profile"], device="cpu",
                 hook=lambda i, s: box.update(slam=s))
    slam = box["slam"]
    _, ps, _ = slam.trajectory_arrays(corrected=True)
    _, ps_raw, _ = slam.trajectory_arrays(corrected=False)
    gt = EurocDataset(seq).groundtruth_at_frames()
    n = len(ps)
    rec = dict(ate=float(ate_rmse(ps - ps[0], gt[:n])),
               ate_raw=float(ate_rmse(ps_raw - ps_raw[0], gt[:n])),
               ok_frac=float((slam.modes() == MODE_OK).mean()), imu_init_frame=slam.imu_init_frame)
    return dict(result=result, rec=rec, ref=ref, slam=slam)


def test_fixture_i_bars(run_i):
    r = run_i["result"]
    assert r["frames"] == 60 and r["keyframes"] >= 8 and r["imu_initialized"], r
    assert r["device"] == "cpu" and r["native_loader"] is True, r
    tum = np.loadtxt(os.path.join(r["outdir"], "trajectory.tum"))
    assert tum.shape == (60, 8)
    assert r["ate_m"] == round(run_i["rec"]["ate"], 4)


def test_fixture_i_against_jax(run_i):
    rec, ref = run_i["rec"], run_i["ref"]
    print(f"fixture (i): ATE {rec['ate']:.5f} m (JAX {ref['ate_corrected_m']:.5f}), raw "
          f"{rec['ate_raw']:.5f} (JAX {ref['ate_raw_m']:.5f}), ok_frac {rec['ok_frac']:.4f} "
          f"(JAX {ref['ok_frac']:.4f}), IMU at frame {rec['imu_init_frame']} (JAX "
          f"{ref['imu_init_frame']}), keyframes {run_i['result']['keyframes']} (JAX "
          f"{ref['keyframes']})")
    assert rec["imu_init_frame"] == ref["imu_init_frame"]
    assert rec["ok_frac"] >= ref["ok_frac"] - 0.05
    for mine, theirs in ((rec["ate"], ref["ate_corrected_m"]), (rec["ate_raw"], ref["ate_raw_m"])):
        assert abs(mine - theirs) <= band(theirs), (mine, theirs)
    # the JAX test's bar on its own fixture
    assert rec["ate"] < 0.10
