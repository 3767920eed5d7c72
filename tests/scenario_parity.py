"""Shared helpers of the scenario parity tests (test_torch_scenarios*.py):
the port's FusedSlam on the CPU over a scenario of scripts/scenarios_torch.py,
fed where a test says so the JAX front end's features and the JAX run's
RANSAC-seed draws (scripts/scenario_witness.py's swaps), and the comparison
with the JAX record."""
import contextlib
import os
import sys

import numpy as np

import torch_parity  # noqa: F401  (one intra-op thread a test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import scenario_witness as sw  # noqa: E402
import scenarios_torch as sc  # noqa: E402

POS_TOL = 5e-3  # m: the slice tolerance of PERF.md section 6
ROT_TOL = 5e-3  # rad


def reference(name: str) -> dict:
    return sc.load_reference()["scenarios"][name]


def port_run(name: str, n: int | None = None, front_end: bool = False, draws: bool = False):
    """The scenario's first `n` frames on the port's FusedSlam(device="cpu"),
    fed the JAX front end and/or the recorded draws. Returns (slam, record)."""
    with contextlib.ExitStack() as stack:
        if front_end:
            stack.enter_context(sw.fed_front_end(name))
        if draws:
            stack.enter_context(sw.fed_draws(name))
        slam, rec, _ = sc.run_port(name, device="cpu", n=n, workers=1)
    return slam, rec


def assert_follows_record(rec: dict, ref: dict, n: int, n_pose: int | None = None):
    """The port's first n frames against the record's: the left images'
    checksums, tracker modes, keyframe flags and inlier counts equal; over
    the first n_pose frames (n by default) positions within POS_TOL and
    orientations within ROT_TOL; the frames of the IMU's initialization,
    bad-IMU resets, refines and compaction passes among the first n equal."""
    n_pose = n if n_pose is None else n_pose
    pf, rf = rec["per_frame"], ref["per_frame"]
    assert len(pf["mode"]) == n, (len(pf["mode"]), n)
    for k in ("checksum", "mode", "is_kf", "n_inliers"):
        assert pf[k] == rf[k][:n], (k, sc.first_departure(rec, ref))
    dp = np.linalg.norm(np.asarray(pf["p"][:n_pose]) - np.asarray(rf["p"][:n_pose]), axis=1)
    assert dp.max() <= POS_TOL, (int(dp.argmax()), float(dp.max()))
    qa, qb = np.asarray(pf["q"][:n_pose]), np.asarray(rf["q"][:n_pose])
    qb = qb * np.sign(np.sum(qa * qb, axis=1, keepdims=True) + 1e-30)
    # the rotation angle between unit quaternions: |qa - qb| = 2 sin(angle / 4)
    angle = 4.0 * np.arcsin(np.clip(np.linalg.norm(qa - qb, axis=1) / 2.0, 0.0, 1.0))
    assert angle.max() <= ROT_TOL, (int(angle.argmax()), float(angle.max()))
    init = ref["imu_init_frame"]
    assert rec["imu_init_frame"] == (init if init is not None and init < n else None)
    for k in ("reset_frames", "refine_frames", "compaction_frames"):
        assert rec[k] == [i for i in ref[k] if i < n], (k, rec[k], ref[k])
