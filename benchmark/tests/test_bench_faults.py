"""The check catches a broken timed path: each run drives the harness past
its look for a card (on the CPU, at a CPU size) with one fault of
slambench/faults.py planted in the program underneath, as `run.py --fault`
plants it, and `correct` comes out false; the same run unbroken comes out
true. (No cell spans chips, so the fault of an exchange between chips left
out has no run to break.)"""
import pytest
import torch

import orbslam3_tpu_torch.models.fused as fused
from conftest import tiny
from slambench import faults
from slambench.harness import run_cell

SEED = 2**31 + 4242


def _run(render_cache, fault=None, seconds=4.0):
    torch.set_num_threads(2)
    return run_cell("tiny", SEED, seconds, False, resolved=tiny("tiny_vi", "cold"),
                    device="cpu", cache_dir=render_cache, workers=1, fault=fault)


def test_sound_single_session_run_is_correct(render_cache):
    out = _run(render_cache)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "gravity_err_deg"),
    ("half_features", "fe_mismatch"),
    ("answer_altered", "pose_err_max_m"),
    ("ba_wrong_baseline", "map_wall_med_m"),
])
def test_single_session_fault_fails(fault, number, render_cache):
    out = _run(render_cache, fault)
    assert not out["correct"], (fault, out["checks"])
    c = out["checks"][number]
    assert c["value"] > c["limit"], (fault, out["checks"])


def test_faults_are_taken_out_again():
    """Every fault replaces what it names (a module's function or a class's
    method) and puts back the original when taken out."""
    def targets(name):
        return [faults.target(m, p) for m, p, _ in faults.FAULTS[name][1]]

    every = {t for name in faults.FAULTS for t in targets(name)}
    real = {t: getattr(*t) for t in every}
    assert (fused, "_slam_step_core") in every
    for name in faults.FAULTS:
        disarm = faults.arm(name)
        assert all(getattr(*t) is not real[t] for t in targets(name)), name
        disarm()
    assert all(getattr(*t) is real[t] for t in every)
