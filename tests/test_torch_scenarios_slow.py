"""The whole scenarios of scripts/scenarios_torch.py on the port's FusedSlam
on the CPU (device="cpu", its own front end and RANSAC draws), marked `slow`
as the JAX tests they mirror are: each run meets its JAX test's own bars
(ok fractions, ATE limits, counts, the gravity angle, keyframe rows) and the
structural facts of its JAX record (data/scenario_reference.json:
scenarios_torch.holds; the atlas size and bad-IMU resets equal, the IMU's
frame and the first reset within one service round, refines, keyframes in a
blackout, compactions and evictions wherever the record has them, ok_frac >=
the record's - 0.05, ATE within max(0.02 m, 0.5 ATE_jax)); and the
synthesized ORBvoc-scale vocabulary (k=10, L=6, 1.11 M nodes) loads,
quantizes 1024 descriptors to the record's leaf ids exactly, and scores
itself 1.0 within 1e-4. The full-width runs take about 5 minutes each on
the CPU, the vocabulary about 1."""
import pytest

from scenario_parity import reference, sc


@pytest.mark.slow
@pytest.mark.parametrize("name", sc.RUNS)
def test_whole_scenario_meets_its_bars(name):
    slam, rec, world = sc.run_port(name, device="cpu", workers=2)
    failed = [c for c, ok in sc.holds(name, rec, reference(name), world.cfg) if not ok]
    assert not failed, (failed, sc.first_departure(rec, reference(name)))


@pytest.mark.slow
def test_orbvoc_scale_quantizes_to_the_record(tmp_path):
    path = str(tmp_path / "orbvoc_synth.txt")
    rec = sc.orbvoc_port(path, sc.orbvoc_text(path), "cpu")
    failed = [c for c, ok in sc.orbvoc_holds(rec, reference(sc.ORBVOC)) if not ok]
    assert not failed, failed
