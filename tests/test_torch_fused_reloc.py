"""Torch port of relocalization into the same map, against the JAX
package's recorded run.

The relocalization world of tests/test_fused_loop.py (384x256, 8 s at
10 Hz, fast motion, a 2 s camera blackout, lost_timeout=30 s so the atlas
never spawns a map, lost keyframes inserted): the port on the same frames
and vocabulary (data/vocab_reloc.npz, checked to be the test's), fed the
RANSAC draws JAX makes, against the JAX run recorded
by scripts/make_loop_reference.py (orbslam3_tpu_torch/data/
loop_reference.json, "reloc"): the test's bars (no new map, a
relocalization, OK share after the blackout > 0.9, post-blackout ATE <
0.15 m) for both; LoopStats (the candidates past the match-count floor
within 2: the front ends differ by single descriptor bits) and the number
of corrections equal; the relocalization on the same keyframe pair, its
seam within 0.1 m, and the service sequence equal up to the round after
it (see test_reloc_world_matches_jax for what is not held after it); the
rule chip_smoke.py holds the card's relocalization-mode rounds to, on both
runs.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from orbslam3_tpu.io.synthetic import SyntheticConfig, SyntheticWorld
from orbslam3_tpu_torch.eval.metrics import ate_rmse
from orbslam3_tpu_torch.loop.vocab import load_npz
from orbslam3_tpu_torch.models import fused as tfused
from test_torch_fused_loop import LOOP_OVER, blackout_run, small_cfgs, world_vocab
from test_torch_loop_closer import jax_draws
from torch_parity import port_camera, record_loop_services

RELOC_WORLD = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=8.0,
                   cam_hz=10.0, pos_amp=(1.0, 0.7, 0.25), pos_freq=(0.22, 0.3, 0.35),
                   yaw_amp=0.8, yaw_freq=0.22)
BLACKOUT = (2.5, 4.5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "orbslam3_tpu_torch", "data")
REF = os.path.join(DATA, "loop_reference.json")


@pytest.fixture(scope="module")
def reloc():
    with open(REF) as f:
        ref = json.load(f)["reloc"]
    world = SyntheticWorld(SyntheticConfig(**RELOC_WORLD))
    _, tcfg = small_cfgs(lost_timeout=30.0, insert_kfs_lost_visual=True)
    # the vocabulary file chip_smoke.py runs this world with
    voc = load_npz(os.path.join(DATA, "vocab_reloc.npz"))
    slam = tfused.FusedSlam(port_camera(world.cam), tcfg, device="cpu", service_every=2,
                            vocabulary=voc)
    slam.loop_closer.cfg = slam.loop_closer.cfg._replace(
        **{k: v for k, v in LOOP_OVER.items() if k != "consistency_needed"})
    slam.loop_closer.sampler = jax_draws
    log = record_loop_services(slam, [])
    run = blackout_run(slam, world, BLACKOUT)
    gt_p, _ = world.gt_trajectory()
    return dict(run, log=log, slam=slam, ref=ref, gt=gt_p, world=world)


def test_reloc_vocabulary_file_is_the_tests(reloc):
    """data/vocab_reloc.npz (scripts/make_loop_reference.py) is the
    vocabulary tests/test_fused_loop.py trains for this world."""
    want = jax.tree.map(np.asarray, world_vocab(reloc["world"]))
    got = reloc["slam"].loop_closer.vocab
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        assert not isinstance(b, tuple) or len(a) == len(b), name
        for x, y in pairs:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_reloc_rounds_rule(reloc):
    """chip_smoke.py's reloc_rounds, the JAX host's rule for the service
    rounds in relocalization mode, gives from a run's per-frame tracker
    modes the flags that run passed to its loop closer: the port's run and
    the recorded JAX run."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def flags(services):
        return {e[1]: e[4] for e in services if e[0] == "kf"}

    for modes, services in ((reloc["slam"].modes(), [list(e) for e in reloc["log"]]),
                            (np.asarray(reloc["ref"]["modes"]), reloc["ref"]["services"])):
        got = flags(services)
        rule = chip_smoke.reloc_rounds(modes, 2, max(got))
        assert {r for r, on in got.items() if on} == rule & set(got) and rule


def test_reloc_world_bars(reloc):
    slam, times = reloc["slam"], reloc["times"]
    post = times > BLACKOUT[1] + 2.0
    assert int(slam.map.next_map_id) == 1 and reloc["maps"] == {0}
    assert slam.loop_closer.stats.relocalized >= 1, slam.loop_closer.stats
    assert (reloc["modes"][post] == tfused.MODE_OK).mean() > 0.9
    assert reloc["ate_post"] < 0.15, reloc["ate_post"]
    # the recorded JAX run meets the same bars
    ref = reloc["ref"]
    ref_p = np.asarray(ref["p"], np.float32)
    assert ref["next_map_id"] == 1 and ref["stats"]["relocalized"] >= 1
    assert (np.asarray(ref["modes"])[post] == 1).mean() > 0.9
    assert ate_rmse(ref_p[post], reloc["gt"][post]) < 0.15


def test_reloc_world_matches_jax(reloc):
    """The relocalization itself is the reference's: the same keyframe
    against the same candidate in the same service round, and as many
    corrections and relocalizations in all. The seams it measures differ by
    5 cm (3.367 against 3.321 m: it corrects a segment dead-reckoned through
    2 s of blackout), it runs global BA over that map, and the run's later
    loop correction lands on a neighbouring keyframe pair (port: keyframe 31
    against 25; JAX: 33 against 24), so the trajectories after it are not
    held to each other, only to the bars."""
    ref, slam = reloc["ref"], reloc["slam"]
    st = slam.loop_closer.stats
    rst = ref["stats"]
    assert abs(st.candidates_checked - rst["candidates_checked"]) <= 2
    assert (st.consistent, st.verified, st.corrected, st.relocalized) == (
        rst["consistent"], rst["verified"], rst["corrected"], rst["relocalized"])
    got, want = slam.loop_closer.corrections, ref["corrections"]
    assert len(got) == len(want)
    assert (got[0]["kf_id"], got[0]["cand"], got[0]["reloc"]) == (
        want[0]["kf_id"], want[0]["cand"], want[0]["reloc"]) == (24, 10, True)
    assert abs(got[0]["seam_m"] - want[0]["seam_m"]) < 0.1


def test_reloc_service_sequence_equals_jax(reloc):
    """The service sequence equals the reference's up to and including the
    relocalization and the round after it."""
    log, ref = [list(e) for e in reloc["log"]], reloc["ref"]["services"]
    i = ref.index(["correct", 24, 10, False])
    r = next(e[1] for e in reversed(ref[:i]) if e[0] == "kf")
    end = next(k for k in range(i, len(ref)) if ref[k][0] == "kf" and ref[k][1] >= r + 2)
    assert log[:end] == ref[:end] and end > 50
