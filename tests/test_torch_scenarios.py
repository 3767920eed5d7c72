"""The port's FusedSlam on the CPU (device="cpu") against the JAX record of
two scenarios of scripts/scenarios_torch.py (data/scenario_reference.json,
scripts/make_scenario_reference.py):

- kf_capacity_guard (tests/test_fused.py::test_keyframe_capacity_guard: 20
  frames, a 4-row keyframe array, a keyframe forced every frame), whole, on
  the port's own front end;
- poisoned_ransac (tests/test_recovery.py::
  test_poisoned_motion_model_recovers_via_ransac), from the first frame to
  6 frames after the poison at t = 3.0 s (frames 0-36), fed the JAX front
  end's features and the JAX run's RANSAC-seed draws
  (data/scenario_draws.npz): the port's own front end flips one BRIEF bit at
  frame 28 (pyramid levels >= 1, ROADMAP queue 3's expected differences),
  and torch cannot draw JAX's samples.

Tolerances: the left images' checksums, tracker modes, keyframe flags,
inlier counts, host counters and the frames of each host service equal;
positions within 5 mm and orientations within 5 mrad (PERF.md section 6's
slice tolerance). About 1.5 minutes on one worker."""
from scenario_parity import assert_follows_record, port_run, reference, sc


def test_kf_capacity_guard_whole():
    name = "kf_capacity_guard"
    slam, rec = port_run(name)
    ref = reference(name)
    n = ref["frames"]
    assert_follows_record(rec, ref, n)
    for k in ("n_kf", "n_kf_valid", "n_mp", "next_map_id", "compactions", "kf_evictions",
              "mp_evictions", "map_evictions"):
        assert rec[k] == ref[k], (k, rec[k], ref[k])
    assert all(ok for _, ok in sc.test_bars(name, rec, None))


def test_poisoned_ransac_to_six_frames_after_the_poison():
    name = "poisoned_ransac"
    ref = reference(name)
    poison = next(i for i, t in enumerate(ref["per_frame"]["t"])
                  if t >= sc.SCENARIOS[name]["poison_t"])
    n = poison + 7
    # the record's fallback seeds fall inside the frames held
    assert ref["draws"]["frames"] and max(ref["draws"]["frames"]) < n
    slam, rec = port_run(name, n, front_end=True, draws=True)
    assert_follows_record(rec, ref, n)
    modes = rec["per_frame"]["mode"]
    assert modes[poison] != 1 and modes[-1] == 1  # lost by the poison, recovered after
