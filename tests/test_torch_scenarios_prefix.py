"""The first 24 frames of three scenarios of scripts/scenarios_torch.py on
the port's FusedSlam on the CPU (device="cpu"), against their JAX record
(data/scenario_reference.json, scripts/make_scenario_reference.py):

- blackout_bridge (tests/test_recovery.py:20; stereo-inertial, the IMU
  initialized after frame 15) and imu_refine (tests/test_imu_refine.py:18;
  biased IMU, initialized after frame 11), on the port's own front end;
- long_run_compacts (tests/test_compaction.py:131; 16 keyframe rows, the
  first compaction after frame 23), fed the JAX front end's features (its own
  departs at frame 18 by a BRIEF bit, ROADMAP queue 3's expected
  differences). This world turns a last bit into centimetres: the JAX run
  with the camera's cx or cy one float32 ulp away is 5.2 mm off the record
  at frame 15 (scripts/scenario_witness.py), so poses are held over frames
  0-14 and the integers over all 24.

Tolerances: the left images' checksums, tracker modes, keyframe flags,
inlier counts and the frames of each host service (IMU initialization,
refines, compactions) equal; positions within 5 mm and orientations within
5 mrad (PERF.md section 6's slice tolerance). About 1.5 minutes on one
worker."""
import pytest

from scenario_parity import assert_follows_record, port_run, reference

N = 24


@pytest.mark.parametrize("name,front_end,n_pose", [("blackout_bridge", False, N),
                                                   ("imu_refine", False, N),
                                                   ("long_run_compacts", True, 15)])
def test_first_frames_follow_the_record(name, front_end, n_pose):
    ref = reference(name)
    slam, rec = port_run(name, N, front_end=front_end)
    assert_follows_record(rec, ref, N, n_pose=n_pose)
