"""kf_branch_ms (ms/keyframe): host wall of the keyframe branch a keyframe
inserted in the window: insert, local or visual-inertial BA,
triangulation, fusion, point statistics, keyframe and map-point culling
(`step.kf_insert` through `step.mp_cull`). Moves tracked_fps: the
keyframe frames are the window's longest. Nothing to read in a window
without a keyframe."""

STAGES = ("step.kf_insert", "step.vi_ba", "step.local_ba", "step.triangulate", "step.fuse",
          "step.point_stats", "step.kf_cull", "step.mp_cull")


def read(run):
    if "timing" not in run.counters or not run.keyframes:
        return None
    return 1e3 * run.stage_s(*STAGES) / run.keyframes
