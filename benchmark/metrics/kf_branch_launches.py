"""kf_branch_launches (launches/kf): launches a keyframe inserted in the
window whose host call lies innermost in the keyframe branch's spans
(`step.kf_insert` through `step.mp_cull`, as kf_branch_ms), each matched
to its device work by correlation id (slambench/launches.py). Moves
tracked_fps. Nothing to read in a window without a keyframe
or without correlation ids."""

STAGES = ("step.kf_insert", "step.vi_ba", "step.local_ba", "step.triangulate", "step.fuse",
          "step.point_stats", "step.kf_cull", "step.mp_cull")


def read(run):
    work = run.stage_work(*STAGES)
    if work is None or not run.keyframes:
        return None
    return work[0] / run.keyframes
