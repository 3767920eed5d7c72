"""kf_branch_busy_ms (ms/keyframe): device time a window keyframe of the
launches that kf_branch_launches counts, the union of their activities'
intervals wherever they ran. Moves tracked_fps. Nothing to read
where kf_branch_launches has nothing."""

STAGES = ("step.kf_insert", "step.vi_ba", "step.local_ba", "step.triangulate", "step.fuse",
          "step.point_stats", "step.kf_cull", "step.mp_cull")


def read(run):
    work = run.stage_work(*STAGES)
    if work is None or not run.keyframes:
        return None
    return 1e3 * work[1] / run.keyframes
