"""pose_solve_busy_ms (ms/frame): device time a window frame of the launches
that pose_solve_launches counts: the union of their kernels', copies' and
sets' intervals, wherever they ran, also after their span closed (the
solve's device work, where pose_solve_ms is its host wall). Moves
tracked_fps. Nothing to read where pose_solve_launches has nothing."""

STAGES = ("step.pose_solve_vi", "step.pose_solve_visual", "step.ransac_seed")


def read(run):
    work = run.stage_work(*STAGES)
    if work is None or not run.frames:
        return None
    return 1e3 * work[1] / run.frames
