"""pose_solve_launches (launches/frame): launches a window frame whose host
call lies innermost in the tracking solve's spans (`step.pose_solve_vi`,
`step.pose_solve_visual`, `step.ransac_seed`), each matched to its device
work by correlation id (slambench/launches.py; a graph launch is one).
Moves tracked_fps. Nothing to read without a traced window with
correlation ids."""

STAGES = ("step.pose_solve_vi", "step.pose_solve_visual", "step.ransac_seed")


def read(run):
    work = run.stage_work(*STAGES)
    if work is None or not run.frames:
        return None
    return work[0] / run.frames
