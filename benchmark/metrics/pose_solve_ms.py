"""pose_solve_ms (ms/frame): host wall of the tracking solve a window frame:
the visual-inertial and the visual pose solve and the RANSAC seed
(`step.pose_solve_vi`, `step.pose_solve_visual`, `step.ransac_seed`).
Moves tracked_fps."""


def read(run):
    if "timing" not in run.counters or not run.frames:
        return None
    return 1e3 * run.stage_s("step.pose_solve_vi", "step.pose_solve_visual",
                             "step.ransac_seed") / run.frames
