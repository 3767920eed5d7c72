"""frontend_ms (ms/frame): host wall of the step's front-end stage
(`step.frontend`: pyramid, FAST/NMS, ORB, stereo) a window frame. Moves
tracked_fps."""


def read(run):
    if "timing" not in run.counters or not run.frames:
        return None
    return 1e3 * run.stage_s("step.frontend") / run.frames
