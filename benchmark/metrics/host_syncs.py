"""host_syncs (syncs/frame): the program's explicit device-to-host reads a
window frame (FusedSlam.host_syncs). Moves tracked_fps."""


def read(run):
    if "timing" not in run.counters or not run.frames:
        return None
    return run.counters["host_syncs"] / run.frames
