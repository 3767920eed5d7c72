"""host_sync_wait_ms (ms/frame): the host blocked on the device a window
frame, from the program's `sync_wait` timer (FusedSlam: each `_sync` read,
the keyframe-table copies of IMU initialization and refinement, a service
round's wait for its snapshot). Moves tracked_fps. Nothing to read where the
program keeps no such timer."""


def read(run):
    if "sync_wait" not in run.counters.get("timing", {}) or not run.frames:
        return None
    return 1e3 * run.stage_s("sync_wait") / run.frames
