"""host_services_ms (ms/frame): FusedSlam's host services (the service
rounds: IMU initialization and refinement, compaction) a window frame, from
the program's `host_services` timer. Moves tracked_fps."""


def read(run):
    if "timing" not in run.counters or not run.frames:
        return None
    return 1e3 * run.stage_s("host_services") / run.frames
