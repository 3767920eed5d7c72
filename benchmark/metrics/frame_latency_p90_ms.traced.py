"""frame_latency_p90_ms.traced (ms): the 90th percentile over every frame
of the traced window, each timed from its process_frame call until its pose
is on the host, as the end-to-end frame_latency_p90_ms was; with the
profiler on, so it reads above an untraced run. Moves tracked_fps: the
keyframe frames make the tail. Nothing to read in a window with no frame."""
from slambench import stats


def read(run):
    if not run.latencies:
        return None
    return 1e3 * stats.percentile(run.latencies, 90)
