"""tracked_fps.traced.steady (frames/s): frames whose pose reached the host
in the traced window over the window's length, as the end-to-end
tracked_fps is taken in the cells that bound it; with the profiler on, so
it reads below an untraced run. Moves setup_s, which tracks frames 0-104
through the same step (PERF.md section 2). Nothing to read in a window with
no frame."""
from slambench import stats


def read(run):
    if not run.frames:
        return None
    return stats.rate(run.frames, run.window_s)
