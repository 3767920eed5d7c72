"""fast_nms_roofline (%): the FAST/NMS kernel's share of its roofline over
the window, from the device trace. The least time is the bytes the
function needs for every frame the window tracked (each level pixel of
both images read once as float32, each score written once: 17.9 MB a
752x480 stereo pair with 8 levels, slambench/roofline.py) at the card's
HBM bandwidth; the time is the trace's total of the kernels named
`fast_nms` in the window. Moves tracked_fps."""

from slambench.roofline import fast_nms_bytes

KERNEL = "fast_nms"


def read(run):
    if run.trace is None or not run.frames:
        return None
    peaks = run.peaks()
    launches, seconds = run.trace.kernel_seconds(KERNEL)
    if peaks is None or not launches or seconds <= 0:
        return None
    cam, orb = run.config["camera"], run.config["slam"]["orb"]
    work = fast_nms_bytes(cam["height"], cam["width"], orb["n_levels"], orb["scale_factor"],
                          images=2 * run.frames)
    return 100.0 * (work / peaks["hbm_bytes_per_s"]) / seconds
