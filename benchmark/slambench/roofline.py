"""Peaks of the card and the work of each kernel, counted from input shapes.

The work is counted from what the function needs, not from how a kernel
computes it, so a later kernel that replaces one is read against the same
count.
"""
from __future__ import annotations

# by `torch.cuda.get_device_name()`; NVIDIA's data sheet, at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """The ORB pyramid's (h, w) a level: round(h / scale**lv)."""
    return [(int(round(h / scale**lv)), int(round(w / scale**lv))) for lv in range(n_levels)]


def fast_nms_bytes(h: int, w: int, n_levels: int, scale: float, images: int) -> int:
    """Bytes the two-threshold FAST-16-9 score + 3x3 NMS of every pyramid
    level needs: each float32 level pixel read once and its float32 score
    written once."""
    pixels = sum(a * b for a, b in level_shapes(h, w, n_levels, scale))
    return images * pixels * (4 + 4)
