"""Multi-device paths: whole-map bundle adjustment on one device or over a
torch.distributed process group (points split over the ranks, the camera
system summed with one all_reduce a step), and D independent SLAM sessions
laid over a list of devices (multi_session.py)."""
from orbslam3_tpu_torch.parallel.distributed_ba import (  # noqa: F401
    GlobalBAPoints,
    distributed_global_ba,
    global_ba,
    make_point_table,
)
