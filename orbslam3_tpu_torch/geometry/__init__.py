"""SO(3) and unit-quaternion math as broadcasting torch ops."""
from orbslam3_tpu_torch.geometry import quat, so3  # noqa: F401
