"""EuRoC MAV dataset loader.

Host copy of orbslam3_tpu/io/euroc.py: CSV image lists, the 200 Hz IMU
stream, 17-column ground truth (pose + velocity + biases), sensor.yaml
intrinsics and extrinsics, the baseline from ||T_c1_c0 translation||,
timestamp-windowed IMU access and centered ground-truth positions.

Images decode on the host through the native library (io/native.py), which
is pixel-equal to PIL on grayscale PNGs; PIL is imported only where that
library cannot be built (no g++). Undistortion and stereo rectification run
on the device (io/rectify.py).
"""
from __future__ import annotations

import csv
import os
from typing import NamedTuple, Optional

import numpy as np

from orbslam3_tpu_torch.imu.preintegration import ImuNoise
from orbslam3_tpu_torch.io import native


class CamCalib(NamedTuple):
    K: np.ndarray  # (3, 3)
    dist: np.ndarray  # (4,) radtan k1 k2 p1 p2
    T_BS: np.ndarray  # (4, 4) body-from-camera
    resolution: tuple  # (w, h)
    rate_hz: float


def _parse_sensor_yaml(path: str) -> dict:
    """Minimal YAML subset parser for EuRoC sensor.yaml (no external deps).

    Handles scalar keys, one level of nesting, and OpenCV-style matrix
    entries (rows/cols/data lists).
    """
    import re

    out: dict = {}
    stack = [out]
    indents = [0]
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        raw = lines[i]
        line = raw.split("#")[0].rstrip()
        i += 1
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        while indent < indents[-1]:
            stack.pop()
            indents.pop()
        m = re.match(r"\s*([\w\-]+):\s*(.*)", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val == "":
            child: dict = {}
            stack[-1][key] = child
            stack.append(child)
            indents.append(indent + 2)
        elif val.startswith("["):
            # possibly continued over lines
            while "]" not in val:
                val += lines[i].split("#")[0].strip()
                i += 1
            nums = [float(x) for x in re.findall(r"[-+0-9.eE]+", val)]
            stack[-1][key] = nums
        else:
            try:
                stack[-1][key] = float(val)
            except ValueError:
                stack[-1][key] = val
    return out


class ImuCalib(NamedTuple):
    noise: ImuNoise
    T_BS: np.ndarray  # (4, 4) body-from-IMU (identity on EuRoC)
    rate_hz: float


def load_imu_calib(imu_dir: str) -> Optional[ImuCalib]:
    """Read imu0/sensor.yaml noise densities into ImuNoise.

    The published per-dataset densities flow straight into the
    preintegration covariance, so another rig's IMU edges are weighted by
    its own values.
    """
    p = os.path.join(imu_dir, "sensor.yaml")
    if not os.path.exists(p):
        return None
    y = _parse_sensor_yaml(p)
    noise = ImuNoise(
        sigma_g=float(y.get("gyroscope_noise_density", 1.7e-4)),
        sigma_a=float(y.get("accelerometer_noise_density", 2.0e-3)),
        sigma_bg=float(y.get("gyroscope_random_walk", 1.9e-5)),
        sigma_ba=float(y.get("accelerometer_random_walk", 3.0e-3)),
    )
    T = np.array(y["T_BS"]["data"], np.float64).reshape(4, 4) if "T_BS" in y \
        else np.eye(4)
    return ImuCalib(noise, T, float(y.get("rate_hz", 200.0)))


def load_cam_calib(cam_dir: str) -> CamCalib:
    y = _parse_sensor_yaml(os.path.join(cam_dir, "sensor.yaml"))
    fu, fv, cu, cv = y["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1]], np.float64)
    dist = np.array(y.get("distortion_coefficients", [0, 0, 0, 0]), np.float64)
    T = np.array(y["T_BS"]["data"], np.float64).reshape(4, 4)
    res = tuple(int(v) for v in y.get("resolution", [752, 480]))
    return CamCalib(K, dist, T, res, float(y.get("rate_hz", 20.0)))


def _decode_gray(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale of a PNG: the native decoder, PIL where the
    native library cannot be built."""
    if native.available():
        return native.png_decode_gray(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.uint8)


class EurocDataset:
    """Loader for one EuRoC sequence directory (.../<SEQ>/mav0)."""

    def __init__(self, path: str):
        if os.path.basename(os.path.normpath(path)) != "mav0":
            path = os.path.join(path, "mav0")
        self.root = path
        self.cam0 = load_cam_calib(os.path.join(path, "cam0"))
        self.cam1 = load_cam_calib(os.path.join(path, "cam1"))
        self.image_ts, self.image_files = self._read_image_list("cam0")
        ts1, files1 = self._read_image_list("cam1")
        self._cam1_files = dict(zip(ts1, files1))
        self.imu_ts, self.imu_gyro, self.imu_acc = self._read_imu()
        self.imu_calib = load_imu_calib(os.path.join(path, "imu0"))
        # sequence-relative time origin: EuRoC timestamps are ns since the
        # Unix epoch (~1.4e9 s) — fed raw into the pipeline they exceed
        # float32's integer resolution (~128 s at that magnitude), which
        # silently zeroes every keyframe time span (IMU init never fires)
        # and corrupts dt-based velocity estimates. All times this loader
        # hands out are seconds since the first image.
        self.t0_ns = int(self.image_ts[0]) if self.image_ts else 0
        self.gt = self._read_groundtruth()
        # baseline from the cam0->cam1 transform
        T_c1_c0 = np.linalg.inv(self.cam1.T_BS) @ self.cam0.T_BS
        self.baseline = float(np.linalg.norm(T_c1_c0[:3, 3]))

    # ------------------------------------------------------------------
    def _read_image_list(self, cam: str):
        ts, files = [], []
        with open(os.path.join(self.root, cam, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]))
                files.append(row[1].strip())
        return ts, files

    def _read_imu(self):
        ts, gyro, acc = [], [], []
        with open(os.path.join(self.root, "imu0", "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]))
                vals = [float(v) for v in row[1:7]]
                gyro.append(vals[0:3])
                acc.append(vals[3:6])
        return (
            np.asarray(ts, np.int64),
            np.asarray(gyro, np.float32),
            np.asarray(acc, np.float32),
        )

    def _read_groundtruth(self) -> Optional[dict]:
        p = os.path.join(self.root, "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(p):
            return None
        ts, pos, quat_, vel, bg, ba = [], [], [], [], [], []
        with open(p) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                v = [float(x) for x in row[1:]]
                ts.append(int(row[0]))
                pos.append(v[0:3])
                quat_.append(v[3:7])  # w x y z
                vel.append(v[7:10])
                bg.append(v[10:13])
                ba.append(v[13:16])
        return dict(
            ts=np.asarray(ts, np.int64),
            pos=np.asarray(pos, np.float32),
            quat=np.asarray(quat_, np.float32),
            vel=np.asarray(vel, np.float32),
            bias_gyro=np.asarray(bg, np.float32),
            bias_acc=np.asarray(ba, np.float32),
        )

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.image_ts)

    def frame_time(self, i: int) -> float:
        return (self.image_ts[i] - self.t0_ns) * 1e-9

    def image_paths(self, cam: str = "cam0") -> list:
        """The image files of one camera in frame order."""
        if cam == "cam0":
            files = self.image_files
        else:
            files = [self._cam1_files[t] for t in self.image_ts]
        return [os.path.join(self.root, cam, "data", f) for f in files]

    def stereo_pair_u8(self, i: int):
        """The i-th stereo pair as (left, right) (H, W) uint8 arrays."""
        t = self.image_ts[i]
        f0 = os.path.join(self.root, "cam0", "data", self.image_files[i])
        f1 = os.path.join(self.root, "cam1", "data", self._cam1_files[t])
        return _decode_gray(f0), _decode_gray(f1)

    def stereo_pair(self, i: int):
        """Load the i-th stereo pair as (left, right) (H, W) f32 arrays 0-255."""
        left, right = self.stereo_pair_u8(i)
        return left.astype(np.float32), right.astype(np.float32)

    def imu_between(self, t0: float, t1: float):
        """IMU samples with t0 <= t < t1 (sequence-relative seconds).
        Returns (gyro, acc, dts)."""
        ts = (self.imu_ts - self.t0_ns) * 1e-9
        m = (ts >= t0) & (ts < t1)
        idx = np.nonzero(m)[0]
        if len(idx) == 0:
            z = np.zeros((0, 3), np.float32)
            return z, z, np.zeros((0,), np.float32)
        dts = np.diff(ts[idx], append=min(t1, ts[idx[-1]] + 0.005)).astype(np.float32)
        return self.imu_gyro[idx], self.imu_acc[idx], dts

    def groundtruth_at_frames(self):
        """GT positions resampled at image timestamps (centered at origin)."""
        if self.gt is None:
            return None
        gt_ts = (self.gt["ts"] - self.t0_ns) * 1e-9
        img_ts = (np.asarray(self.image_ts) - self.t0_ns) * 1e-9
        pos = np.stack(
            [np.interp(img_ts, gt_ts, self.gt["pos"][:, k]) for k in range(3)], -1
        )
        return pos - pos[0]
