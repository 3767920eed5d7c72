"""An EuRoC-format sequence generated from the synthetic world.

JAX-free copy of scripts/make_euroc_fixture.py::write_fixture over the
port's io/synthetic.py and quaternions. It writes a <out>/mav0 tree with
EuRoC's on-disk layout: cam0/cam1 sensor.yaml (the published EuRoC MH
calibration: radial-tangential distortion, non-coplanar T_BS), data.csv
timestamp and file lists, 8-bit grayscale PNGs, the 200 Hz imu0/data.csv,
imu0/sensor.yaml noise densities and the 17-column
state_groundtruth_estimate0 csv. The yaml and csv files are byte-equal to
the original writer's; the PNGs are encoded here with the standard
library's zlib (no image library) and decode to the same pixels.

Each camera renders at T_wb . T_BS_cam, and every landmark's projected
center goes through the forward radial-tangential model before splatting,
so rectification has real distortion and a real stereo misalignment to
undo.

`scale` scales resolution and intrinsics together (the distortion
coefficients act on normalized coordinates and stay valid).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from orbslam3_tpu_torch.geometry.quat import from_matrix_np
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig, SyntheticWorld, _qmat, _qmul, _qrot

# ---- published EuRoC MH calibration (sensor.yaml of cam0/cam1/imu0) ----
T_BS_CAM0 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])
T_BS_CAM1 = np.array([
    [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
    [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
    [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
    [0.0, 0.0, 0.0, 1.0],
])
INTR0 = (458.654, 457.296, 367.215, 248.375)
INTR1 = (457.587, 456.134, 379.999, 255.238)
DIST0 = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
DIST1 = (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05)
RES = (752, 480)
T0_NS = 1403636579763555584  # EuRoC MH_01-style epoch

CAM_YAML = """\
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam{idx} (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [{tbs}]

# Camera specific definitions.
rate_hz: {hz}
resolution: [{w}, {h}]
camera_model: pinhole
intrinsics: [{fx}, {fy}, {cx}, {cy}] # fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [{d0}, {d1}, {d2}, {d3}]
"""

IMU_YAML = """\
# Default imu sensor yaml file
sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]

rate_hz: 200

# inertial sensor noise model parameters (static)
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ]
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ]
"""


def write_png_gray(path: str, img: np.ndarray):
    """An (H, W) uint8 image as an 8-bit grayscale, non-interlaced PNG
    (every scanline with filter 0), compressed by zlib."""
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(img, np.uint8)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def distort_radtan(xn, yn, d):
    """Forward radial-tangential model on normalized coords."""
    k1, k2, p1, p2 = d
    r2 = xn * xn + yn * yn
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * rad + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * rad + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def render_cam(world, q_wc, p_wc, K, dist, w, h):
    """Splat the world's landmark quads through an arbitrary K and radtan
    distortion (the synthetic world's fiducial renderer with distorted
    feature centers)."""
    fx, fy, cx, cy = K
    R = _qmat(q_wc.astype(np.float64))
    xc = (world.landmarks - p_wc) @ R
    z = xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xn = xc[:, 0] / np.maximum(z, 1e-6)
        yn = xc[:, 1] / np.maximum(z, 1e-6)
    xd, yd = distort_radtan(xn, yn, dist)
    uv = np.stack([fx * xd + cx, fy * yd + cy], -1)
    vis = ((z > 0.25) & (uv[:, 0] > -20) & (uv[:, 0] < w + 20)
           & (uv[:, 1] > -20) & (uv[:, 1] < h + 20))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.45 + 0.05 * np.sin(xx * 0.011) * np.cos(yy * 0.013)
    idx = np.where(vis)[0]
    idx = idx[np.argsort(-z[idx])]
    for i in idx:
        s_px = fx * world.lm_size[i] / z[i]
        s_px = float(np.clip(s_px, 5.0, 40.0))
        half = int(np.ceil(s_px / 2))
        cu, cv = uv[i]
        u0, v0 = int(np.floor(cu)) - half, int(np.floor(cv)) - half
        u1, v1 = u0 + 2 * half + 1, v0 + 2 * half + 1
        uu0, vv0 = max(u0, 0), max(v0, 0)
        uu1, vv1 = min(u1, w), min(v1, h)
        if uu1 <= uu0 or vv1 <= vv0:
            continue
        px = np.arange(uu0, uu1, dtype=np.float32) - cu
        py = np.arange(vv0, vv1, dtype=np.float32) - cv
        PX, PY = np.meshgrid(px, py)
        inside = (np.abs(PX) <= s_px / 2) & (np.abs(PY) <= s_px / 2)
        qu = (PX >= 0).astype(np.int32)
        qv = (PY >= 0).astype(np.int32)
        vals = world.lm_quad[i][qv, qu]
        region = img[vv0:vv1, uu0:uu1]
        img[vv0:vv1, uu0:uu1] = np.where(inside, vals, region)
    return (img * 255.0).astype(np.uint8)


_POOL = None


def _pool_init(world, cams, size, blackout):
    global _POOL
    _POOL = (world, cams, size, blackout)


def _frame_images(t):
    """Both cameras' images at frame time t (flat gray in a blackout)."""
    world, cams, (w, h), blackout = _POOL
    if blackout is not None and blackout[0] <= t < blackout[1]:
        blank = np.full((h, w), 127, np.uint8)
        return [blank, blank]
    q, p = world.gt_pose(t)
    q64, p64 = q.astype(np.float64), p.astype(np.float64)
    return [render_cam(world, _qmul(q64, qbs), p64 + _qrot(q64, pbs), K, D, w, h)
            for K, D, qbs, pbs in cams]


def _write_frame(args):
    t, paths = args
    for img, path in zip(_frame_images(t), paths):
        write_png_gray(path, img)


def write_fixture(outdir, duration=8.0, hz=10.0, scale=0.5, seed=7, revisit=False,
                  workers: int = 1):
    """Write the sequence under <outdir>/mav0 and return that directory.

    revisit=True: a drift-then-revisit sequence, one full pan per
    duration / 2 with a position of the same period (the second lap
    revisits the first lap's poses), and a 3 s camera blackout paired with
    an IMU bias step in the first lap, so loop closing must fire on
    EuRoC-format input. `workers` > 1 renders the frames in that many
    spawned processes (the files are the same)."""
    w, h = int(RES[0] * scale), int(RES[1] * scale)
    K0 = tuple(v * scale for v in INTR0)
    K1 = tuple(v * scale for v in INTR1)

    extra = {}
    blackout = None
    if revisit:
        lap = duration / 2.0
        # mid-lap-1, 3 s: long enough for real dead-reckoning drift (the bias
        # step lands at its start), so a loop correction is needed
        blackout = (0.58 * lap, 0.58 * lap + 3.0)
        extra = dict(yaw_amp=0.0, yaw_rate=2 * np.pi / lap,
                     pos_freq=(1.0 / lap, 2.0 / lap, 3.0 / lap), imu_noise=True,
                     bias_step_t=blackout[0], gyro_bias_step=(0.003, 0.002, -0.004),
                     accel_bias_step=(0.10, -0.08, 0.08))
    cfg = SyntheticConfig(seed=seed, duration=duration, cam_hz=hz, width=w, height=h,
                          fx=K0[0], fy=K0[1], n_landmarks=1200, pos_amp=(1.6, 1.2, 0.5),
                          gyro_bias=(0.002, -0.0015, 0.003), accel_bias=(0.02, 0.015, -0.03),
                          **extra)
    world = SyntheticWorld(cfg)

    root = os.path.join(outdir, "mav0")
    q_bs0, p_bs0 = np.asarray(from_matrix_np(T_BS_CAM0[:3, :3])), T_BS_CAM0[:3, 3]
    q_bs1, p_bs1 = np.asarray(from_matrix_np(T_BS_CAM1[:3, :3])), T_BS_CAM1[:3, 3]

    for idx, (K, D, tbs) in enumerate([(K0, DIST0, T_BS_CAM0), (K1, DIST1, T_BS_CAM1)]):
        os.makedirs(os.path.join(root, f"cam{idx}", "data"), exist_ok=True)
        with open(os.path.join(root, f"cam{idx}", "sensor.yaml"), "w") as f:
            f.write(CAM_YAML.format(idx=idx, hz=hz, w=w, h=h,
                                    tbs=", ".join(f"{v:.12g}" for v in tbs.reshape(-1)),
                                    fx=K[0], fy=K[1], cx=K[2], cy=K[3],
                                    d0=D[0], d1=D[1], d2=D[2], d3=D[3]))

    times = world.frame_times()
    rows0, rows1 = ["#timestamp [ns],filename"], ["#timestamp [ns],filename"]
    jobs = []
    for t in times:
        ts_ns = T0_NS + int(round(t * 1e9))
        fn = f"{ts_ns}.png"
        rows0.append(f"{ts_ns},{fn}")
        rows1.append(f"{ts_ns},{fn}")
        jobs.append((t, [os.path.join(root, f"cam{i}", "data", fn) for i in (0, 1)]))
    init = (world, [(K0, DIST0, q_bs0, p_bs0), (K1, DIST1, q_bs1, p_bs1)], (w, h), blackout)
    if workers <= 1:
        _pool_init(*init)
        for job in jobs:
            _write_frame(job)
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                 initializer=_pool_init, initargs=init) as ex:
            list(ex.map(_write_frame, jobs, chunksize=max(len(jobs) // (workers * 4), 1)))
    with open(os.path.join(root, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(rows0) + "\n")
    with open(os.path.join(root, "cam1", "data.csv"), "w") as f:
        f.write("\n".join(rows1) + "\n")

    # ---- IMU: 200 Hz body-frame stream in EuRoC column order
    imu_dir = os.path.join(root, "imu0")
    os.makedirs(imu_dir, exist_ok=True)
    with open(os.path.join(imu_dir, "sensor.yaml"), "w") as f:
        f.write(IMU_YAML)
    rows = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
            "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
            "a_RS_S_z [m s^-2]"]
    for t in world.imu_times():
        g, a = world.imu_sample(float(t))
        ts_ns = T0_NS + int(round(float(t) * 1e9))
        rows.append(f"{ts_ns},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                    f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")

    # ---- 17-column ground truth (pose + velocity + biases)
    gt_dir = os.path.join(root, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    rows = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
            "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], v_RS_R_x [m s^-1], "
            "v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], b_w_RS_S_x [rad s^-1], "
            "b_w_RS_S_y [rad s^-1], b_w_RS_S_z [rad s^-1], b_a_RS_S_x [m s^-2], "
            "b_a_RS_S_y [m s^-2], b_a_RS_S_z [m s^-2]"]
    bg, ba = cfg.gyro_bias, cfg.accel_bias
    for t in times:
        q, p = world.gt_pose(t)
        v = world.gt_velocity(t)
        ts_ns = T0_NS + int(round(t * 1e9))
        rows.append(f"{ts_ns},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                    f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f},"
                    f"{v[0]:.6f},{v[1]:.6f},{v[2]:.6f},"
                    f"{bg[0]},{bg[1]},{bg[2]},{ba[0]},{ba[1]},{ba[2]}")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return root
