"""Torch port of EuRoC ingest against the JAX package: the cases of
tests/test_rectify.py, tests/test_euroc_loader.py and tests/test_native_io.py
on the same inputs.

- rectification maps, the rectified intrinsics, baseline and rotations, and
  body_from_rect_cam: exact (both are host numpy);
- remap_bilinear: the floats within 1e-4 on the 0..255 scale, and the
  uint8 images (truncated as scripts/run_euroc.py:112-113 truncates them)
  exact wherever the JAX float lies 1e-4 or more from an integer; the
  flips inside that band are counted and printed, and there are none on
  random images and on fixture frames (where most pixels land on an
  integer): the port rounds as XLA:CPU's fused multiply-adds do;
- the loader (calibration, image list, IMU windows, ground truth, the IMU
  noise densities): exact against the JAX EurocDataset on the same tree;
- the native library (built here with g++ from native/dataloader.cpp;
  these cases skip only where g++ or zlib is missing): grayscale PNGs
  decode pixel-equal to the JAX package's decoder, RGB and RGBA within one
  gray level, the IMU csv parse and the prefetcher's order exact.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.io import euroc as jeuroc
from orbslam3_tpu.io import native as jnative
from orbslam3_tpu.io import rectify as jrect
from orbslam3_tpu_torch.io import euroc as teuroc
from orbslam3_tpu_torch.io import native as tnative
from orbslam3_tpu_torch.io import rectify as trect
from orbslam3_tpu_torch.io.euroc_fixture import (DIST0, DIST1, INTR0, INTR1, RES, T_BS_CAM0,
                                                 T_BS_CAM1, write_png_gray)

W, H = 384, 256
K = np.array([[240.0, 0, W / 2], [0, 240.0, H / 2], [0, 0, 1.0]])


def _K(intr, scale):
    fx, fy, cx, cy = (v * scale for v in intr)
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def euroc_maps(scale):
    """The rectification of the published EuRoC MH calibration at `scale`."""
    size = (int(RES[0] * scale), int(RES[1] * scale))
    args = (_K(INTR0, scale), np.asarray(DIST0), T_BS_CAM0, _K(INTR1, scale), np.asarray(DIST1),
            T_BS_CAM1, size)
    return jrect.stereo_rectify_maps(*args), trect.stereo_rectify_maps(*args)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_rectify_maps_exact(scale):
    j, t = euroc_maps(scale)
    for f in jrect.RectifyMaps._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, f)), np.asarray(getattr(j, f)),
                                      err_msg=f)
    jq, jp = jrect.body_from_rect_cam(T_BS_CAM0, j.R_rect0)
    tq, tp = trect.body_from_rect_cam(T_BS_CAM0, t.R_rect0)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tp, jp)


def test_identity_when_undistorted_and_aligned():
    T1 = np.eye(4)
    T1[:3, 3] = [0.11, 0.0, 0.0]
    m = trect.stereo_rectify_maps(K, np.zeros(4), np.eye(4), K, np.zeros(4), T1, (W, H))
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    np.testing.assert_allclose(m.map_x0, us, atol=0.6)
    np.testing.assert_allclose(m.map_y0, vs, atol=0.6)
    assert abs(m.baseline - 0.11) < 1e-6


def remap_both(img, mx, my):
    """(JAX float image, port float image) of one remap."""
    j = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    t = trect.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx),
                             torch.from_numpy(my)).numpy()
    return j, t


def hold_u8(j, t, what):
    """Floats within 1e-4; uint8 truncations exact off the 1e-4 band around
    the integers; returns the flips (all inside the band)."""
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    ju, tu = j.astype(np.uint8), t.astype(np.uint8)
    near = np.abs(j - np.round(j)) < 1e-4
    np.testing.assert_array_equal(tu[~near], ju[~near])
    flips = int((tu != ju).sum())
    print(f"{what}: {flips} flipped pixels of {ju.size}, {int(near.sum())} within 1e-4 of an "
          "integer")
    return flips


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_remap_against_jax(scale):
    jm, _ = euroc_maps(scale)
    h, w = jm.map_x0.shape
    rng = np.random.default_rng(int(scale * 10))
    img = rng.integers(0, 256, (h, w)).astype(np.float32)
    for cam, (mx, my) in enumerate(((jm.map_x0, jm.map_y0), (jm.map_x1, jm.map_y1))):
        j, t = remap_both(img, mx, my)
        assert hold_u8(j, t, f"scale {scale}, cam{cam}") == 0
        u8 = trect.remap_u8(torch.from_numpy(img.astype(np.uint8)), torch.from_numpy(mx),
                            torch.from_numpy(my))
        np.testing.assert_array_equal(u8.numpy(), t.astype(np.uint8))


def test_remap_out_of_bounds_and_edges():
    """Maps that reach past the image and land on its last row and column."""
    img = np.arange(6 * 7, dtype=np.float32).reshape(6, 7) * 5.0
    mx = np.array([[-0.5, 0.0, 6.0, 6.5], [2.25, 5.999, 3.0, 1.5]], np.float32)
    my = np.array([[1.0, 0.0, 5.0, 2.0], [4.75, 5.0, -1e-3, 2.5]], np.float32)
    j, t = remap_both(img, mx, my)
    np.testing.assert_array_equal(t, j)
    assert t[0, 0] == 0.0 and t[0, 3] == 0.0 and t[1, 2] == 0.0


def test_distortion_removed():
    """A scene of dots rendered with radtan distortion, rectified by the
    port, lands on the ideal pinhole render of the same scene."""
    rng = np.random.default_rng(3)
    d = np.array([-0.28, 0.07, 0.0002, 0.00002])
    pts = np.stack([rng.uniform(-2, 2, 60), rng.uniform(-1.3, 1.3, 60), np.full(60, 5.0)], -1)

    def render(distort):
        img = np.zeros((H, W), np.float32)
        for X in pts:
            xn, yn = X[0] / X[2], X[1] / X[2]
            if distort:
                xn, yn = trect._distort_radtan(xn, yn, d)
            u, v = K[0, 0] * xn + K[0, 2], K[1, 1] * yn + K[1, 2]
            ui, vi = int(round(u)), int(round(v))
            if 2 <= ui < W - 2 and 2 <= vi < H - 2:
                img[vi - 1: vi + 2, ui - 1: ui + 2] = 255.0
        return img

    T1 = np.eye(4)
    T1[:3, 3] = [0.11, 0.0, 0.0]
    m = trect.stereo_rectify_maps(K, d, np.eye(4), K, d, T1, (W, H))
    j, t = remap_both(render(True), m.map_x0, m.map_y0)
    hold_u8(j, t, "dots")

    def centroids(img):
        ys, xs = np.nonzero(img > 100)
        out = {}
        for y, x in zip(ys, xs):
            out.setdefault((y // 6, x // 6), []).append((y, x))
        return [np.mean(v, axis=0) for v in out.values() if len(v) >= 4]

    ci, cr = np.array(centroids(render(False))), np.array(centroids(t))
    assert len(cr) >= 0.8 * len(ci)
    d2 = np.linalg.norm(ci[:, None] - cr[None], axis=-1)
    assert np.median(d2.min(axis=0)) < 1.0


SENSOR_YAML = """# camera sensor
sensor_type: camera
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375]
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""

IMU_YAML = """sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 200
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ]
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ]
"""


@pytest.fixture()
def euroc_dir(tmp_path):
    """tests/test_euroc_loader.py's miniature sequence: 3 stereo pairs of
    random 64x48 PNGs, 40 IMU rows, 10 ground-truth rows."""
    root = tmp_path / "MH_test" / "mav0"
    cam1_yaml = SENSOR_YAML.replace("-0.064676986768", "0.0453689425024")
    for cam, yaml_text in [("cam0", SENSOR_YAML), ("cam1", cam1_yaml)]:
        d = root / cam / "data"
        d.mkdir(parents=True)
        (root / cam / "sensor.yaml").write_text(yaml_text)
        rows = ["#timestamp [ns],filename"]
        for i in range(3):
            ts = 1403636579763555584 + i * 50_000_000
            rows.append(f"{ts},{ts}.png")
            img = np.random.default_rng(i).uniform(0, 255, (48, 64)).astype(np.uint8)
            write_png_gray(str(d / f"{ts}.png"), img)
        (root / cam / "data.csv").write_text("\n".join(rows))
    imu = root / "imu0"
    imu.mkdir()
    (imu / "sensor.yaml").write_text(IMU_YAML)
    t0 = 1403636579763555584 - 5_000_000
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    rows += [f"{t0 + i * 5_000_000},0.01,0.02,-0.01,0.1,0.2,9.7" for i in range(40)]
    (imu / "data.csv").write_text("\n".join(rows))
    gt = root / "state_groundtruth_estimate0"
    gt.mkdir()
    rows = ["#ts,px,py,pz,qw,qx,qy,qz,vx,vy,vz,bwx,bwy,bwz,bax,bay,baz"]
    rows += [f"{t0 + i * 20_000_000},{0.1 * i},{0.05 * i},0.0,1,0,0,0,0.5,0.25,0,0.001,0.001,"
             "0.001,0.01,0.01,0.01" for i in range(10)]
    (gt / "data.csv").write_text("\n".join(rows))
    return str(root)


def test_loader_against_jax(euroc_dir):
    j, t = jeuroc.EurocDataset(euroc_dir), teuroc.EurocDataset(euroc_dir)
    assert len(t) == len(j) == 3
    for cam in ("cam0", "cam1"):
        for f in jeuroc.CamCalib._fields:
            a, b = getattr(getattr(t, cam), f), getattr(getattr(j, cam), f)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{cam}.{f}")
    assert t.cam0.K[0, 0] == pytest.approx(458.654) and t.cam0.resolution == (752, 480)
    assert t.baseline == j.baseline and 0.05 < t.baseline < 0.2
    assert t.image_ts == j.image_ts and t.image_files == j.image_files and t.t0_ns == j.t0_ns
    for i in range(3):
        assert t.frame_time(i) == j.frame_time(i)
        for a, b in zip(t.stereo_pair(i), j.stereo_pair(i)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for a, b in zip(t.imu_between(t.frame_time(0), t.frame_time(1)),
                    j.imu_between(j.frame_time(0), j.frame_time(1))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    g, _, d = t.imu_between(t.frame_time(0), t.frame_time(1))
    assert len(g) == 10 and d.sum() == pytest.approx(0.05, abs=0.01)
    for k in j.gt:
        np.testing.assert_array_equal(t.gt[k], j.gt[k], err_msg=k)
    np.testing.assert_array_equal(t.groundtruth_at_frames(), j.groundtruth_at_frames())


def test_imu_calib_against_jax(euroc_dir):
    j, t = jeuroc.EurocDataset(euroc_dir).imu_calib, teuroc.EurocDataset(euroc_dir).imu_calib
    from orbslam3_tpu_torch.imu.preintegration import ImuNoise

    assert isinstance(t.noise, ImuNoise)
    assert tuple(t.noise) == tuple(j.noise)
    assert t.noise.sigma_g == pytest.approx(1.6968e-4) and t.rate_hz == j.rate_hz == 200.0
    np.testing.assert_array_equal(t.T_BS, j.T_BS)


@pytest.fixture(scope="module")
def native_lib():
    """The native library, built with g++; the cases skip only where g++
    or zlib is missing."""
    if shutil.which(tnative.COMPILER) is None:
        pytest.skip(f"{tnative.COMPILER} not found")
    try:
        tnative.build()
    except RuntimeError as e:
        if "zlib" in str(e):
            pytest.skip("zlib headers not found")
        raise
    assert tnative.available()
    return tnative


@pytest.fixture()
def pngs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths, arrays = [], []
    for i, mode in enumerate(["L", "RGB", "RGBA"]):
        a = rng.integers(0, 255, (37, 53, {"L": 1, "RGB": 3, "RGBA": 4}[mode]))
        img = Image.fromarray(a.astype(np.uint8).squeeze(), mode)
        p = tmp_path / f"img{i}_{mode}.png"
        img.save(p)
        paths.append(str(p))
        arrays.append(np.asarray(img.convert("L"), np.uint8))
    return paths, arrays


def test_png_decode_against_jax(native_lib, pngs, tmp_path):
    paths, _ = pngs
    gray = native_lib.png_decode_gray(paths[0])
    assert gray.dtype == np.uint8
    np.testing.assert_array_equal(gray, jnative.png_decode_gray(paths[0]))
    for p in paths[1:]:
        a, b = native_lib.png_decode_gray(p), jnative.png_decode_gray(p)
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1
    # the fixture writer's PNGs (zlib, filter 0) decode to their pixels
    img = np.random.default_rng(5).integers(0, 256, (31, 45)).astype(np.uint8)
    write_png_gray(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(native_lib.png_decode_gray(str(tmp_path / "w.png")), img)
    np.testing.assert_array_equal(jnative.png_decode_gray(str(tmp_path / "w.png")), img)


def test_imu_csv_against_jax_loader(native_lib, euroc_dir, tmp_path):
    p = tmp_path / "data.csv"
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    rows += [f"{1000 + i * 5},{0.1 * i},{-0.2},{0.3},{1.0},{2.0},{9.8}" for i in range(50)]
    p.write_text("\n".join(rows))
    ts, gyro, acc = native_lib.imu_csv_parse(str(p))
    assert len(ts) == 50 and ts[0] == 1000
    np.testing.assert_allclose(gyro[3], [0.3, -0.2, 0.3], atol=1e-6)
    np.testing.assert_allclose(acc[0], [1.0, 2.0, 9.8], atol=1e-6)
    # the loader's own IMU stream: equal to the JAX loader's csv parse
    ts, gyro, acc = native_lib.imu_csv_parse(os.path.join(euroc_dir, "imu0", "data.csv"))
    j = jeuroc.EurocDataset(euroc_dir)
    np.testing.assert_array_equal(ts, j.imu_ts)
    np.testing.assert_array_equal(gyro, j.imu_gyro)
    np.testing.assert_array_equal(acc, j.imu_acc)


def test_prefetcher(native_lib, euroc_dir, tmp_path):
    rng = np.random.default_rng(1)
    paths, truth = [], []
    for i in range(12):
        a = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        p = str(tmp_path / f"{i}.png")
        write_png_gray(p, a)
        paths.append(p)
        truth.append(a)
    pf = native_lib.ImagePrefetcher(paths, 32, 24, threads=3)
    for i in range(12):
        np.testing.assert_array_equal(pf.get(i), truth[i])
    pf.close()
    # the loader's two cameras in frame order, as the runner prefetches them
    ds = teuroc.EurocDataset(euroc_dir)
    pfs = [native_lib.ImagePrefetcher(ds.image_paths(c), 64, 48, threads=2)
           for c in ("cam0", "cam1")]
    for i in range(len(ds)):
        for pf, img in zip(pfs, ds.stereo_pair_u8(i)):
            np.testing.assert_array_equal(pf.get(i), img)
    for pf in pfs:
        pf.close()


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_remap_fixture_frames_against_jax(tmp_path, scale):
    """Rectified fixture frames (flat-shaded quads: most remapped pixels
    land on an integer, where truncation is most fragile) as
    scripts/run_euroc.py feeds them to the tracker."""
    from orbslam3_tpu_torch.io.euroc_fixture import write_fixture

    ds = teuroc.EurocDataset(write_fixture(str(tmp_path), duration=0.3, hz=10.0, scale=scale))
    jm, _ = euroc_maps(scale)
    total = 0
    for i in range(len(ds)):
        for img, (mx, my) in zip(ds.stereo_pair(i), ((jm.map_x0, jm.map_y0),
                                                     (jm.map_x1, jm.map_y1))):
            j, t = remap_both(img, mx, my)
            total += hold_u8(j, t, f"scale {scale}, frame {i}")
    assert total == 0
