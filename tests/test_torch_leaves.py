"""Torch port of the front end's and the IMU's one-call leaves against the
JAX package, on one HARD_WORLD frame at 384x256 with 4 pyramid levels and on
seeded IMU windows.

- detect_orb (one image, one FAST/NMS launch at B=1) against the JAX
  detect_orb with tests/test_torch_frontend.py's tolerances (octave and
  validity exact, level-0 responses exact, responses 1e-2, uv 1e-4,
  descriptors >= 99% equal) and against the port's own detect_orb_pair
  left features bit for bit: a product must not see the batch size;
- hamming_matrix_popcount and hamming_pairs: exact, and equal to the
  matrix-product hamming_matrix;
- orientations and descriptors (one-image wrappers over the patch gather):
  angles 1e-5 rad, descriptors >= 99% equal (one bit follows an angle's
  last ulp), and bit for bit on the JAX angles wherever no sample point
  lies within 1e-5 px of a rounding boundary;
- subpixel_refine: 1e-6 on the 0..0.5 offsets;
- process_stereo and StereoFrame: on the same images, the fields of the
  port's frame equal its own detect_orb_pair + match_stereo run, and
  against JAX: validity of depth >= 99% equal, depths 1e-5 relative where
  both match;
- integrate (the sequential scan) against JAX's integrate within the IMU
  tolerances of test_torch_imu.py (1e-5 of each field's largest entry),
  and against the port's integrate_assoc: the deltas, dt and the
  Jacobians J_r_bg, J_v_ba, J_p_ba within the same 1e-5; the covariance and
  J_v_bg, J_p_bg within what separates the JAX package's own two (the
  tree of merges discretizes their bias coupling otherwise: up to 8% of
  the covariance's scale) plus 1e-5; information_9 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend import orb as jorb
from orbslam3_tpu.frontend import stereo as jst
from orbslam3_tpu.imu import preintegration as jp
from orbslam3_tpu.io.synthetic import SyntheticConfig as JCfg
from orbslam3_tpu.io.synthetic import SyntheticWorld as JWorld
from orbslam3_tpu.ops import brief as jbrief
from orbslam3_tpu.ops import fast as jfast
from orbslam3_tpu.ops import hamming as jham
from orbslam3_tpu.ops import pyramid as jpyr
from orbslam3_tpu_torch.frontend import orb as torb
from orbslam3_tpu_torch.frontend import stereo as tst
from orbslam3_tpu_torch.imu import preintegration as tp
from orbslam3_tpu_torch.ops import brief as tbrief
from orbslam3_tpu_torch.ops import fast as tfast
from orbslam3_tpu_torch.ops import hamming as tham
from torch_parity import HARD_WORLD, port_camera

SMALL = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=2.0,
             cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3), **HARD_WORLD)
LEVELS = 4


@pytest.fixture(scope="module")
def frame():
    jw = JWorld(JCfg(**SMALL))
    left, right = [x.astype(np.uint8).astype(np.float32) for x in jw.render_frame(0.5)]
    jcfg = jorb.OrbConfig(n_features=384, n_levels=LEVELS)
    tcfg = torb.OrbConfig(n_features=384, n_levels=LEVELS)
    fj = jax.tree.map(np.asarray, jorb.detect_orb(jnp.asarray(left), jcfg))
    ft = torb.detect_orb(torch.from_numpy(left), tcfg)
    pair = torb.detect_orb_pair(torch.from_numpy(left), torch.from_numpy(right), tcfg)
    return dict(left=left, right=right, fj=fj, ft=ft, pair=pair, jcam=jw.cam, tcfg=tcfg,
                jcfg=jcfg)


def test_detect_orb_against_jax(frame):
    j, t = frame["fj"], torb.Features(*[x.numpy() for x in frame["ft"]])
    for f in torb.Features._fields:
        assert getattr(t, f).dtype == getattr(j, f).dtype, f
        assert getattr(t, f).shape == getattr(j, f).shape, f
    np.testing.assert_array_equal(t.octave, j.octave)
    np.testing.assert_array_equal(t.valid, j.valid)
    lv0 = j.octave == 0
    np.testing.assert_array_equal(t.response[lv0], j.response[lv0])
    np.testing.assert_allclose(t.response, j.response, rtol=0, atol=1e-2)
    np.testing.assert_allclose(t.uv, j.uv, rtol=0, atol=1e-4)
    same = (t.desc == j.desc).all(axis=1)[j.valid]
    assert same.mean() >= 0.99, same.mean()


def test_detect_orb_is_the_pairs_left(frame):
    """One image gives the bits it gets as the left of a stereo pair."""
    left = frame["pair"][0]
    for f in torb.Features._fields:
        a, b = getattr(frame["ft"], f), getattr(left, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("n_a,n_b,seed", [(384, 384, 0), (17, 5, 1), (1, 64, 2)])
def test_hamming_popcount(n_a, n_b, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (n_a, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n_b, 32), dtype=np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tham.hamming_matrix_popcount(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jham.hamming_matrix_popcount(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got.numpy(), tham.hamming_matrix(ta, tb).numpy())
    n = min(n_a, n_b)
    pairs = tham.hamming_pairs(ta[:n], tb[:n])
    assert pairs.dtype == torch.int32
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(
        jham.hamming_pairs(jnp.asarray(a[:n]), jnp.asarray(b[:n]))))


def _keypoints(frame):
    j = frame["fj"]
    sel = (j.octave == 0) & j.valid
    return (j.uv[sel, 1].round().astype(np.int32), j.uv[sel, 0].round().astype(np.int32))


def test_orientations_and_descriptors(frame):
    ys, xs = _keypoints(frame)
    img = frame["left"]
    ja = np.asarray(jax.jit(jbrief.orientations)(jnp.asarray(img), ys, xs))
    ta = tbrief.orientations(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    assert ta.shape == ja.shape and len(ja) > 100
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-5)
    blurred = np.asarray(jax.jit(jpyr.blur)(jnp.asarray(img)))
    jd = np.asarray(jax.jit(jbrief.descriptors)(jnp.asarray(blurred), ys, xs, jnp.asarray(ja)))
    td = tbrief.descriptors(torch.from_numpy(blurred), torch.from_numpy(ys),
                            torch.from_numpy(xs), torch.from_numpy(ja)).numpy()
    assert td.dtype == jd.dtype == np.uint8 and td.shape == jd.shape
    # on the same angles: exact wherever no rotated sample point sits on a
    # rounding boundary of the nearest-neighbour lookup
    pat = tbrief.BRIEF_PATTERN
    ca, sa = np.cos(ja)[:, None, None], np.sin(ja)[:, None, None]
    rx = ca * pat[..., 0] - sa * pat[..., 1]
    ry = sa * pat[..., 0] + ca * pat[..., 1]
    edge = lambda r: np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-5  # noqa: E731
    clean = ~(edge(rx) | edge(ry)).any(axis=(1, 2))
    assert clean.mean() > 0.9
    np.testing.assert_array_equal(td[clean], jd[clean])
    assert (td == jd).all(axis=1).mean() >= 0.99


def test_subpixel_refine():
    rng = np.random.default_rng(3)
    score = rng.uniform(0, 50, (64, 80)).astype(np.float32)
    score[10:13, 20:23] = [[1, 2, 1], [3, 40, 5], [1, 2, 1]]
    score[30, 30:33] = 7.0  # a flat row: denominator 0 in x
    ys = np.concatenate([[11, 30, 0, 63], rng.integers(0, 64, 60)]).astype(np.int32)
    xs = np.concatenate([[21, 31, 0, 79], rng.integers(0, 80, 60)]).astype(np.int32)
    jdy, jdx = [np.asarray(x) for x in jax.jit(jfast.subpixel_refine)(jnp.asarray(score), ys, xs)]
    tdy, tdx = tfast.subpixel_refine(torch.from_numpy(score), torch.from_numpy(ys),
                                     torch.from_numpy(xs))
    np.testing.assert_allclose(tdy.numpy(), jdy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tdx.numpy(), jdx, rtol=0, atol=1e-6)
    assert np.abs(jdx).max() <= 0.5 and (np.abs(jdx) > 0.01).any()


def test_process_stereo(frame):
    tcam = port_camera(frame["jcam"])
    L, R = torch.from_numpy(frame["left"]), torch.from_numpy(frame["right"])
    sf = tst.process_stereo(L, R, tcam, frame["tcfg"])
    assert isinstance(sf, tst.StereoFrame) and sf._fields == jst.StereoFrame._fields
    featL, featR = frame["pair"]
    u_r, depth, has = tst.match_stereo(featL, featR, tcam)
    assert torch.equal(sf.u_right, u_r) and torch.equal(sf.depth, depth)
    assert torch.equal(sf.has_depth, has)
    for a, b in zip(sf.feat, featL):
        assert torch.equal(a, b)
    pts = tcam.unproject(featL.uv, torch.where(has, depth, torch.ones_like(depth)))
    assert torch.equal(sf.points_cam, pts)
    js = jax.tree.map(np.asarray, jst.process_stereo(jnp.asarray(frame["left"]),
                                                     jnp.asarray(frame["right"]),
                                                     frame["jcam"], frame["jcfg"]))
    th = sf.has_depth.numpy()
    assert (th == js.has_depth).mean() >= 0.99 and js.has_depth.sum() > 50
    both = th & js.has_depth
    np.testing.assert_allclose(sf.depth.numpy()[both], js.depth[both], rtol=1e-5)
    np.testing.assert_allclose(sf.points_cam.numpy()[both], js.points_cam[both], rtol=1e-5,
                               atol=1e-5)


def _window(seed, n_valid, n=32):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 0.5, (n_valid, 3)).astype(np.float32)
    a = (rng.normal(0, 1.0, (n_valid, 3)) + [0, 0, 9.81]).astype(np.float32)
    d = np.full(n_valid, 0.005, np.float32)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    return (*jp.pad_imu_window(g, a, d, n), bg, ba)


def _assert_state(t, j, rtol=1e-5):
    for f in jp.PreintState._fields:
        tv = getattr(t, f).numpy()
        jv = np.asarray(getattr(j, f))
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, f
        scale = max(np.abs(jv).max(), 1e-30)
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=rtol * scale, err_msg=f)


# the fields the tree of merges computes by another discretization
ASSOC_APART = ("cov", "J_v_bg", "J_p_bg")


@pytest.mark.parametrize("seed,n_valid", [(0, 20), (1, 32), (2, 7), (3, 0)])
def test_integrate(seed, n_valid):
    args = _window(seed, n_valid)
    j = jax.jit(jp.integrate)(*map(jnp.asarray, args))
    t = tp.integrate(*map(torch.from_numpy, args))
    _assert_state(t, j)
    ja = jax.jit(jp.integrate_assoc)(*map(jnp.asarray, args))
    ta = tp.integrate_assoc(*map(torch.from_numpy, args))
    for f in jp.PreintState._fields:
        tv, av = getattr(t, f).numpy(), getattr(ta, f).numpy()
        scale = max(np.abs(av).max(), 1e-30)
        bound = 1e-5 * scale
        if f in ASSOC_APART:
            bound += np.abs(np.asarray(getattr(j, f)) - np.asarray(getattr(ja, f))).max()
        assert np.abs(tv - av).max() <= bound, (f, np.abs(tv - av).max(), bound)


def test_information_9():
    args = _window(5, 24)
    j = jax.jit(jp.integrate)(*map(jnp.asarray, args))
    t = tp.integrate(*map(torch.from_numpy, args))
    ji = np.asarray(jax.jit(jp.information_9)(j))
    ti = tp.information_9(t).numpy()
    assert ti.shape == (9, 9) and ti.dtype == np.float32
    np.testing.assert_allclose(ti, ji, rtol=1e-4, atol=1e-4 * np.abs(ji).max())
