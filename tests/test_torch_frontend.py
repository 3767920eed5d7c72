"""Torch port of the ORB + stereo front end against the JAX package on one
HARD_WORLD frame at 384x256 with 4 pyramid levels.

Level 0 is the integer image, so its FAST responses match exactly. The
higher levels are not bit-identical: jax.image.resize computes its weights
inside the jitted program, and XLA:CPU's fused code rounds some sample
positions half an ulp differently from any formula the port can write
down, so a few weight columns differ and levels deviate by up to ~1e-3 on
the 0..255 scale. Responses on levels >= 1 are therefore compared to 1e-2;
every keypoint position, octave and validity still matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend import orb as jorb
from orbslam3_tpu.frontend import stereo as jst
from orbslam3_tpu.io.synthetic import SyntheticConfig as JCfg
from orbslam3_tpu.io.synthetic import SyntheticWorld as JWorld
from orbslam3_tpu.ops import hamming as jham
from orbslam3_tpu.ops import pyramid as jpyr
from orbslam3_tpu_torch.frontend import orb as torb
from orbslam3_tpu_torch.frontend import stereo as tst
from orbslam3_tpu_torch.io.synthetic import SyntheticConfig as TCfg
from orbslam3_tpu_torch.io.synthetic import SyntheticWorld as TWorld
from orbslam3_tpu_torch.ops import hamming as tham
from orbslam3_tpu_torch.ops import pyramid as tpyr

HARD_WORLD = dict(texture="textured", exposure_drift=0.3, image_noise_std=3.0,
                  salt_pepper_frac=0.002, motion_blur_samples=3, exposure_time=0.02)
SMALL = dict(width=384, height=256, fx=240.0, fy=240.0, n_landmarks=600, duration=2.0,
             cam_hz=10.0, pos_amp=(1.2, 0.8, 0.3), **HARD_WORLD)
LEVELS = 4


@pytest.fixture(scope="module")
def frame():
    jw, tw = JWorld(JCfg(**SMALL)), TWorld(TCfg(**SMALL))
    jl, jr = jw.render_frame(0.5)
    tl, tr = tw.render_frame(0.5)
    np.testing.assert_array_equal(tl, jl)  # the port's world renders the same pixels
    np.testing.assert_array_equal(tr, jr)
    left = jl.astype(np.uint8).astype(np.float32)
    right = jr.astype(np.uint8).astype(np.float32)
    jcfg = jorb.OrbConfig(n_features=384, n_levels=LEVELS)
    tcfg = torb.OrbConfig(n_features=384, n_levels=LEVELS)
    fj = jax.tree.map(np.asarray, jorb.detect_orb_pair(jnp.asarray(left), jnp.asarray(right), jcfg))
    ft = torb.detect_orb_pair(torch.from_numpy(left), torch.from_numpy(right), tcfg)
    ft = [torb.Features(*[x.numpy() for x in f]) for f in ft]
    return dict(left=left, right=right, fj=fj, ft=ft, jcam=jw.cam, tcam=tw.cam)


def test_build_pyramid(frame):
    jl = jax.jit(lambda x: jpyr.build_pyramid(x, LEVELS, 1.2))(jnp.asarray(frame["left"]))
    tl = tpyr.build_pyramid(torch.from_numpy(frame["left"]), LEVELS, 1.2)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
    for a, b in zip(jl[1:], tl[1:]):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-3)


def test_blur(frame):
    x = frame["left"]
    np.testing.assert_allclose(tpyr.blur(torch.from_numpy(x)[None])[0].numpy(),
                               np.asarray(jax.jit(jpyr.blur)(jnp.asarray(x))), rtol=0, atol=1e-4)


@pytest.mark.parametrize("side", [0, 1], ids=["left", "right"])
def test_detect_orb_pair(frame, side):
    j, t = frame["fj"][side], frame["ft"][side]
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


def test_hamming_matrix(frame):
    a, b = frame["fj"][0].desc, frame["fj"][1].desc
    np.testing.assert_array_equal(tham.hamming_matrix(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))).numpy(),
                                  np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


def test_match_stereo(frame):
    # both sides match the SAME features (the JAX ones), so the comparison
    # isolates match_stereo from descriptor bit flips
    fj = frame["fj"]
    ft = [torb.Features(*[torch.from_numpy(np.array(x)) for x in f]) for f in fj]
    ju, jd, jh = [np.asarray(x) for x in
                  jst.match_stereo(fj[0], fj[1], frame["jcam"], jst.StereoConfig())]
    tu, td, th = [x.numpy() for x in tst.match_stereo(ft[0], ft[1], frame["tcam"], tst.StereoConfig())]
    np.testing.assert_array_equal(th, jh)
    assert jh.sum() > 50
    np.testing.assert_allclose(tu, ju, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
