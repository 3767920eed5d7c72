"""Torch port of IMU preintegration against the JAX package on a seeded
window with a padded tail: integrate_assoc, merge and propagate. Deltas and
the 15x15 covariance within 1e-5 relative (the two packages associate the
float32 merge products differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.imu import preintegration as jp
from orbslam3_tpu_torch.imu import preintegration as tp

FIELDS = jp.PreintState._fields


def _window(seed, n_valid, n=32):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 0.5, (n_valid, 3)).astype(np.float32)
    a = (rng.normal(0, 1.0, (n_valid, 3)) + [0, 0, 9.81]).astype(np.float32)
    d = np.full(n_valid, 0.005, np.float32)
    return jp.pad_imu_window(g, a, d, n)


def _bias(seed):
    rng = np.random.default_rng(seed + 100)
    return rng.normal(0, 0.01, 3).astype(np.float32), rng.normal(0, 0.05, 3).astype(np.float32)


def _assert_state(t, j):
    for f in FIELDS:
        tv, jv = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, f
        scale = max(np.abs(jv).max(), 1e-30)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * scale, err_msg=f)


def _integrate(seed, n_valid):
    g, a, d, m = _window(seed, n_valid)
    bg, ba = _bias(seed)
    j = jax.jit(jp.integrate_assoc)(*map(jnp.asarray, (g, a, d, m, bg, ba)))
    t = tp.integrate_assoc(*map(torch.from_numpy, (g, a, d, m, bg, ba)))
    return j, t


@pytest.mark.parametrize("seed,n_valid", [(0, 20), (1, 32), (2, 7), (3, 0)])
def test_integrate_assoc(seed, n_valid):
    j, t = _integrate(seed, n_valid)
    _assert_state(t, j)


def test_pad_imu_window():
    rng = np.random.default_rng(5)
    g, a, d = rng.normal(size=(40, 3)), rng.normal(size=(40, 3)), np.full(40, 0.005)
    for k in (0, 9, 40):
        for x, y in zip(tp.pad_imu_window(g[:k], a[:k], d[:k], 32),
                        jp.pad_imu_window(g[:k], a[:k], d[:k], 32)):
            np.testing.assert_array_equal(x, y)


def test_merge_and_propagate():
    j1, t1 = _integrate(10, 25)
    j2, t2 = _integrate(11, 18)
    _assert_state(tp.merge(t1, t2), jax.jit(jp.merge)(j1, j2))
    rng = np.random.default_rng(12)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    v, p = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    bg, ba = _bias(13)
    grav = np.array([0.1, -0.2, -9.8], np.float32)
    jo = jax.jit(jp.propagate)(j1, *map(jnp.asarray, (q, v, p, bg, ba, grav)))
    to = tp.propagate(t1, *map(torch.from_numpy, (q, v, p, bg, ba)), gravity_w=torch.from_numpy(grav))
    for x, y in zip(to, jo):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
