"""Torch port of geometry/so3.py and geometry/quat.py against the JAX
functions on random batches, near-zero angles included (1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.geometry import quat as jq
from orbslam3_tpu.geometry import so3 as js
from orbslam3_tpu_torch.geometry import quat as tq
from orbslam3_tpu_torch.geometry import so3 as ts

TOL = dict(rtol=1e-6, atol=1e-6)


def _rotvecs(seed):
    """Random rotation vectors, |w| < 3, with exact zeros and tiny angles on
    both sides of the small-angle switches (1e-6 rad for so3, 1e-12 rad^2
    for quat)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(48, 3))
    nrm = np.linalg.norm(w, axis=-1, keepdims=True)
    w = np.where(nrm > 3.0, w * (3.0 / nrm), w)
    scales = np.array([0.0, 1e-9, 1e-7, 5e-7, 2e-6, 1e-5, 1e-3, 1e-1])
    w[: len(scales)] = w[: len(scales)] / np.linalg.norm(w[: len(scales)], axis=-1,
                                                         keepdims=True) * scales[:, None]
    return w.astype(np.float32)


def _quats(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(48, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _cmp(jfn, tfn, *args):
    j = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    t = tfn(*[torch.from_numpy(np.array(a)) for a in args]).numpy()
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t, j, **TOL)


SO3_FNS = ["hat", "exp_matrix", "right_jacobian", "right_jacobian_inv"]


@pytest.mark.parametrize("name", SO3_FNS)
@pytest.mark.parametrize("seed", [0, 1])
def test_so3_of_rotvec(name, seed):
    _cmp(getattr(js, name), getattr(ts, name), _rotvecs(seed))


@pytest.mark.parametrize("name", ["matrix_to_quat", "log_matrix", "vee"])
def test_so3_of_matrix(name):
    R = np.asarray(js.exp_matrix(jnp.asarray(_rotvecs(3))))
    _cmp(getattr(js, name), getattr(ts, name), R)


@pytest.mark.parametrize("name", ["normalize", "conj", "to_axis_angle", "to_matrix"])
def test_quat_unary(name):
    q = _quats(4)
    q[:4] = [[1, 0, 0, 0], [-1, 0, 0, 0], [1, 1e-8, 0, 0], [0.0, 1.0, 0.0, 0.0]]
    _cmp(getattr(jq, name), getattr(tq, name), q)


def test_quat_from_axis_angle():
    _cmp(jq.from_axis_angle, tq.from_axis_angle, _rotvecs(5))


def test_quat_mul_rotate():
    q1, q2 = _quats(6), _quats(7)
    v = np.random.default_rng(8).normal(size=(48, 3)).astype(np.float32)
    _cmp(jq.mul, tq.mul, q1, q2)
    _cmp(jq.rotate, tq.rotate, q1, v)


def test_quat_from_matrix_and_numpy_helpers():
    R = np.asarray(jq.to_matrix(jnp.asarray(_quats(9))))
    _cmp(jq.from_matrix, tq.from_matrix, R)
    q64 = _quats(10).astype(np.float64)
    np.testing.assert_array_equal(tq.to_matrix_np(q64), jq.to_matrix_np(q64))
    for Rm in tq.to_matrix_np(q64):
        np.testing.assert_array_equal(tq.from_matrix_np(Rm), jq.from_matrix_np(Rm))


def test_identity():
    np.testing.assert_array_equal(tq.identity((3,)).numpy(), np.asarray(jq.identity((3,))))
