"""Torch port of the visual-inertial initialization against the JAX
package on the fixture of tests/test_imu_init.py (a constant-rate,
constant-acceleration trajectory, 9 keyframes 0.5 s apart, preintegrations
that carry a known gyro and accelerometer bias): gravity within 1e-3 m/s^2,
gyro bias 1e-5, velocities 1e-3, with the first-initialization prior and
with the two refinement prior scales."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.geometry import quat
from orbslam3_tpu.imu import preintegration as pre
from orbslam3_tpu.optim import imu_init as jii
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.optim import imu_init as tii
from tests.test_imu import make_const_motion_imu
from torch_parity import tensor

W = 9


@pytest.fixture(scope="module")
def window():
    w = np.array([0.25, -0.15, 0.3], np.float32)
    a_w = np.array([0.4, 0.2, -0.3], np.float32)
    q0 = quat.from_axis_angle(jnp.asarray([0.3, 0.1, -0.2]))
    v0 = jnp.asarray([0.2, -0.1, 0.3])
    bg_true = jnp.asarray([0.004, -0.003, 0.005])
    ba_true = jnp.asarray([0.04, -0.03, 0.05])
    kf_dt = 0.5
    rng = np.random.default_rng(2)
    qs = [quat.mul(q0, quat.from_axis_angle(jnp.asarray(w) * (k * kf_dt))) for k in range(W)]
    # centimetre-level pose noise, as visual odometry leaves
    ps = [v0 * (k * kf_dt) + 0.5 * jnp.asarray(a_w) * (k * kf_dt) ** 2
          + jnp.asarray(rng.normal(0, 0.005, 3).astype(np.float32)) for k in range(W)]
    preints = []
    for k in range(W - 1):
        gyro, acc, dts, mask = make_const_motion_imu(w, a_w, qs[k], None, n=100, hz=200.0)
        preints.append(pre.integrate(gyro + bg_true[None], acc + ba_true[None], dts, mask,
                                     jnp.zeros(3), jnp.zeros(3)))
    preints = jax.tree.map(lambda *xs: jnp.stack(xs), *preints)
    v_true = np.stack([np.asarray(v0 + jnp.asarray(a_w) * (k * kf_dt)) for k in range(W)])
    return jax.tree.map(np.asarray, (jnp.stack(qs), jnp.stack(ps), preints)), v_true, bg_true


def _both(window, edge_valid, **kw):
    (qs, ps, preints), _, _ = window
    jres = jii.inertial_init(jnp.asarray(qs), jnp.asarray(ps), jax.tree.map(jnp.asarray, preints),
                             jnp.asarray(edge_valid),
                             **{k: jnp.float32(v) for k, v in kw.items()})
    tres = tii.inertial_init(tensor(qs), tensor(ps), from_numpy_tree(preints), tensor(edge_valid),
                             **kw)
    return jres, tres


def _check(tres, jres):
    np.testing.assert_allclose(tres.gravity_w.numpy(), np.asarray(jres.gravity_w), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tres.bias_g.numpy(), np.asarray(jres.bias_g), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tres.bias_a.numpy(), np.asarray(jres.bias_a), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.vels.numpy(), np.asarray(jres.vels), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0), rtol=1e-4)
    np.testing.assert_allclose(float(tres.cost1), float(jres.cost1), rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("prior_scale", [1.0, 0.3, 0.02])
def test_inertial_init(window, prior_scale):
    kw = {} if prior_scale == 1.0 else dict(prior_scale=prior_scale)
    jres, tres = _both(window, np.ones(W - 1, bool), **kw)
    assert type(from_numpy_tree(jax.tree.map(np.asarray, jres))).__name__ == "ImuInitResult"
    assert float(jres.cost1) < float(jres.cost0) * 1e-2
    _check(tres, jres)
    _, v_true, bg_true = window
    np.testing.assert_allclose(tres.gravity_w.numpy(), [0.0, 0.0, -9.81], atol=0.1)
    np.testing.assert_allclose(tres.bias_g.numpy(), np.asarray(bg_true), atol=2e-3)
    np.testing.assert_allclose(tres.vels.numpy(), v_true, atol=0.08)


def test_inertial_init_masked_edges(window):
    """The padded window of the host service: leading edges masked out."""
    ev = np.ones(W - 1, bool)
    ev[:3] = False
    jres, tres = _both(window, ev)
    _check(tres, jres)
    # velocities of rows no valid edge touches stay at zero
    np.testing.assert_allclose(tres.vels.numpy()[:3], 0.0, atol=1e-6)
