"""SE3 and Sim3 of the port against the JAX package: the cases of
tests/test_geometry.py (TestSE3, TestSim3) with the same numpy-seeded inputs
through both, every result within 1e-6 absolute plus 1e-6 relative (one
float32 ulp of a coordinate of 10 m is 1e-6; the logs, which divide by small
angles, 1e-5); small angles, pure scale, batched and single
transforms; and the dtype of a forward-mode Jacobian through a 0-d scale."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.geometry import quat as jquat
from orbslam3_tpu.geometry.se3 import SE3 as JSE3
from orbslam3_tpu.geometry.sim3 import Sim3 as JSim3
from orbslam3_tpu_torch.geometry import quat as tquat
from orbslam3_tpu_torch.geometry.se3 import SE3 as TSE3
from orbslam3_tpu_torch.geometry.sim3 import Sim3 as TSim3
from orbslam3_tpu_torch.interop import from_numpy_tree, to_numpy_tree
from torch_parity import tensor

TOL = 1e-6


def rng():
    return np.random.default_rng(5)


def rand_w(r, n, scale):
    return (r.normal(size=(n, 3)) * scale).astype(np.float32)


def both_se3(r, n=8):
    w, t = rand_w(r, n, 1.0), rand_w(r, n, 2.0)
    return (JSE3(jquat.from_axis_angle(jnp.asarray(w)), jnp.asarray(t)),
            TSE3(tquat.from_axis_angle(tensor(w)), tensor(t)))


def both_sim3(r, n=8):
    w, t = rand_w(r, n, 1.0), rand_w(r, n, 2.0)
    s = np.exp(r.normal(size=n) * 0.3).astype(np.float32)
    return (JSim3(jquat.from_axis_angle(jnp.asarray(w)), jnp.asarray(t), jnp.asarray(s)),
            TSim3(tquat.from_axis_angle(tensor(w)), tensor(t), tensor(s)))


def close(t, j, atol=TOL):
    """Port result (tensor or NamedTuple of tensors) against the JAX one."""
    if hasattr(j, "_fields"):
        for f in j._fields:
            close(getattr(t, f), getattr(j, f), atol)
        return
    tv, jv = t.numpy(), np.asarray(j)
    assert tv.dtype == jv.dtype == np.float32 and tv.shape == jv.shape, (tv.shape, jv.shape)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=atol)


class TestSE3:
    def test_compose_inverse(self):
        J, T = both_se3(rng())
        close(T.compose(T.inverse()), J.compose(J.inverse()))
        close(T.inverse(), J.inverse())
        Iq = T.compose(T.inverse())
        np.testing.assert_allclose(Iq.t.numpy(), 0.0, atol=1e-5)

    def test_apply_and_matrix(self):
        r = rng()
        J, T = both_se3(r)
        x = rand_w(r, 8, 2.0)
        close(T.apply(tensor(x)), J.apply(jnp.asarray(x)))
        close(T.matrix(), J.matrix())
        close(T.rotation_matrix(), J.rotation_matrix())

    @pytest.mark.parametrize("scale", [1.0, 1e-4, 0.0], ids=["generic", "small", "zero"])
    def test_exp_log(self, scale):
        r = rng()
        xi = r.normal(size=(8, 6)).astype(np.float32)
        nrm = np.linalg.norm(xi[:, 3:6], axis=-1, keepdims=True)
        xi[:, 3:6] = np.where(nrm > 2.8, xi[:, 3:6] * (2.8 / nrm), xi[:, 3:6]) * scale
        J, T = JSE3.exp(jnp.asarray(xi)), TSE3.exp(tensor(xi))
        close(T, J)
        close(T.log(), J.log(), atol=1e-5)
        np.testing.assert_allclose(T.log().numpy(), xi, atol=1e-4)

    def test_retract_local(self):
        r = rng()
        J, T = both_se3(r)
        xi = (r.normal(size=(8, 6)) * 1e-3).astype(np.float32)
        J2, T2 = J.retract(jnp.asarray(xi)), T.retract(tensor(xi))
        close(T2, J2)
        close(T.local(T2), J.local(J2))
        np.testing.assert_allclose(T.local(T2).numpy(), xi, atol=1e-5)

    def test_from_matrix_and_single(self):
        J, T = both_se3(rng())
        close(TSE3.from_matrix(T.matrix()).matrix(), JSE3.from_matrix(J.matrix()).matrix())
        # one transform, no batch axis
        J0, T0 = JSE3(J.q[0], J.t[0]), TSE3(T.q[0], T.t[0])
        close(T0.compose(T0).log(), J0.compose(J0).log(), atol=1e-5)
        close(TSE3.identity((2,)), JSE3.identity((2,)))


class TestSim3:
    def test_compose_inverse(self):
        J, T = both_sim3(rng())
        close(T.inverse(), J.inverse())
        close(T.compose(T.inverse()), J.compose(J.inverse()))
        np.testing.assert_allclose(T.compose(T.inverse()).s.numpy(), 1.0, atol=1e-5)

    def test_apply_composition(self):
        r = rng()
        (J1, T1), (J2, T2) = both_sim3(r), both_sim3(r)
        x = rand_w(r, 8, 2.0)
        close(T1.compose(T2).apply(tensor(x)), J1.compose(J2).apply(jnp.asarray(x)))
        close(T1.apply(T2.apply(tensor(x))), J1.apply(J2.apply(jnp.asarray(x))))

    @pytest.mark.parametrize("case", ["generic", "small_theta", "small_sigma", "both_small",
                                      "zero"])
    def test_exp_log(self, case):
        xi = (rng().normal(size=(16, 7)) * 0.5).astype(np.float32)
        if case in ("small_theta", "both_small"):
            xi[:, 3:6] *= 1e-6
        if case in ("small_sigma", "both_small"):
            xi[:, 6] *= 1e-6
        if case == "zero":
            xi[:] = 0.0
        J, T = JSim3.exp(jnp.asarray(xi)), TSim3.exp(tensor(xi))
        close(T, J)
        close(T.log(), J.log(), atol=1e-5)
        np.testing.assert_allclose(T.log().numpy(), xi, atol=1e-3)

    def test_exp_pure_scale(self):
        xi = np.zeros((1, 7), np.float32)
        xi[:, 6] = 0.7
        close(TSim3.exp(tensor(xi)), JSim3.exp(jnp.asarray(xi)))
        np.testing.assert_allclose(TSim3.exp(tensor(xi)).s.numpy(), np.exp(0.7), rtol=1e-5)

    def test_se3_consistency_and_retract(self):
        r = rng()
        xi6 = (r.normal(size=(8, 6)) * 0.5).astype(np.float32)
        xi7 = np.concatenate([xi6, np.zeros((8, 1), np.float32)], -1)
        S, T = TSim3.exp(tensor(xi7)), TSE3.exp(tensor(xi6))
        np.testing.assert_allclose(S.t.numpy(), T.t.numpy(), atol=1e-4)
        np.testing.assert_allclose(S.q.numpy(), T.q.numpy(), atol=1e-5)
        J, P = both_sim3(r)
        d = (r.normal(size=(8, 7)) * 0.1).astype(np.float32)
        close(P.retract(tensor(d)), J.retract(jnp.asarray(d)))
        close(TSim3.from_se3(T).to_se3(), JSim3.from_se3(JSE3.exp(jnp.asarray(xi6))).to_se3())

    def test_single_transform_and_interop(self):
        J, T = both_sim3(rng())
        J0, T0 = JSim3(J.q[0], J.t[0], J.s[0]), TSim3(T.q[0], T.t[0], T.s[0])
        assert T0.s.dim() == 0
        close(T0.compose(T0.inverse()).log(), J0.compose(J0.inverse()).log(), atol=1e-5)
        close(T0.log(), J0.log(), atol=1e-5)
        back = from_numpy_tree(JSim3(*[np.asarray(a) for a in J]))
        assert type(back) is TSim3 and torch.equal(back.s, T.s)
        assert type(to_numpy_tree(T)) is TSim3 and isinstance(to_numpy_tree(T).q, np.ndarray)

    def test_jacobian_through_a_0d_scale_stays_float32(self):
        """Forward-mode Jacobian of a residual through one Sim3 (0-d scale):
        float32, and equal to the JAX package's."""
        import jax

        J, T = both_sim3(rng())
        J0, T0 = JSim3(J.q[0], J.t[0], J.s[0]), TSim3(T.q[0], T.t[0], T.s[0])
        J1, T1 = JSim3(J.q[1], J.t[1], J.s[1]), TSim3(T.q[1], T.t[1], T.s[1])
        ft = lambda d: T0.retract(d).inverse().compose(T1).log()  # noqa: E731
        fj = lambda d: J0.retract(d).inverse().compose(J1).log()  # noqa: E731
        jt = torch.func.jacfwd(ft)(torch.zeros(7))
        assert jt.dtype == torch.float32 and jt.shape == (7, 7)
        np.testing.assert_allclose(jt.numpy(), np.asarray(jax.jacfwd(fj)(jnp.zeros(7))),
                                   rtol=2e-5, atol=2e-5)
