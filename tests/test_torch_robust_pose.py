"""Torch port of the 3D-3D RANSAC pose against the JAX package: the triples
`jax.random.randint` draws are fed to the port as `draws`, so both score the
same hypotheses. Inlier mask exact, pose within 1e-5; fewer than 3 valid
correspondences give the identity pose and 0 inliers; with a generator two
calls seeded alike agree and the pose is still found."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.geometry import quat as jq
from orbslam3_tpu.optim import robust_pose as jrp
from orbslam3_tpu_torch.optim import robust_pose as trp
from torch_parity import tensor

BF, FX = 458.0 * 0.11, 458.0
N = 384


def _scene(seed, outlier_frac, n_valid=None, noise=0.004):
    rng = np.random.default_rng(seed)
    q_wb = np.asarray(jq.normalize(jnp.asarray(rng.normal(0, 1, 4).astype(np.float32))))
    p_wb = rng.normal(0, 2.0, 3).astype(np.float32)
    Xb = rng.uniform([-3, -2, 1.0], [3, 2, 9.0], (N, 3)).astype(np.float32)
    Xw = np.asarray(jq.rotate(jnp.asarray(q_wb)[None], jnp.asarray(Xb))) + p_wb
    Xb = Xb + rng.normal(0, noise, (N, 3)).astype(np.float32)
    bad = rng.random(N) < outlier_frac
    Xw = np.where(bad[:, None], Xw + rng.normal(0, 1.5, (N, 3)), Xw).astype(np.float32)
    valid = rng.random(N) < 0.6
    if n_valid is not None:
        valid[:] = False
        valid[rng.choice(N, n_valid, replace=False)] = True
    return Xw, Xb, valid, q_wb, p_wb


def _jax(Xw, Xb, valid, key, n_hyp):
    out = jrp.robust_pose_3d3d(jnp.asarray(Xw), jnp.asarray(Xb), jnp.asarray(valid), key,
                               jnp.float32(BF), jnp.float32(FX), n_hyp=n_hyp)
    draws = jax.random.randint(key, (n_hyp, 3), 0, max(int(valid.sum()), 1))
    return jax.tree.map(np.asarray, out), np.asarray(draws)


@pytest.mark.parametrize("seed,outliers,n_hyp", [(0, 0.3, 128), (1, 0.6, 128), (2, 0.0, 16),
                                                 (3, 0.5, 64)])
def test_robust_pose_same_draws(seed, outliers, n_hyp):
    Xw, Xb, valid, q_true, p_true = _scene(seed, outliers)
    key = jax.random.fold_in(jax.random.PRNGKey(17), seed)
    (jq_, jp, jinl, jn), draws = _jax(Xw, Xb, valid, key, n_hyp)
    tq, tp, tinl, tn = trp.robust_pose_3d3d(tensor(Xw), tensor(Xb), tensor(valid),
                                            tensor(np.float32(BF)), tensor(np.float32(FX)),
                                            draws=tensor(draws))
    assert int(jn) > 0.3 * valid.sum()
    np.testing.assert_array_equal(tinl.numpy(), jinl)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tq.numpy(), jq_, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), p_true, atol=0.05)


@pytest.mark.parametrize("n_valid", [0, 2])
def test_robust_pose_too_few(n_valid):
    Xw, Xb, valid, _, _ = _scene(5, 0.0, n_valid=n_valid)
    key = jax.random.PRNGKey(3)
    (jq_, jp, jinl, jn), draws = _jax(Xw, Xb, valid, key, 32)
    for kw in (dict(draws=tensor(draws)), dict(generator=torch.Generator().manual_seed(1))):
        tq, tp, tinl, tn = trp.robust_pose_3d3d(tensor(Xw), tensor(Xb), tensor(valid),
                                                tensor(np.float32(BF)), tensor(np.float32(FX)),
                                                n_hyp=32, **kw)
        assert int(tn) == int(jn) == 0 and not tinl.any() and not jinl.any()
        np.testing.assert_array_equal(tq.numpy(), [1, 0, 0, 0])
        np.testing.assert_array_equal(tq.numpy(), jq_)
        np.testing.assert_array_equal(tp.numpy(), jp)


def test_robust_pose_generator():
    Xw, Xb, valid, q_true, p_true = _scene(7, 0.4)
    args = (tensor(Xw), tensor(Xb), tensor(valid), tensor(np.float32(BF)), tensor(np.float32(FX)))
    a = trp.robust_pose_3d3d(*args, generator=torch.Generator().manual_seed(11))
    b = trp.robust_pose_3d3d(*args, generator=torch.Generator().manual_seed(11))
    c = trp.robust_pose_3d3d(*args, generator=torch.Generator().manual_seed(12))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for r in (a, c):
        assert int(r[3]) > 0.4 * valid.sum()
        np.testing.assert_allclose(r[1].numpy(), p_true, atol=0.05)
        assert abs(float(np.abs(np.dot(r[0].numpy(), q_true))) - 1.0) < 1e-4
