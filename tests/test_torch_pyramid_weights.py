"""The port's resize weights against the ones XLA:CPU's compiled program
builds for `jax.image.resize(..., "bilinear")`.

The JAX weight matrix is read bit for bit by resizing an identity matrix
along one axis: each output is a product with a one-hot column, which is
exact. Every level transition of the 8-level, 1.2-scale pyramids of
480x752, 240x376 and 256x384 images is checked, along both axes, entry for
entry.

Only the weights are held here. The levels themselves still differ in a few
pixels: XLA:CPU's runtime matrix product sums the (at most four) taps of an
output in an order of its own choosing for each shape (split over its
blocks of the contraction, or lane by lane and then pairwise), which the
port's fused multiply-add chain in tap order does not follow
(`test_torch_frontend.py::test_build_pyramid` holds the levels)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.ops import pyramid as jpyr
from orbslam3_tpu_torch.ops import pyramid as tpyr


def _transitions():
    out = set()
    for h, w in [(480, 752), (240, 376), (256, 384)]:
        shapes = tpyr.level_shapes(h, w, 8, 1.2)
        for (h0, w0), (h1, w1) in zip(shapes, shapes[1:]):
            out.add((h0, h1))
            out.add((w0, w1))
    return sorted(out)


TRANSITIONS = _transitions()


def _jax_weights(m: int, n: int) -> np.ndarray:
    """(m, n): the weight of input m_i in output n_j, as XLA:CPU builds it."""
    out = jax.jit(lambda x: jpyr.resize_bilinear(x, (n, m)))(jnp.eye(m, dtype=jnp.float32))
    return np.asarray(out).T


def test_every_transition_is_listed():
    assert len(TRANSITIONS) == 42
    assert (480, 400) in TRANSITIONS and (752, 627) in TRANSITIONS and (103, 86) in TRANSITIONS


@pytest.mark.parametrize("m,n", TRANSITIONS, ids=[f"{m}to{n}" for m, n in TRANSITIONS])
def test_resize_weights_equal_xla(m, n):
    want = _jax_weights(m, n)
    got = tpyr._resize_weights_np(m, n)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("m,n", [(480, 400), (400, 333), (103, 86)])
def test_taps_carry_the_weights(m, n):
    """The (index, weight) taps the resample applies are the dense matrix's
    non-zero entries, in input order."""
    dense = tpyr._resize_weights_np(m, n)
    idx, wt = tpyr._resize_taps_np(m, n)
    rebuilt = np.zeros_like(dense)
    for j in range(n):
        for t in range(idx.shape[1]):
            if wt[j, t] != 0:
                rebuilt[idx[j, t], j] = wt[j, t]
    np.testing.assert_array_equal(rebuilt, dense)
    for j in range(n):
        assert (np.diff(idx[j][wt[j] != 0]) > 0).all()
