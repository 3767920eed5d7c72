"""The port's entry points (orbslam3_tpu_torch/entry.py) against the repo's
JAX entry points (__graft_entry__.py) on the CPU: entry() builds the same
map and inputs from the same numpy generator (exact) and its tracking step
gives the same pose within 1e-5 and the same inlier count; the global-BA
problem of dryrun_multichip is the JAX dryrun's draw for draw, and
dryrun_multichip(2) runs over two gloo ranks and a two-session fleet and
prints both lines."""
import jax
import numpy as np
import torch

import __graft_entry__ as graft
from orbslam3_tpu_torch import entry as tentry
import torch_parity  # noqa: F401  (one intra-op thread)


def _leaves(t):
    if isinstance(t, (tuple, list)):
        return [x for e in t for x in _leaves(e)]
    return [t]


def test_entry_against_jax():
    jfn, jargs = graft.entry()
    tfn, targs = tentry.entry(device="cpu")
    for a, b in zip(_leaves(jargs), _leaves(targs)):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    jq, jp, jn = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    tq, tp, tn = [x.numpy() for x in tfn(*targs)]
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert tn.dtype == jn.dtype and int(tn) == int(jn)


def test_dryrun_problem_is_the_jax_draw(monkeypatch):
    """The JAX dryrun's global-BA inputs, caught at its solver call."""
    from orbslam3_tpu.parallel import distributed_ba as jdba

    seen = {}

    def catch(mesh, pts, q, p, opt, cam, iters=10, **k):
        seen.update({f: np.asarray(getattr(pts, f)) for f in pts._fields},
                    q=np.asarray(q), p=np.asarray(p), opt_cam=np.asarray(opt))
        raise KeyboardInterrupt  # stop before the fleet half

    monkeypatch.setattr(jdba, "distributed_global_ba", catch)
    try:
        graft.dryrun_multichip(2)
    except KeyboardInterrupt:
        pass
    prob = tentry.gba_dryrun_problem(2, np.random.default_rng(1))
    assert set(seen) == set(prob) - {"cam"}
    for k, v in seen.items():
        assert prob[k].dtype == v.dtype, k
        np.testing.assert_array_equal(prob[k], v, err_msg=k)


def test_dryrun_multichip_on_the_cpu(capsys):
    tentry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "dryrun_multichip(2): distributed BA step OK over 2 ranks (gloo, cpu)"
    assert out[1] == "dryrun_multichip(2): full slam_step x2 sessions OK over ['cpu']"
