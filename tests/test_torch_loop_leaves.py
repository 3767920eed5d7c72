"""The leaf modules of loop closing in the port against the JAX package, on
the fixtures of tests/test_loop.py and tests/test_vocab_scale.py:

* loop/sim3.py: Horn's closed form (pose 1e-5) and both RANSACs fed the
  3-point samples the JAX function draws from its key (inlier masks and
  counts exact, pose 1e-5), a set of mostly degenerate samples, and the
  port's own sampler;
* loop/vocab.py: training (the same tree, exactly), leaf ids exact with tied
  children, dense BoW 1e-6, sparse BoW as sets sorted by id (1e-6),
  score_sparse_many 1e-6 with a leaf-0 entry and padded ids, score_l1, and
  the DBoW2 text format (files byte-equal, loaded trees equal, under-full
  nodes and early leaves);
* optim/pose_graph.py: nodes 1e-4 and costs 1e-4 relative (and 1e-4 of the
  first cost absolute) with fixed and with free scale, and two runs of the port bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.camera import Camera as JCamera
from orbslam3_tpu.geometry import quat as jquat
from orbslam3_tpu.geometry.sim3 import Sim3 as JSim3
from orbslam3_tpu.loop import sim3 as jl
from orbslam3_tpu.loop import vocab as jvb
from orbslam3_tpu.optim import pose_graph as jpg
from orbslam3_tpu_torch.geometry.sim3 import Sim3 as TSim3
from orbslam3_tpu_torch.interop import from_numpy_tree
from orbslam3_tpu_torch.loop import sim3 as tl
from orbslam3_tpu_torch.loop import vocab as tvb
from orbslam3_tpu_torch.optim import pose_graph as tpg
from torch_parity import port_camera, tensor

JCAM = JCamera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)


def np_tree(nt):
    """A JAX NamedTuple with numpy leaves (tuples of arrays and Python
    numbers kept), ready for interop.from_numpy_tree."""
    if hasattr(nt, "_fields"):
        return type(nt)(*[np_tree(v) for v in nt])
    if isinstance(nt, tuple):
        return tuple(np_tree(v) for v in nt)
    return nt if isinstance(nt, (int, float)) else np.asarray(nt)


def assert_pose_close(T: TSim3, J: JSim3, atol=1e-5):
    tq, jq = T.q.numpy(), np.asarray(J.q)
    np.testing.assert_allclose(tq * np.sign(tq[..., :1] * jq[..., :1] + 1e-12), jq, rtol=0,
                               atol=atol)
    np.testing.assert_allclose(T.t.numpy(), np.asarray(J.t), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(T.s.numpy(), np.asarray(J.s), rtol=1e-5, atol=atol)
    assert T.s.shape == tuple(np.asarray(J.s).shape) and T.s.dtype == torch.float32


# ---------------------------------------------------------------- Sim3
def correspondences(seed=21, N=120, scale=1.0, n_out=30):
    """The fixture of TestSim3Ransac: a known transform, 1 cm noise, 30 gross
    outliers."""
    r = np.random.default_rng(seed)
    pa = r.uniform(-5, 5, (N, 3)).astype(np.float32)
    S_true = JSim3(jquat.from_axis_angle(jnp.asarray([0.1, 0.3, -0.2])),
                   jnp.asarray([0.5, -1.0, 0.3]), jnp.asarray(scale, jnp.float32))
    pb = np.array(S_true.apply(jnp.asarray(pa)))
    pb += r.normal(0, 0.01, pb.shape)
    out = r.choice(N, n_out, replace=False)
    pb[out] += r.uniform(1, 3, (n_out, 3))
    return pa, pb.astype(np.float32), S_true


def jax_samples(key, valid, n_hyp):
    """The samples sim3_ransac draws from `key` (its own two lines)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.random.categorical(key, logits, shape=(n_hyp, 3)))


@pytest.mark.parametrize("fix_scale,scale,n", [(True, 1.0, 20), (False, 1.35, 40)],
                         ids=["rigid", "with_scale"])
def test_horn_weighted(fix_scale, scale, n):
    r = np.random.default_rng(3)
    pa = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    S_true = JSim3(jquat.from_axis_angle(jnp.asarray([0.2, -0.1, 0.4])),
                   jnp.asarray([1.0, 2.0, -0.5]), jnp.asarray(scale, jnp.float32))
    pb = np.asarray(S_true.apply(jnp.asarray(pa)))
    w = r.uniform(0.2, 1.0, n).astype(np.float32)
    J = jl.horn_weighted(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w), fix_scale)
    T = tl.horn_weighted(tensor(pa), tensor(pb), tensor(w), fix_scale)
    assert_pose_close(T, J)
    np.testing.assert_allclose(T.t.numpy(), np.asarray(S_true.t), atol=1e-4)
    assert abs(float(T.s) - scale) < 1e-4
    # a batch of weightings is the fits one by one
    W = r.uniform(0.2, 1.0, (5, n)).astype(np.float32)
    Tb = tl.horn_weighted(tensor(pa), tensor(pb), tensor(W), fix_scale)
    for i in range(5):
        assert_pose_close(TSim3(*[a[i] for a in Tb]),
                          jl.horn_weighted(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(W[i]),
                                           fix_scale))


@pytest.mark.parametrize("fix_scale,scale", [(True, 1.0), (False, 1.2)], ids=["rigid", "scale"])
def test_sim3_ransac_on_fed_samples(fix_scale, scale):
    pa, pb, S_true = correspondences(scale=scale)
    valid = np.ones(len(pa), bool)
    valid[::17] = False
    key = jax.random.PRNGKey(0)
    J, j_inl, j_n = jl.sim3_ransac(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key,
                                   n_hyp=64, inlier_thr=0.1, fix_scale=fix_scale)
    T, t_inl, t_n = tl.sim3_ransac(tensor(pa), tensor(pb), tensor(valid),
                                   samples=tensor(jax_samples(key, valid, 64)), inlier_thr=0.1,
                                   fix_scale=fix_scale)
    np.testing.assert_array_equal(t_inl.numpy(), np.asarray(j_inl))
    assert int(t_n) == int(j_n) > 60 and t_n.dtype == torch.int32
    assert_pose_close(T, J)
    np.testing.assert_allclose(T.t.numpy(), np.asarray(S_true.t), atol=0.03)


def test_sim3_ransac_degenerate_samples():
    """Five valid rows: most 3-point samples repeat a row (a rank-1
    covariance, whose rotation is free), a few are proper. The winner, its
    inlier mask and count are the JAX package's."""
    pa, pb, _ = correspondences(n_out=0)
    valid = np.zeros(len(pa), bool)
    valid[[3, 40, 41, 77, 100]] = True
    key = jax.random.PRNGKey(4)
    samples = jax_samples(key, valid, 32)
    n_rep = sum(len(set(s)) < 3 for s in samples.tolist())
    assert 8 <= n_rep < 32, n_rep
    J, j_inl, j_n = jl.sim3_ransac(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key,
                                   n_hyp=32, inlier_thr=0.1)
    T, t_inl, t_n = tl.sim3_ransac(tensor(pa), tensor(pb), tensor(valid), samples=tensor(samples),
                                   inlier_thr=0.1)
    np.testing.assert_array_equal(t_inl.numpy(), np.asarray(j_inl))
    assert int(t_n) == int(j_n) == 5
    assert_pose_close(T, J, atol=1e-4)
    # every sample on one row: no hypothesis has an inlier to offer beyond chance, none raises
    T2, inl2, n2 = tl.sim3_ransac(tensor(pa), tensor(pb), tensor(valid),
                                  samples=torch.full((8, 3), 40), inlier_thr=0.1)
    assert torch.isfinite(T2.t).all() and int(n2) == int(inl2.sum())


def test_sim3_ransac_reproj_on_fed_samples():
    r = np.random.default_rng(8)
    N = 150
    pa = np.stack([r.uniform(-2, 2, N), r.uniform(-1.5, 1.5, N), r.uniform(3, 9, N)], -1)
    pa = pa.astype(np.float32)
    S_true = JSim3(jquat.from_axis_angle(jnp.asarray([0.02, 0.1, -0.03])),
                   jnp.asarray([0.3, -0.1, 0.2]), jnp.ones(()))
    pb = np.array(S_true.apply(jnp.asarray(pa)), np.float32)
    pb[::7] += r.uniform(0.5, 1.5, (len(pb[::7]), 3)).astype(np.float32)
    uv_a = np.asarray(JCAM.project_body(jnp.asarray(pa))[0]) + r.normal(0, 0.3, (N, 2))
    uv_b = np.asarray(JCAM.project_body(S_true.apply(jnp.asarray(pa)))[0]) + r.normal(0, 0.3,
                                                                                     (N, 2))
    uv_a, uv_b = uv_a.astype(np.float32), uv_b.astype(np.float32)
    sig_a = (1.2 ** r.integers(0, 4, N)).astype(np.float32)
    sig_b = (1.2 ** r.integers(0, 4, N)).astype(np.float32)
    valid = np.ones(N, bool)
    valid[5::11] = False
    key = jax.random.PRNGKey(2)
    J, j_inl, j_n = jl.sim3_ransac_reproj(*map(jnp.asarray, (pa, pb, uv_a, uv_b, sig_a, sig_b,
                                                            valid)), key, JCAM, n_hyp=64)
    T, t_inl, t_n = tl.sim3_ransac_reproj(*map(tensor, (pa, pb, uv_a, uv_b, sig_a, sig_b, valid)),
                                          port_camera(JCAM),
                                          samples=tensor(jax_samples(key, valid, 64)))
    np.testing.assert_array_equal(t_inl.numpy(), np.asarray(j_inl))
    assert int(t_n) == int(j_n) > 80
    assert_pose_close(T, J)


def test_sim3_ransac_own_sampler():
    pa, pb, S_true = correspondences()
    valid = torch.ones(len(pa), dtype=torch.bool)
    valid[:10] = False
    gen = torch.Generator().manual_seed(0)
    draws = tl.draw_samples(valid, 256, gen)
    assert draws.shape == (256, 3) and int(draws.min()) >= 10
    gen.manual_seed(0)
    T, inl, n = tl.sim3_ransac(tensor(pa), tensor(pb), valid, generator=gen, inlier_thr=0.1)
    assert int(n) > 60 and not inl[:10].any()
    np.testing.assert_allclose(T.t.numpy(), np.asarray(S_true.t), atol=0.02)
    assert tl.draw_samples(torch.zeros(7, dtype=torch.bool), 4, gen).shape == (4, 3)


# ---------------------------------------------------------------- vocabulary
@pytest.fixture(scope="module")
def vocs():
    """One corpus trained by both packages (k=5, 3 levels, per-document
    idf), and the JAX tree with three children of every bottom node made
    equal, so that descents end in ties."""
    r = np.random.default_rng(21)
    corpus = r.integers(0, 256, (2000, 32)).astype(np.uint8)
    doc = r.integers(0, 12, 2000)
    jv = jvb.train_vocabulary(corpus, k=5, levels=3, doc_ids=doc)
    tv = tvb.train_vocabulary(corpus, k=5, levels=3, doc_ids=doc)
    bottom = np.array(jv.level_desc[2])
    bottom[2::5] = bottom[1::5]
    bottom[3::5] = bottom[1::5]
    mid = np.array(jv.level_desc[1])
    mid[4::5] = mid[0::5]
    j_tied = jv._replace(level_desc=(jv.level_desc[0], jnp.asarray(mid), jnp.asarray(bottom)))
    return dict(corpus=corpus, jax=jv, torch=tv, jax_tied=j_tied,
                torch_tied=from_numpy_tree(np_tree(j_tied)))


def assert_vocab_equal(tv, jv):
    assert type(tv) is tvb.Vocabulary and (tv.k, tv.levels) == (jv.k, jv.levels)
    assert tv.n_leaves == jv.n_leaves and len(tv.level_desc) == len(jv.level_desc)
    for a, b in zip(tv.level_desc + tv.level_valid, jv.level_desc + jv.level_valid):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))


def test_train_vocabulary_is_the_same_tree(vocs):
    assert_vocab_equal(vocs["torch"], vocs["jax"])
    assert_vocab_equal(from_numpy_tree(np_tree(vocs["jax"])), vocs["jax"])
    assert vocs["torch"].to("cpu").idf.device.type == "cpu"


@pytest.mark.parametrize("which", ["", "_tied"], ids=["trained", "tied_children"])
def test_quantize_leaf_ids(vocs, which):
    jv, tv = vocs["jax" + which], vocs["torch" + which]
    desc = vocs["corpus"][:300].copy()
    desc[:25] = np.asarray(jv.level_desc[2])[1::5]  # exactly on the tied centers
    valid = np.ones(300, bool)
    valid[::9] = False
    jl_ = np.asarray(jvb.quantize(jv, jnp.asarray(desc), jnp.asarray(valid)))
    tl_ = tvb.quantize(tv, tensor(desc), tensor(valid))
    assert tl_.dtype == torch.int32
    np.testing.assert_array_equal(tl_.numpy(), jl_)
    if which:  # a tie takes the first child: never the copies at slots 2 and 3
        assert not np.isin(jl_[valid] % 5, (2, 3)).any() and (jl_[:25] % 5 == 1).sum() >= 10


def sparse_set(ids, w):
    ids, w = np.asarray(ids), np.asarray(w)
    keep = ids >= 0
    order = np.argsort(ids[keep], kind="stable")
    return ids[keep][order], w[keep][order]


@pytest.mark.parametrize("n_feat", [128, 300], ids=["fewer_than_leaves", "more_than_leaves"])
def test_bow_dense_and_sparse(vocs, n_feat):
    jv, tv = vocs["jax"], vocs["torch"]
    desc = vocs["corpus"][500:500 + n_feat]
    valid = np.ones(n_feat, bool)
    valid[::5] = False
    jd, jleaf = jvb.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    td, tleaf = tvb.transform(tv, tensor(desc), tensor(valid))
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert abs(float(td.abs().sum()) - 1.0) < 1e-5
    ji, jw, _ = jvb.transform_sparse(jv, jnp.asarray(desc), jnp.asarray(valid))
    ti, tw, tleaf2 = tvb.transform_sparse(tv, tensor(desc), tensor(valid))
    assert ti.shape == tw.shape == (n_feat,) and ti.dtype == torch.int32
    assert torch.equal(tleaf2, tleaf)
    (ids_t, w_t), (ids_j, w_j) = sparse_set(ti.numpy(), tw.numpy()), sparse_set(ji, jw)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-6)
    # the port's order: by weight, equal weights by leaf id; unused slots -1 / 0
    tin, twn = ti.numpy(), tw.numpy()
    used = tin >= 0
    assert (np.diff(twn) <= 0).all() and (twn[~used] == 0).all() and used[: used.sum()].all()
    same_w = np.diff(twn[used]) == 0
    assert (np.diff(tin[used])[same_w] > 0).all()


def test_score_sparse_many_and_l1(vocs):
    jv, tv = vocs["jax"], vocs["torch"]
    r = np.random.default_rng(2)
    L, K = 64, 9
    # sparse vectors by hand: each holds leaf 0, distinct ids, padded with -1
    def vec():
        ids = np.concatenate([[0], 1 + r.choice(jv.n_leaves - 1, 40, replace=False)])
        w = r.uniform(0.1, 1.0, 41).astype(np.float32)
        w /= w.sum()
        pad = L - 41
        perm = r.permutation(L)
        return (np.concatenate([ids, -np.ones(pad)]).astype(np.int32)[perm],
                np.concatenate([w, np.zeros(pad, np.float32)])[perm])
    q_ids, q_w = vec()
    db = [vec() for _ in range(K)]
    db_ids, db_w = np.stack([d[0] for d in db]), np.stack([d[1] for d in db])
    js = np.asarray(jvb.score_sparse_many(jv, *map(jnp.asarray, (q_ids, q_w, db_ids, db_w))))
    ts = tvb.score_sparse_many(tv, *map(tensor, (q_ids, q_w, db_ids, db_w)))
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-6)
    # the leaf-0 term is really there: against itself a vector scores 1
    self_score = tvb.score_sparse_many(tv, tensor(q_ids), tensor(q_w), tensor(q_ids)[None],
                                       tensor(q_w)[None])
    assert abs(float(self_score[0]) - 1.0) < 1e-6
    # two runs give the same bits
    assert torch.equal(ts, tvb.score_sparse_many(tv, *map(tensor, (q_ids, q_w, db_ids, db_w))))
    # dense scores, vector against vector and matrix against matrix
    a = r.dirichlet(np.ones(50), 3).astype(np.float32)
    b = r.dirichlet(np.ones(50), 4).astype(np.float32)
    np.testing.assert_allclose(tvb.score_l1(tensor(a), tensor(b)).numpy(),
                               np.asarray(jvb.score_l1(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvb.score_l1(tensor(a[0]), tensor(b[0])).numpy(),
                               np.asarray(jvb.score_l1(jnp.asarray(a[0]), jnp.asarray(b[0]))),
                               rtol=0, atol=1e-6)


def write_voc(path, k, L, nodes):
    """nodes: (parent, is_leaf, desc (32,), weight) in file order."""
    lines = [f"{k} {L} 0 0"]
    for p, leaf, d, w in nodes:
        lines.append(f"{p} {leaf} " + " ".join(str(int(x)) for x in d) + f" {w}")
    path.write_text("\n".join(lines) + "\n")


def text_vocabularies():
    z, ones = np.zeros(32, np.uint8), np.full(32, 255, np.uint8)
    half = np.zeros(32, np.uint8)
    half[:16] = 255
    d = np.random.default_rng(7).integers(0, 256, (6, 32)).astype(np.uint8)
    return {
        # tests/test_loop.py::test_dbow2_text_loader: a full 2-ary tree of depth 2
        "full": (2, 2, [(p, int(i >= 2), d[i], w) for i, (p, w) in enumerate(
            zip([0, 0, 1, 1, 2, 2], [0.0, 0.0, 0.5, 0.7, 0.9, 1.1]))], d[2], None),
        # tests/test_vocab_scale.py: a node with one child; a leaf above the bottom
        "underfull": (2, 2, [(0, 0, z, 0.0), (0, 0, ones, 0.0), (1, 1, half, 0.3),
                             (2, 1, ones, 0.5), (2, 1, z, 0.7)], z, 0.3),
        "early_leaf": (2, 2, [(0, 1, z, 0.9), (0, 0, ones, 0.0), (2, 1, ones, 0.5),
                              (2, 1, z, 0.7)], z, 0.9),
    }


@pytest.mark.parametrize("name", ["full", "underfull", "early_leaf"])
def test_dbow2_text_loader(tmp_path, name):
    k, L, nodes, query, weight = text_vocabularies()[name]
    path = tmp_path / "voc.txt"
    write_voc(path, k, L, nodes)
    jv, tv = jvb.load_dbow2_text(str(path)), tvb.load_dbow2_text(str(path))
    assert_vocab_equal(tv, jv)
    leaf_j = int(jvb.quantize(jv, jnp.asarray(query[None]), jnp.ones(1, bool))[0])
    leaf_t = int(tvb.quantize(tv, tensor(query[None]), torch.ones(1, dtype=torch.bool))[0])
    assert leaf_t == leaf_j and 0 <= leaf_t < tv.n_leaves
    if weight is not None:  # the padded slot never wins; the early leaf keeps its weight
        assert float(tv.idf[leaf_t]) == pytest.approx(weight)


def test_dbow2_text_save_load_roundtrip(tmp_path, vocs):
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    jvb.save_dbow2_text(vocs["jax"], str(jp))
    tvb.save_dbow2_text(vocs["torch"], str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    back = tvb.load_dbow2_text(str(jp))
    q = np.random.default_rng(0).integers(0, 256, (256, 32)).astype(np.uint8)
    ones = torch.ones(256, dtype=torch.bool)
    assert torch.equal(tvb.quantize(back, tensor(q), ones),
                       tvb.quantize(vocs["torch"], tensor(q), ones))


# ---------------------------------------------------------------- pose graph
def drifted_loop():
    """tests/test_loop.py::TestPoseGraph: a chain of 10 nodes on a circle
    with drift growing to 0.5, temporal edges from the true motion, one
    loop edge 9 -> 0 of weight 100."""
    K = 10
    ang = np.linspace(0, 2 * np.pi, K)
    true_p = np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], -1).astype(np.float32)
    est_p = true_p + np.stack([np.linspace(0, 0.5, K), np.zeros(K), np.zeros(K)], -1)
    e_i = np.concatenate([np.arange(K - 1), [K - 1]]).astype(np.int32)
    e_j = np.concatenate([np.arange(1, K), [0]]).astype(np.int32)
    w = np.ones(K, np.float32)
    w[K - 1] = 100.0
    return K, est_p.astype(np.float32), e_i, e_j, true_p[e_j] - true_p[e_i], w, true_p


def scale_drift():
    """TestScaleEstimation::test_pose_graph_free_scale: steps measured 1.2x
    longer than estimated."""
    K = 6
    p = np.stack([np.linspace(0, 2.0, K), np.zeros(K), np.zeros(K)], -1).astype(np.float32)
    e_i = np.arange(K - 1, dtype=np.int32)
    meas = np.tile(np.array([0.48, 0, 0], np.float32), (K - 1, 1))
    return K, p, e_i, e_i + 1, meas, np.ones(K - 1, np.float32), None


def problems(case):
    K, p, e_i, e_j, meas_t, w, truth = drifted_loop() if case == "drifted_loop" else scale_drift()
    E = len(e_i)
    ident = lambda n: np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))  # noqa: E731
    fixed = np.zeros(K, bool)
    fixed[0] = True
    jp = jpg.PoseGraphProblem(
        nodes=JSim3(jnp.asarray(ident(K)), jnp.asarray(p), jnp.ones(K)),
        node_valid=jnp.ones(K, bool), node_fixed=jnp.asarray(fixed), e_i=jnp.asarray(e_i),
        e_j=jnp.asarray(e_j),
        e_meas=JSim3(jnp.asarray(ident(E)), jnp.asarray(meas_t.astype(np.float32)), jnp.ones(E)),
        e_weight=jnp.asarray(w), e_valid=jnp.ones(E, bool))
    tp = from_numpy_tree(np_tree(jp))
    assert type(tp) is tpg.PoseGraphProblem and type(tp.nodes) is TSim3
    return jp, tp, truth


@pytest.mark.parametrize("case,fix_scale", [("drifted_loop", True), ("drifted_loop", False),
                                            ("scale_drift", False)])
def test_solve_pose_graph(case, fix_scale):
    jp, tp, truth = problems(case)
    j_nodes, j_costs = jpg.solve_pose_graph(jp, iters=15, fix_scale=fix_scale)
    t_nodes, t_costs = tpg.solve_pose_graph(tp, iters=15, fix_scale=fix_scale)
    assert_pose_close(t_nodes, j_nodes, atol=1e-4)
    # (a converged cost is rounding noise: 1e-4 of the first cost is its floor)
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs), rtol=1e-4,
                               atol=1e-4 * float(j_costs[0]))
    assert t_costs.shape == (15,) and float(t_costs[-1]) < 1e-3 * float(t_costs[0]) + 1e-6
    if truth is not None and fix_scale:
        assert np.linalg.norm(t_nodes.t.numpy() - truth, axis=-1).max() < 0.02
    if case == "scale_drift":
        assert abs(float(t_nodes.t[-1, 0]) - 2.4) < 0.05
    # the same problem again: the same bits
    again, costs2 = tpg.solve_pose_graph(tp, iters=15, fix_scale=fix_scale)
    assert all(torch.equal(a, b) for a, b in zip(again, t_nodes)) and torch.equal(costs2, t_costs)


def test_pose_graph_masks_edges_and_nodes():
    """An invalid edge contributes nothing, a fixed or invalid node stays,
    and two edges on one pair of nodes both count (duplicate indices)."""
    jp, tp, _ = problems("drifted_loop")
    E, K = tp.e_i.shape[0], tp.node_valid.shape[0]
    e_valid = np.ones(E, bool)
    e_valid[3] = False
    dup = lambda a: np.concatenate([np.asarray(a), np.asarray(a)[-1:]])  # noqa: E731
    node_valid = np.ones(K, bool)
    node_valid[5] = False
    jp2 = jp._replace(e_i=jnp.asarray(dup(jp.e_i)), e_j=jnp.asarray(dup(jp.e_j)),
                      e_meas=JSim3(*[jnp.asarray(dup(a)) for a in jp.e_meas]),
                      e_weight=jnp.asarray(dup(jp.e_weight)),
                      e_valid=jnp.asarray(dup(e_valid) & (dup(jp.e_i) != 5) & (dup(jp.e_j) != 5)),
                      node_valid=jnp.asarray(node_valid))
    tp2 = from_numpy_tree(np_tree(jp2))
    j_nodes, j_costs = jpg.solve_pose_graph(jp2, iters=8)
    t_nodes, t_costs = tpg.solve_pose_graph(tp2, iters=8)
    assert_pose_close(t_nodes, j_nodes, atol=1e-4)
    np.testing.assert_allclose(t_costs.numpy(), np.asarray(j_costs), rtol=1e-4,
                               atol=1e-4 * float(j_costs[0]))
    for k in (0, 5):
        assert torch.equal(t_nodes.t[k], tp2.nodes.t[k])
