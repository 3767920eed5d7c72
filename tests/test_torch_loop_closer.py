"""Torch port of the loop closer (loop/closer.py) against the JAX package.

On the constructed revisit map of tests/test_loop.py (two passes over one
landmark wall, the second drifted; the builder is copied here) with a few
landmarks sharing a descriptor, so that match counts, covisibility weights
and Hamming minima tie:

* the detection packet: candidate ids, counts and covisibility groups
  exact, BoW scores and the lowest covisible score within 1e-6, the BoW
  rows written exact (ids) and 1e-6 (weights); the row-bucket slice gives
  the unsliced packet;
* _match_kf_pair exact; _verify_program on the draws JAX makes from its
  own key: nm, ninl, nrp exact, the Sim3 and the implied seam within 1e-5;
* _consistency_chain over a scripted sequence of groups: chains and the
  kept groups equal;
* _merge_maps within 1e-6 (ids exact);
* _correct on the same S_rel with a culled row and a past loop edge: nodes
  within 1e-4, body-frame velocities kept, points 1e-4, the loop-edge store
  and the rows moved exact, seam fusion's ids exact; with the seam gate
  open it ends with global BA (held to the JAX solve in
  test_torch_global_ba.py);
* _vi_refine on a map grown from the small world: the same decision,
  poses 1e-4, velocities 1e-3, biases 1e-4, points 1e-4 + 2e-4 relative
  (the tolerances of tests/test_torch_vi_ba.py);
* remap_rows;
* on_keyframe / drain over the revisit map and over a cross-map merge,
  with the draws fed: the same LoopStats, service sequence and corrected
  keyframe, poses within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.frontend.camera import Camera
from orbslam3_tpu.frontend.orb import OrbConfig as JOrb
from orbslam3_tpu.geometry import quat as jquat
from orbslam3_tpu.geometry.sim3 import Sim3 as JSim3
from orbslam3_tpu.imu.preintegration import PreintState
from orbslam3_tpu.loop import closer as jcl
from orbslam3_tpu.loop import vocab as jvb
from orbslam3_tpu.map import slam_map as jsm
from orbslam3_tpu.map.mapping_ops import remove_keyframe
from orbslam3_tpu.models import slam as jslam
from orbslam3_tpu_torch.geometry.sim3 import Sim3 as TSim3
from orbslam3_tpu_torch.interop import carry_loop_closer, from_numpy_tree
from orbslam3_tpu_torch.loop import closer as tcl
from orbslam3_tpu_torch.parallel.distributed_ba import make_point_table
from torch_parity import grow_jax_map, port_camera, record_loop_services, tensor

CAM = Camera.create(240.0, 240.0, 192.0, 128.0, 0.11, 384, 256)
TCAM = port_camera(CAM)
L = 96


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def build_revisit_map(drift=(0.4, 0.0, 0.2), max_kf=16, dup=True, cross_map=False,
                      stereo=False):
    """tests/test_loop.py::build_revisit_map (and, with cross_map, the map
    pair of its test_cross_map_merge): pass 1 creates the wall's landmarks
    at keyframe 0 and re-observes them at keyframes 1-4; pass 2 (keyframes
    5-9, or 5-7 in a new map) sees the same wall from drifted estimates and
    spawns duplicates. dup: every 16th landmark shares the descriptor of
    the one before it. stereo: the features carry their right-image
    coordinate (else they are mono). Returns (MapState of numpy arrays, landmark
    descriptors, pass-1 poses)."""
    rng = np.random.default_rng(21)
    cap = jsm.MapCapacity(max_kf=max_kf, n_feat=128, max_mp=2048, max_obs=8)
    st = jsm.empty_map(cap)
    lm = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), np.full(L, 6.0)],
                  -1).astype(np.float32)
    lm_desc = rng.integers(0, 256, (L, 32)).astype(np.uint8)
    if dup:
        lm_desc[1::16] = lm_desc[0::16]
    drift = np.asarray(drift, np.float32)

    def make_kf(p_est, matched_ids, p_render, prev, t):
        xc = lm - p_render
        z = xc[:, 2]
        n = cap.n_feat
        uv = np.zeros((n, 2), np.float32)
        uv[:L] = np.stack([240 * xc[:, 0] / z + 192, 240 * xc[:, 1] / z + 128], -1)
        ur = np.full(n, -1.0, np.float32)
        if stereo:
            ur[:L] = uv[:L, 0] - 240 * 0.11 / z
        depth = np.full(n, -1.0, np.float32)
        depth[:L] = z
        pts = np.zeros((n, 3), np.float32)
        pts[:L] = xc
        desc = np.zeros((n, 32), np.uint8)
        desc[:L] = lm_desc
        fv = np.zeros(n, bool)
        fv[:L] = True
        mm = np.full(n, -1, np.int32)
        if matched_ids is not None:
            mm[:L] = matched_ids
        return dict(time=jnp.float32(t), q_wb=jquat.identity(), p_w=jnp.asarray(p_est),
                    vel=jnp.asarray([0.3, -0.1, 0.2], jnp.float32), bias_g=jnp.zeros(3),
                    bias_a=jnp.zeros(3), uv=jnp.asarray(uv), u_right=jnp.asarray(ur),
                    depth=jnp.asarray(depth), octave=jnp.asarray(np.arange(n) % 3, jnp.int32),
                    desc=jnp.asarray(desc), points_body=jnp.asarray(pts),
                    feat_valid=jnp.asarray(fv), matched_mp=jnp.asarray(mm),
                    preint=PreintState.identity(), prev_kf=jnp.int32(prev))

    poses1 = [np.array([x, 0, 0], np.float32) for x in np.linspace(-1, 1, 5)]
    st, _ = jsm.insert_keyframe(st, **make_kf(poses1[0], None, poses1[0], -1, 0.0),
                                new_mp_budget=128)
    for i, p in enumerate(poses1[1:]):
        st, _ = jsm.insert_keyframe(st, **make_kf(p, np.arange(L, dtype=np.int32), p, i,
                                                  0.5 * (i + 1)), new_mp_budget=0)
    n2 = 5
    if cross_map:
        st = jsm.create_new_map(st)
        n2 = 3
    second = np.arange(L, 2 * L, dtype=np.int32)
    st, _ = jsm.insert_keyframe(st, **make_kf(poses1[0] + drift, None, poses1[0],
                                              -1 if cross_map else 4, 3.0), new_mp_budget=128)
    for i, p in enumerate(poses1[1:n2]):
        st, _ = jsm.insert_keyframe(st, **make_kf(p + drift, second, p, 5 + i, 3.5 + 0.5 * i),
                                    new_mp_budget=0)
    # insert-time quality: weak edges at keyframes 6 and 7
    inl = np.zeros(max_kf, np.int32)
    inl[:5 + n2] = 120
    inl[6:8] = 10
    st = st._replace(kf_inliers=jnp.asarray(inl))
    return np_tree(st), lm_desc, poses1


@pytest.fixture(scope="module")
def revisit():
    st, lm_desc, poses1 = build_revisit_map()
    corpus = np.concatenate([lm_desc, np.random.default_rng(3).integers(0, 256, (2000, 32))
                             .astype(np.uint8)])
    voc = jvb.train_vocabulary(corpus, k=6, levels=3)
    return st, voc, from_numpy_tree(np_tree(voc)), poses1


def jax_draws(kf_id, ok):
    """The (C, 256, 3) samples JAX's _verify_program draws for keyframe
    kf_id from the RANSAC masks `ok` (C, N)."""
    ok = ok.cpu().numpy() if isinstance(ok, torch.Tensor) else np.asarray(ok)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), kf_id), ok.shape[0])
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.categorical(k, jnp.where(o, 0.0, -1e9), shape=(256, 3)))
        for k, o in zip(keys, ok)]))


def fill_bow(voc, tvoc, st, rows):
    """Both packages' BoW databases with `rows` written."""
    K, N = st.kf_desc.shape[:2]
    jids, jw = jnp.full((K, N), -1, jnp.int32), jnp.zeros((K, N), jnp.float32)
    prog = jcl._make_bow_program(voc)
    for k in rows:
        jids, jw = prog(jids, jw, jnp.asarray(st.kf_desc), jnp.asarray(st.kf_feat_valid),
                        jnp.int32(k))
    tids, tw = torch.full((K, N), -1, dtype=torch.int32), torch.zeros((K, N))
    tst = from_numpy_tree(st)
    for k in rows:
        tcl._bow_program(tvoc, tids, tw, tst.kf_desc, tst.kf_feat_valid, k)
    return (jids, jw), (tids, tw), tst


def assert_bow_rows(t, j):
    tids, tw = t
    jids, jw = np.asarray(j[0]), np.asarray(j[1])
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kf_id,Kb", [(9, 16), (9, 10), (7, 16), (4, 16)])
def test_detection_packet(revisit, kf_id, Kb):
    st, voc, tvoc, _ = revisit
    cfg = jcl.LoopConfig(recent_gap=4, covis_exclude_min=15)
    (jids, jw), (tids, tw), tst = fill_bow(voc, tvoc, st, range(kf_id))
    prog = jcl._make_kf_program(voc, cfg)
    jids, jw, jpacket, jgroups = prog(
        jids, jw, jnp.asarray(st.kf_desc), jnp.asarray(st.kf_feat_valid),
        jnp.asarray(st.kf_valid), jnp.asarray(st.kf_map_id), jnp.asarray(st.covis),
        jnp.int32(kf_id), jnp.int32(cfg.recent_gap), jnp.int32(cfg.match_hamming_max),
        jnp.int32(cfg.covis_exclude_min), Kb=Kb)
    tcfg = tcl.LoopConfig(**cfg._asdict())
    packet, groups = tcl._kf_program(tvoc, tcfg, tids, tw, tst, kf_id, Kb)
    jp = np.asarray(jpacket)
    tp = packet.numpy()
    nc = cfg.n_candidates
    np.testing.assert_array_equal(tp[:2 * nc + 1], jp[:2 * nc + 1])  # ids, counts, features
    np.testing.assert_allclose(tp[2 * nc + 1:], jp[2 * nc + 1:], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(groups.numpy(), np.asarray(jgroups))
    assert_bow_rows((tids, tw), (jids, jw))
    if kf_id == 9:
        # the four pass-1 rows tie on 96 - duplicates: the lower rows first
        assert tp[:nc].tolist() == [0, 1, 2, 3] and len(set(tp[nc:2 * nc].tolist())) == 1
    # the row-bucket slice gives the packet of the whole table
    full, full_groups = tcl._kf_program(tvoc, tcfg, tids.clone(), tw.clone(), tst, kf_id, 16)
    np.testing.assert_array_equal(full.numpy(), tp)
    np.testing.assert_array_equal(full_groups[:, :Kb].numpy(), groups.numpy())


def test_match_kf_pair_with_ties():
    r = np.random.default_rng(4)
    N = 64
    da = r.integers(0, 256, (N, 32)).astype(np.uint8)
    db = da.copy()
    db[::5] = r.integers(0, 256, (len(db[::5]), 32))
    db[1::9] = db[0::9][:len(db[1::9])]  # equal minima in B
    da[3::11] = da[2::11][:len(da[3::11])]  # and in A
    va, vb_ = r.random(N) > 0.1, r.random(N) > 0.1
    ma = np.where(r.random(N) > 0.2, np.arange(N), -1).astype(np.int32)
    mb = np.where(r.random(N) > 0.2, np.arange(N), -1).astype(np.int32)
    j = jcl._match_kf_pair(*[jnp.asarray(x) for x in (da, va, ma, db, vb_, mb)])
    t = tcl._match_kf_pair(*[tensor(x) for x in (da, va, ma, db, vb_, mb)])
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t[2].sum()) > 20


def test_verify_program_on_jax_draws(revisit):
    st, _, _, _ = revisit
    cands = [0, 1, 2, 4]
    jst = jax.tree.map(jnp.asarray, st)
    jnm, jninl, jnrp, jdisp, jS = jcl._verify_program(
        jst, jnp.int32(9), jnp.asarray(cands, jnp.int32), CAM, jnp.int32(50), jnp.float32(9.21),
        jnp.float32(3.0))
    nm, ninl, nrp, disp, S = tcl._verify_program(from_numpy_tree(st), 9, cands, TCAM, 50, 9.21,
                                                 3.0, samples=lambda ok: jax_draws(9, ok))
    for a, b in ((nm, jnm), (ninl, jninl), (nrp, jnrp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(nrp.min()) >= 25
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=0, atol=1e-5)
    for a, b in zip(S, jS):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_consistency_chain(revisit):
    _, voc, tvoc, _ = revisit
    j = jcl.LoopCloser(voc, jcl.LoopConfig())
    t = tcl.LoopCloser(tvoc, tcl.LoopConfig())
    K = 16

    def grp(*rows):
        g = np.zeros(K, bool)
        g[list(rows)] = True
        return g

    script = [(20, grp(1, 2)), (21, grp(2, 3)), (21, grp(9)), (22, grp(3, 4)), (26, grp(4)),
              (27, grp(4, 5)), (28, grp(0)), (29, grp(5, 6)), (30, grp(6)), (30, grp(6, 7))]
    for kf, g in script:
        assert t._consistency_chain(kf, g) == j._consistency_chain(kf, g)
        assert t._consistency_groups == j._consistency_groups


def _cross(S_vals):
    q, t, s = S_vals
    return JSim3(jnp.asarray(q), jnp.asarray(t), jnp.float32(s)), TSim3(tensor(q), tensor(t),
                                                                         tensor(np.float32(s)))


def assert_map_close(t, j, atol):
    for name in j._fields:
        a, b = getattr(t, name), getattr(j, name)
        if isinstance(a, tuple):
            assert_map_close(a, b, atol)
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_merge_maps(revisit):
    _, voc, tvoc, _ = revisit
    st, _, _ = build_revisit_map(drift=(0.5, 0.0, 0.3), cross_map=True)
    q = np.asarray(jquat.from_axis_angle(jnp.asarray([0.01, -0.02, 0.015])))
    jS, tS = _cross((q, np.array([-0.5, 0.02, -0.3], np.float32), 1.0))
    j = jcl.LoopCloser(voc)._merge_maps(jax.tree.map(jnp.asarray, st), 6, 1, jS)
    t = tcl.LoopCloser(tvoc)._merge_maps(from_numpy_tree(st), 6, 1, tS)
    assert_map_close(t, np_tree(j), 1e-6)
    assert int(t.active_map) == 0 and set(t.kf_map_id[t.kf_valid].tolist()) == {0}


def _correct_inputs(revisit, stereo=False):
    """Keyframe 9 against 3 on the revisit map with row 7 culled, the S_rel
    JAX verifies, and one past loop edge agreeing with the true geometry
    (row 8 is truly 1 m past row 1)."""
    _, voc, tvoc, _ = revisit
    st = build_revisit_map(stereo=stereo)[0]
    jst = remove_keyframe(jax.tree.map(jnp.asarray, st), jnp.int32(7))
    jS = jax.tree.map(lambda a: a[3], jcl._verify_program(
        jst, jnp.int32(9), jnp.asarray([0, 1, 2, 3], jnp.int32), CAM, jnp.int32(50),
        jnp.float32(9.21), jnp.float32(3.0))[4])
    edge = (1, 8, np.array([1.0, 0, 0, 0], np.float32), np.array([1.0, 0.0, 0.0], np.float32), 1.0)
    return np_tree(jst), jst, jS, edge, voc, tvoc


@pytest.fixture(scope="module")
def corrected(revisit):
    """_correct on both packages from one state (the seam gate above the
    seam: no global BA)."""
    st, jst, jS, edge, voc, tvoc = _correct_inputs(revisit)
    cfg = jcl.LoopConfig(heavy_repair_min_seam=5.0)
    j = jcl.LoopCloser(voc, cfg)
    j._loop_edges = [edge]
    t = tcl.LoopCloser(tvoc, tcl.LoopConfig(**cfg._asdict()))
    t._loop_edges = [edge]
    jout = np_tree(j._correct(jst, 9, 3, jS, CAM))
    tout = t._correct(from_numpy_tree(st), 9, 3, TSim3(*[tensor(a) for a in jS]), TCAM)
    return st, jout, tout, j, t


def test_correct_poses_and_points(corrected):
    st, j, t, _, tcloser = corrected
    kf = np.asarray(st.kf_map_id) == 0
    assert np.abs(t.kf_p.numpy() - st.kf_p).max() > 0.1  # the correction moved the seam
    rec = tcloser.corrections[-1]
    assert rec["gba"] is None and rec["host_reads"] == 2 and rec["seam_m"] > 0.1
    # the pair's keyframe times come with the edge's read
    assert (rec["kf_time"], rec["cand_time"]) == (float(st.kf_time[9]), float(st.kf_time[3]))
    atol = 1e-4
    np.testing.assert_allclose(t.kf_p.numpy()[kf], j.kf_p[kf], rtol=0, atol=atol)
    tq, jq = t.kf_q.numpy()[kf], j.kf_q[kf]
    np.testing.assert_allclose(tq * np.sign((tq * jq).sum(-1, keepdims=True)), jq, rtol=0,
                               atol=atol)
    np.testing.assert_allclose(t.mp_pos.numpy(), j.mp_pos, rtol=0, atol=atol)
    # which rows moved, the culled row among them, is the same
    moved_t = np.abs(t.kf_p.numpy() - st.kf_p).max(1) > 0
    moved_j = np.abs(j.kf_p - st.kf_p).max(1) > 0
    np.testing.assert_array_equal(moved_t, moved_j)
    assert moved_t[7] and not bool(st.kf_valid[7])
    # body-frame velocities are kept
    def body(q, v):
        return np.asarray(jquat.rotate(jquat.conj(jnp.asarray(q)), jnp.asarray(v)))

    np.testing.assert_allclose(body(t.kf_q.numpy()[:10], t.kf_v.numpy()[:10]),
                               body(st.kf_q[:10], st.kf_v[:10]), rtol=0, atol=1e-4)


def test_correct_store_and_fusion(corrected):
    _, j, t, jcloser, tcloser = corrected
    assert len(tcloser._loop_edges) == len(jcloser._loop_edges) == 2
    for a, b in zip(tcloser._loop_edges, jcloser._loop_edges):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-6)
    for name in ("kf_mp", "mp_valid", "mp_obs_kf", "mp_obs_feat", "mp_obs_n", "covis",
                 "kf_valid", "n_mp"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)


def test_correct_runs_global_ba_last(revisit):
    """With the seam gate under the seam, _correct ends with global BA over
    the pose-graph-corrected, seam-fused map, anchored at the candidate:
    exactly _global_ba of the gate-closed result. (The solve itself is held
    to the JAX package in test_torch_global_ba.py; on this wall at 6 m one
    GN step of the JAX solve moves the poses 2.3e-4 m with the order of its
    own sums.)"""
    st, _, jS, edge, _, tvoc = _correct_inputs(revisit, stereo=True)
    S = TSim3(*[tensor(a) for a in jS])
    outs = []
    for gate in (0.1, 5.0):
        t = tcl.LoopCloser(tvoc, tcl.LoopConfig(heavy_repair_min_seam=gate, gba_iters=2))
        t._loop_edges = [edge]
        outs.append(t._correct(from_numpy_tree(st), 9, 3, S, TCAM))
        rec = t.corrections[-1]
        assert (rec["gba"] is not None) == (gate < 1) and rec["host_reads"] == 2
    want, info = t._global_ba(outs[1], 3, TCAM)
    assert (info["slots"], info["tiles"], info["iters"]) == (2048, 1, 2)
    # the points the table holds: the valid rows of the point table
    pts, _ = make_point_table(outs[1], 2048, t.cfg.gba_obs)
    assert int(info["points"]) == int(pts.pt_valid.sum()) > 0
    for name in ("kf_q", "kf_p", "kf_v", "mp_pos"):
        assert torch.equal(getattr(outs[0], name), getattr(want, name)), name
    assert not torch.equal(outs[0].kf_p, outs[1].kf_p)


def test_vi_refine():
    from orbslam3_tpu.models.slam import SlamConfig

    cap = jsm.MapCapacity(max_kf=16, n_feat=384, max_mp=4096, max_obs=8)
    _, st = grow_jax_map(6, cap, SlamConfig(orb=JOrb(n_features=384, n_levels=4), cap=cap))
    inl = np.zeros(16, np.int32)
    inl[:6] = [150, 150, 20, 20, 150, 150]
    p = st.kf_p.copy()
    p[2:4] += np.array([0.05, -0.03, 0.02], np.float32)
    st = st._replace(kf_inliers=inl, kf_p=p)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    cfg = jcl.LoopConfig(vi_refine_window=8, vi_refine_points=1024, vi_refine_iters=4,
                         vi_refine_fixed=2)
    j = jcl.LoopCloser(jvb.train_vocabulary(st.kf_desc[0], k=4, levels=2), cfg)
    j.gravity_w = jnp.asarray(g)
    jout = np_tree(j._vi_refine(jax.tree.map(jnp.asarray, st), 5, CAM))
    t = tcl.LoopCloser(None, tcl.LoopConfig(**cfg._asdict()))
    t.gravity_w = tensor(g)
    reads = []
    tout, accepted = t._vi_refine(from_numpy_tree(st), 5, TCAM, lambda x: reads.append(1)
                                  or x.tolist())
    assert accepted == (not np.array_equal(jout.kf_p, st.kf_p)) and len(reads) == 1
    for name, atol, rtol in (("kf_p", 1e-4, 0), ("kf_v", 1e-3, 0), ("kf_bg", 1e-4, 0),
                             ("kf_ba", 1e-4, 0), ("mp_pos", 1e-4, 2e-4)):
        np.testing.assert_allclose(getattr(tout, name).numpy(), getattr(jout, name), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_remap_rows(revisit):
    st, voc, tvoc, _ = revisit
    (jids, jw), (tids, tw), _ = fill_bow(voc, tvoc, st, range(10))
    j = jcl.LoopCloser(voc)
    t = tcl.LoopCloser(tvoc)
    j.bow_ids, j.bow_w = jids, jw
    t.bow_ids, t.bow_w = tids, tw
    for c in (j, t):
        c.last_loop_kf = 8
        c._loop_edges = [(3, 8, np.ones(4, np.float32), np.zeros(3, np.float32), 1.0),
                         (2, 9, np.ones(4, np.float32), np.zeros(3, np.float32), 1.0)]
        c._consistency_groups = [({1, 2}, 2, 8)]
        c._pending = (9, None, None)
    km = np.array([0, 1, -1, 2, 3, 4, 5, 6, 7, 8] + [-1] * 6)
    j.remap_rows(km)
    t.remap_rows(km)
    assert_bow_rows((t.bow_ids, t.bow_w), (j.bow_ids, j.bow_w))
    assert t.last_loop_kf == j.last_loop_kf == 7
    assert [e[:2] for e in t._loop_edges] == [e[:2] for e in j._loop_edges] == [(2, 7)]
    assert t._pending is None and t._verify_pending is None and not t._consistency_groups
    t.last_loop_kf = 2
    t.remap_rows(km)
    assert t.last_loop_kf == -100


class _Host:
    """The attributes record_loop_services reads of a FusedSlam."""

    def __init__(self, closer):
        self.loop_closer = closer


def _run_closer(closer, st, cam, n_kf, log):
    record_loop_services(_Host(closer), log)
    corrected = []
    for k in range(n_kf):
        st, c = closer.on_keyframe(st, k, cam)
        corrected.append(c)
    st, c = closer.drain(st, cam)
    corrected.append(c)
    return st, corrected


@pytest.mark.parametrize("case", ["revisit", "merge"])
def test_on_keyframe_and_drain(revisit, case):
    _, voc, tvoc, poses1 = revisit
    if case == "revisit":
        st, _, _ = build_revisit_map()
        cfg = jcl.LoopConfig(bow_min_score_gate=False, recent_gap=4, consistency_needed=2,
                             covis_edge_weight_min=10)
    else:
        st, _, _ = build_revisit_map(drift=(0.5, 0.0, 0.3), cross_map=True)
        cfg = jcl.LoopConfig(bow_min_score_gate=False, recent_gap=2, consistency_needed=2,
                             covis_edge_weight_min=10, run_global_ba=False)
    n_kf = int(st.n_kf)
    j = jcl.LoopCloser(voc, cfg)
    t = tcl.LoopCloser(tvoc, tcl.LoopConfig(**cfg._asdict()))
    t.sampler = jax_draws
    jlog, tlog = [], []
    jst, jc = _run_closer(j, jax.tree.map(jnp.asarray, st), CAM, n_kf, jlog)
    tst, tc = _run_closer(t, from_numpy_tree(st), TCAM, n_kf, tlog)
    assert t.stats == tcl.LoopStats(*j.stats) and t.stats.corrected == 1, (t.stats, j.stats)
    assert tc == jc and tlog == jlog
    jst = np_tree(jst)
    np.testing.assert_allclose(tst.kf_p.numpy(), jst.kf_p, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tst.mp_pos.numpy(), jst.mp_pos, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tst.kf_map_id.numpy(), jst.kf_map_id)
    if case == "merge":
        assert set(tst.kf_map_id[tst.kf_valid].tolist()) == {0} and int(tst.active_map) == 0
        for kid, p_true in zip(range(5, 8), poses1[:3]):
            assert np.linalg.norm(tst.kf_p[kid].numpy() - p_true) < 0.1


def test_carry_loop_closer(revisit):
    st, voc, tvoc, _ = revisit
    (jids, jw), _, _ = fill_bow(voc, tvoc, st, range(6))
    j = jcl.LoopCloser(voc)
    j.bow_ids, j.bow_w = jids, jw
    j._consistency_groups = [({1, 2}, 2, 5)]
    j.last_loop_kf = 3
    j._loop_edges = [(1, 3, np.ones(4, np.float32), np.zeros(3, np.float32), 1.0)]
    j.gravity_w = jnp.asarray([0.0, 0.0, -9.81])
    t = carry_loop_closer(j, tcl.LoopCloser(tvoc))
    assert_bow_rows((t.bow_ids, t.bow_w), (j.bow_ids, j.bow_w))
    assert t._consistency_groups == j._consistency_groups and t.last_loop_kf == 3
    assert t._loop_edges[0][:2] == (1, 3)
    np.testing.assert_array_equal(t.gravity_w.numpy(), np.asarray(j.gravity_w))
