"""Map compaction: reclaim the rows of culled keyframes and map points.

Port of orbslam3_tpu/map/compaction.py. The map is fixed-capacity and rows
are never reused: culling only flips validity masks, so a long sequence
exhausts capacity even when the live map is small. `compact_map`
stable-partitions valid rows to the front of every array and remaps every
index column (kf_mp, mp_obs_kf, kf_prev, mp_first_kf, covisibility rows and
columns). Row ids stay monotonic in insertion order, which keeps "earlier id
== older keyframe". Hosts must remap the keyframe ids they hold
(TrackState.last_kf) with the returned old->new tables.
"""
from __future__ import annotations

import torch

from orbslam3_tpu_torch.imu.preintegration import PreintState
from orbslam3_tpu_torch.map.slam_map import I32, MapState


def _partition_order(valid):
    """Row order that puts valid rows first, each group in its original
    order (a stable partition), and the old->new table (-1 for invalid)."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    new_id = torch.cumsum(valid.to(I32), 0, dtype=I32) - 1
    return order, torch.where(valid, new_id, torch.full_like(new_id, -1))


def compact_map(st: MapState):
    """Stable-compact keyframe and map-point rows.

    Returns (MapState, kf_old_to_new (K,) int32, mp_old_to_new (M,) int32)
    where invalid old rows map to -1. After the call, rows [n_kf:] / [n_mp:]
    are pristine free slots and n_kf/n_mp equal the live counts."""
    K = st.kf_mp.shape[0]
    M = st.mp_obs_kf.shape[0]
    kf_order, kf_map = _partition_order(st.kf_valid)
    mp_order, mp_map = _partition_order(st.mp_valid)
    live_kf = st.kf_valid[kf_order]  # (K,) True for rows < n_kf
    live_mp = st.mp_valid[mp_order]

    def remap(table, n):
        # clamp before the gather: a -1 must never index from the end
        return lambda a: torch.where(a >= 0, table[a.long().clamp(0, n - 1)],
                                     torch.full_like(a, -1))

    remap_kf_ids, remap_mp_ids = remap(kf_map, K), remap(mp_map, M)

    def gather(order, live):
        def g(a, fill=None):
            """Rows of `a` in the new order; freed rows reset to `fill`."""
            out = a[order]
            if fill is not None:
                mask = live.reshape((-1,) + (1,) * (out.dim() - 1))
                out = torch.where(mask, out, torch.full_like(out, fill))
            return out
        return g

    gk, gm = gather(kf_order, live_kf), gather(mp_order, live_mp)
    covis = st.covis[kf_order][:, kf_order]
    covis = torch.where(live_kf[:, None] & live_kf[None, :], covis, torch.zeros_like(covis))

    st = st._replace(
        kf_q=gk(st.kf_q), kf_p=gk(st.kf_p), kf_v=gk(st.kf_v), kf_bg=gk(st.kf_bg),
        kf_ba=gk(st.kf_ba), kf_time=gk(st.kf_time), kf_valid=live_kf,
        kf_map_id=gk(st.kf_map_id, -1), kf_prev=gk(remap_kf_ids(st.kf_prev), -1),
        kf_inliers=gk(st.kf_inliers, 0), kf_uv=gk(st.kf_uv), kf_ur=gk(st.kf_ur),
        kf_depth=gk(st.kf_depth), kf_octave=gk(st.kf_octave), kf_desc=gk(st.kf_desc),
        kf_mp=gk(remap_mp_ids(st.kf_mp), -1), kf_feat_valid=gk(st.kf_feat_valid, False),
        kf_preint=PreintState(*[a[kf_order] for a in st.kf_preint]),
        mp_pos=gm(st.mp_pos), mp_desc=gm(st.mp_desc), mp_normal=gm(st.mp_normal),
        mp_min_dist=gm(st.mp_min_dist), mp_max_dist=gm(st.mp_max_dist), mp_valid=live_mp,
        mp_map_id=gm(st.mp_map_id, -1), mp_first_kf=gm(remap_kf_ids(st.mp_first_kf), -1),
        mp_visible=gm(st.mp_visible, 1), mp_found=gm(st.mp_found, 1),
        mp_obs_kf=gm(remap_kf_ids(st.mp_obs_kf), -1), mp_obs_feat=gm(st.mp_obs_feat, -1),
        mp_obs_n=gm(st.mp_obs_n, 0), covis=covis,
        n_kf=torch.sum(st.kf_valid, dtype=I32), n_mp=torch.sum(st.mp_valid, dtype=I32),
    )
    return st, kf_map, mp_map


def concat_maps(a: MapState, b: MapState):
    """Concatenate two maps into one state (multi-session welding).

    Both are compacted first; b's rows land at offsets [n_kf_a, n_mp_a) with
    every index column shifted and b's atlas map ids relabeled past a's
    `next_map_id`, so the result is a valid multi-map state. Host-driven: the
    offsets are read from the device (one read of the four row counts and
    a's `next_map_id`); session merging is a rare offline operation.

    Returns (MapState, kf_offset, mp_offset): b's old row i is now
    kf_offset + i / mp_offset + i."""
    a, _, _ = compact_map(a)
    b, _, _ = compact_map(b)
    K, N = a.kf_mp.shape
    M, O = a.mp_obs_kf.shape
    if b.kf_mp.shape != (K, N) or b.mp_obs_kf.shape != (M, O):
        raise ValueError("concat_maps requires identical capacities")
    na, nma, nb, nmb, mofs = torch.stack([a.n_kf, a.n_mp, b.n_kf, b.n_mp, a.next_map_id]).tolist()
    if na + nb > K or nma + nmb > M:
        raise ValueError(f"merged map exceeds capacity: {na}+{nb} kfs (cap {K}), "
                         f"{nma}+{nmb} points (cap {M})")

    def put(lo, n):
        def p(xa, xb, shift=None):
            rows = xb[:n] if shift is None else shift(xb[:n])
            out = xa.clone()
            out[lo:lo + n] = rows
            return out
        return p

    put_kf, put_mp = put(na, nb), put(nma, nmb)

    def shifted(by):
        return lambda x: torch.where(x >= 0, x + by, torch.full_like(x, -1))

    sh_kf, sh_mp, sh_map = shifted(na), shifted(nma), shifted(mofs)
    covis = a.covis.clone()
    covis[na:na + nb, na:na + nb] = b.covis[:nb, :nb]

    def i32(v):
        return torch.tensor(v, dtype=I32, device=a.n_kf.device)

    return a._replace(
        kf_q=put_kf(a.kf_q, b.kf_q), kf_p=put_kf(a.kf_p, b.kf_p), kf_v=put_kf(a.kf_v, b.kf_v),
        kf_bg=put_kf(a.kf_bg, b.kf_bg), kf_ba=put_kf(a.kf_ba, b.kf_ba),
        kf_time=put_kf(a.kf_time, b.kf_time), kf_valid=put_kf(a.kf_valid, b.kf_valid),
        kf_map_id=put_kf(a.kf_map_id, b.kf_map_id, sh_map),
        kf_prev=put_kf(a.kf_prev, b.kf_prev, sh_kf),
        kf_inliers=put_kf(a.kf_inliers, b.kf_inliers), kf_uv=put_kf(a.kf_uv, b.kf_uv),
        kf_ur=put_kf(a.kf_ur, b.kf_ur), kf_depth=put_kf(a.kf_depth, b.kf_depth),
        kf_octave=put_kf(a.kf_octave, b.kf_octave), kf_desc=put_kf(a.kf_desc, b.kf_desc),
        kf_mp=put_kf(a.kf_mp, b.kf_mp, sh_mp),
        kf_feat_valid=put_kf(a.kf_feat_valid, b.kf_feat_valid),
        kf_preint=PreintState(*[put_kf(xa, xb) for xa, xb in zip(a.kf_preint, b.kf_preint)]),
        mp_pos=put_mp(a.mp_pos, b.mp_pos), mp_desc=put_mp(a.mp_desc, b.mp_desc),
        mp_normal=put_mp(a.mp_normal, b.mp_normal),
        mp_min_dist=put_mp(a.mp_min_dist, b.mp_min_dist),
        mp_max_dist=put_mp(a.mp_max_dist, b.mp_max_dist),
        mp_valid=put_mp(a.mp_valid, b.mp_valid),
        mp_map_id=put_mp(a.mp_map_id, b.mp_map_id, sh_map),
        mp_first_kf=put_mp(a.mp_first_kf, b.mp_first_kf, sh_kf),
        mp_visible=put_mp(a.mp_visible, b.mp_visible), mp_found=put_mp(a.mp_found, b.mp_found),
        mp_obs_kf=put_mp(a.mp_obs_kf, b.mp_obs_kf, sh_kf),
        mp_obs_feat=put_mp(a.mp_obs_feat, b.mp_obs_feat),
        mp_obs_n=put_mp(a.mp_obs_n, b.mp_obs_n), covis=covis,
        n_kf=i32(na + nb), n_mp=i32(nma + nmb),
        active_map=b.active_map + mofs, next_map_id=b.next_map_id + mofs,
        n_obs_dropped=a.n_obs_dropped + b.n_obs_dropped,
    ), na, nma
