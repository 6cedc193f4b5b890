"""Back-end mapping: the per-keyframe map refinement.

Counterpart of object_slam_tpu/slam/local_mapping.py: cull points ->
triangulate -> fuse -> windowed point-stat refresh -> local BA -> cull
keyframes, all sharing one covisibility row of the new keyframe.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.ops.scatter import (scatter_or, scatter_set,
                                               scatter_set2)
from object_slam_tpu_torch.slam import map_ops
from object_slam_tpu_torch.slam.map_state import (
    MapState, covisibility, recompute_point_stats_windowed)
from object_slam_tpu_torch.solvers.ba import BAProblem, local_ba


def build_local_ba_problem(m: MapState, kf_id, window: int, n_fixed: int,
                           pt_cap: int = 0, W_row=None, obs_cap: int = 0):
    """Gather the covisibility window around kf_id into a compact BA
    problem: kf_id and its strongest covisible neighbours free, the next
    n_fixed fixed, KF 0 always fixed. The window's points compact into a
    [pt_cap] slab and each KF's live observations into [obs_cap] slots.
    Returns (prob, kf_sel, sel_ok, lidx, l_ok, pt_obs_slot,
    (col_of, c_ok)). The reference's pt_cap <= 0 full-slab form is not
    ported (no caller uses it)."""
    if pt_cap <= 0:
        raise ValueError("build_local_ba_problem needs pt_cap > 0")
    Kcap, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    window = min(window, Kcap)
    n_fixed = min(n_fixed, max(Kcap - window, 0))
    W, nbrs = map_ops._neighbors(m, kf_id, window - 1 + n_fixed, W_row)
    kf_t = torch.tensor([int(kf_id)], device=dev)
    local_kfs = torch.cat([kf_t, nbrs[:window - 1]])
    fixed_kfs = nbrs[window - 1:]
    kf_sel = torch.cat([local_kfs, fixed_kfs])
    Wtot = kf_sel.shape[0]
    sel_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        W[nbrs[:window - 1]] > 0, W[fixed_kfs] > 0])
    fixed = torch.cat([torch.zeros(window, dtype=torch.bool, device=dev),
                       torch.ones(n_fixed, dtype=torch.bool, device=dev)])
    fixed = fixed | (kf_sel == 0)

    kp_pt = m.kf_kp_pt[kf_sel]
    obs_valid = (kp_pt >= 0) & m.kf_kp_valid[kf_sel] & sel_ok[:, None]
    ptc = torch.clamp(kp_pt, 0, P - 1).long()
    obs_valid = obs_valid & m.pt_valid[ptc]

    # owner table [Wtot, P]: the keypoint of window-KF w that observes p
    # (the last writer of duplicates wins); doubles as the dedupe filter
    ww = torch.arange(Wtot, device=dev)[:, None].expand(Wtot, N)
    cols = torch.arange(N, device=dev)[None, :].expand(Wtot, N)
    owner = scatter_set2(
        torch.full((Wtot, P), -1, dtype=torch.int64, device=dev),
        ww, torch.where(obs_valid, ptc, torch.full_like(ptc, P)), cols)
    obs_valid = obs_valid & (owner[ww, ptc] == cols)

    free_rows = (~fixed & sel_ok)[:, None] & obs_valid
    pt_local = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                          ptc.reshape(-1), free_rows.reshape(-1))
    obs_valid = obs_valid & pt_local[ptc]

    Lp = min(pt_cap, P)
    ar_p = torch.arange(P, device=dev)
    ppos = torch.cumsum(pt_local.to(torch.int64), 0) - 1
    p_in = pt_local & (ppos < Lp)
    lidx = scatter_set(torch.zeros(Lp + 1, dtype=torch.int64, device=dev),
                       torch.where(p_in, ppos, torch.full_like(ppos, Lp)),
                       ar_p)[:Lp]
    l_ok = torch.arange(Lp, device=dev) < torch.sum(p_in)
    inv = scatter_set(torch.full((P,), -1, dtype=torch.int64, device=dev),
                      torch.where(l_ok, lidx, torch.full_like(lidx, P)),
                      torch.arange(Lp, device=dev))
    obs_pt_l = inv[ptc]
    obs_valid = obs_valid & (obs_pt_l >= 0)

    Nc = min(obs_cap if obs_cap > 0 else N, N)
    pos = torch.cumsum(obs_valid.to(torch.int64), dim=1) - 1
    in_slab = obs_valid & (pos < Nc)
    col_of = scatter_set2(
        torch.full((Wtot, Nc + 1), N, dtype=torch.int64, device=dev),
        ww, torch.where(in_slab, pos, torch.full_like(pos, Nc)),
        cols)[:, :Nc]
    c_ok = col_of < N
    cc = torch.clamp(col_of, 0, N - 1)
    wc = torch.arange(Wtot, device=dev)[:, None].expand(Wtot, Nc)

    uv_sel = m.kf_kp_uv[kf_sel]
    ur_sel = m.kf_kp_ur[kf_sel]

    wl = torch.arange(Wtot, device=dev)[:, None].expand(Wtot, Lp)
    own_l = owner[:, torch.clamp(lidx, 0, P - 1)]
    own_c = torch.clamp(own_l, min=0)
    pos_own = pos[wl, own_c]
    own_ok = (own_l >= 0) & l_ok[None, :] & in_slab[wl, own_c]
    pt_obs_slot = torch.where(own_ok, wl * Nc + pos_own,
                              torch.full_like(pos_own, -1)).T

    prob = BAProblem(
        kf_pose=m.kf_pose[kf_sel], kf_fixed=fixed, kf_valid=sel_ok,
        pt_xyz=m.pt_xyz[lidx], pt_valid=l_ok,
        obs_kf=torch.arange(Wtot, device=dev).repeat_interleave(Nc),
        obs_pt=torch.clamp(obs_pt_l, 0, Lp - 1)[wc, cc].reshape(-1),
        obs_uv=uv_sel[wc, cc].reshape(-1, 2),
        obs_ur=torch.where(c_ok, ur_sel[wc, cc],
                           torch.full_like(ur_sel[wc, cc], -1.0)).reshape(-1),
        obs_inv_sigma2=torch.ones(Wtot * Nc, device=dev),
        obs_valid=(c_ok & obs_valid[wc, cc]).reshape(-1))
    return prob, kf_sel, sel_ok, lidx, l_ok, pt_obs_slot, (col_of, c_ok)


def run_local_ba(K, m: MapState, kf_id, window: int, n_fixed: int,
                 inv_sigma2_lvl, iters1: int = 5, iters2: int = 10,
                 pt_cap: int = 8192, W_row=None,
                 obs_cap: int = 0) -> MapState:
    """LocalBundleAdjustment on the covisibility window; results written
    back, rejected observations erased, points left with < 2 observations
    after a rejection die."""
    prob, kf_sel, sel_ok, lidx, l_ok, pt_obs_slot, (col_of, c_ok) = \
        build_local_ba_problem(m, kf_id, window, n_fixed, pt_cap=pt_cap,
                               W_row=W_row, obs_cap=obs_cap)
    N = m.kf_kp_pt.shape[1]
    Wtot = kf_sel.shape[0]
    dev = m.pt_xyz.device
    n_lvl = inv_sigma2_lvl.shape[0]
    block_n = col_of.shape[1]
    wc = torch.arange(Wtot, device=dev)[:, None].expand(Wtot, block_n)
    cc = torch.clamp(col_of, 0, N - 1)
    lvl = m.kf_kp_level[kf_sel][wc, cc].reshape(-1)
    prob = prob._replace(obs_inv_sigma2=inv_sigma2_lvl[
        torch.clamp(lvl, 0, n_lvl - 1).long()])
    kf_pose, pt_xyz, keep = local_ba(K, prob, iters1, iters2,
                                     block_n=block_n,
                                     pt_obs_slot=pt_obs_slot)

    m = m._replace(kf_pose=scatter_set(
        m.kf_pose, kf_sel,
        torch.where(sel_ok[:, None, None], kf_pose, m.kf_pose[kf_sel])))
    m = m._replace(pt_xyz=scatter_set(
        m.pt_xyz, lidx, torch.where(l_ok[:, None], pt_xyz, m.pt_xyz[lidx])))

    P = m.pt_xyz.shape[0]
    pruned = prob.obs_valid & ~keep
    kp_pt_sel = m.kf_kp_pt[kf_sel]
    pr = pruned.reshape(Wtot, block_n) & c_ok
    kp_pt_sel = scatter_set2(
        kp_pt_sel, wc, cc,
        torch.where(pr, torch.full_like(kp_pt_sel[wc, cc], -1),
                    kp_pt_sel[wc, cc]))
    m = m._replace(kf_kp_pt=scatter_set(m.kf_kp_pt, kf_sel, kp_pt_sel))

    Lp = lidx.shape[0]
    n_pruned_l = torch.zeros(Lp, dtype=torch.int32, device=dev).index_add_(
        0, prob.obs_pt.long(), pruned.to(torch.int32))
    n_pruned = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
        0, lidx, torch.where(l_ok, n_pruned_l, torch.zeros_like(n_pruned_l)))
    pt_n_obs = torch.clamp(m.pt_n_obs - n_pruned, min=0)
    died = (n_pruned > 0) & (pt_n_obs < 2)
    pt_valid = m.pt_valid & ~died
    kf_kp_pt2 = torch.where(
        (m.kf_kp_pt >= 0) & pt_valid[torch.clamp(m.kf_kp_pt, 0, P - 1)
                                     .long()],
        m.kf_kp_pt, torch.full_like(m.kf_kp_pt, -1))
    return m._replace(pt_n_obs=pt_n_obs.to(torch.int32), pt_valid=pt_valid,
                      kf_kp_pt=kf_kp_pt2,
                      pt_obj=torch.where(died, torch.full_like(m.pt_obj, -1),
                                         m.pt_obj))


def process_new_keyframe(K, m: MapState, kf_id, scale_factors,
                         inv_sigma2_lvl, cfg, ba_iters=None) -> MapState:
    """The LocalMapping pipeline for one keyframe."""
    W_row = covisibility(m)[kf_id]
    m = map_ops.cull_points(m, kf_id,
                            recency_scope=cfg.mapping.cull_recency_scope)
    m = map_ops.triangulate_new_points(
        m, kf_id, n_neighbors=5, K=K, inv_sigma2_lvl=inv_sigma2_lvl,
        scale_factors=scale_factors, W_row=W_row)
    m = map_ops.fuse_into_neighbors(
        m, kf_id, n_neighbors=5, K=K, scale_factors=scale_factors,
        inv_sigma2_lvl=inv_sigma2_lvl, W_row=W_row)
    if cfg.mapping.reelect_descriptors:
        Kcap = m.kf_kp_pt.shape[0]
        _, stat_nbrs = map_ops._neighbors(m, kf_id, min(15, Kcap), W_row)
        kf_sel_stats = torch.cat([torch.tensor([int(kf_id)],
                                               device=stat_nbrs.device),
                                  stat_nbrs])
        m = recompute_point_stats_windowed(m, kf_sel_stats,
                                           cap=cfg.caps.local_pt_cap)
    it1, it2 = ba_iters if ba_iters is not None else (5, 10)
    m = run_local_ba(m=m, K=K, kf_id=kf_id,
                     window=cfg.caps.local_window_kf, n_fixed=8,
                     inv_sigma2_lvl=inv_sigma2_lvl, iters1=it1, iters2=it2,
                     pt_cap=cfg.caps.local_pt_cap, W_row=W_row,
                     obs_cap=cfg.caps.local_obs_per_kf)
    m = map_ops.cull_keyframes(
        m, kf_id, scale_condition=cfg.mapping.kf_cull_scale_condition,
        n_levels=cfg.orb.n_levels, W_row=W_row)
    return m
