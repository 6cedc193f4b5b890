"""Map mutations: keyframe insertion, point spawning, culling,
triangulation, fusion.

Counterpart of object_slam_tpu/slam/map_ops.py. Each function takes a
MapState and returns a new one. The reference's masked scatters keep
their semantics through ops/scatter.py (out-of-range rows dropped, the
last duplicate wins); its ``fori_loop`` bodies are Python loops.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.features import matching
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.geometry import triangulation as tri_mod
from object_slam_tpu_torch.ops.scatter import scatter_add, scatter_set, topk
from object_slam_tpu_torch.slam.frame import FrameData
from object_slam_tpu_torch.slam.map_state import (MapState, covisibility,
                                                  obs_mask)


def _alloc_indices(valid_mask, create_mask, capacity):
    """Free-slot allocation: the k-th created row takes the k-th invalid
    slab row. Returns (idx [N] int64, ok [N], n_valid_after [])."""
    dev = valid_mask.device
    free = ~valid_mask
    fpos = torch.cumsum(free.to(torch.int64), 0) - 1
    free_idx = scatter_set(
        torch.full((capacity + 1,), capacity - 1, dtype=torch.int64,
                   device=dev),
        torch.where(free, fpos, torch.full_like(fpos, capacity)),
        torch.arange(capacity, device=dev))[:capacity]
    n_free = torch.sum(free.to(torch.int64))
    cpos = torch.cumsum(create_mask.to(torch.int64), 0) - 1
    ok = create_mask & (cpos < n_free)
    idx = free_idx[torch.clamp(cpos, 0, capacity - 1)]
    idx = torch.where(ok, idx, torch.full_like(idx, capacity - 1))
    n_valid = (torch.sum(valid_mask.to(torch.int32))
               + torch.sum(ok.to(torch.int32))).to(torch.int32)
    return idx, ok, n_valid


def _masked_rows(arr, idx, ok, vals):
    """arr.at[idx].set(where(ok, vals, arr[idx])) — the reference's
    allocation write, duplicates resolved last-wins."""
    okb = ok.reshape((-1,) + (1,) * (vals.dim() - 1))
    return scatter_set(arr, idx, torch.where(okb, vals.to(arr.dtype),
                                             arr[idx]))


def spawn_points(K, m: MapState, frame: FrameData, kf_id, Tcw,
                 create_mask, scale_factors):
    """Create map points from keypoints with valid depth. Returns
    (m, kp_pt [N]) with the new ids merged into frame.kp_pt."""
    P = m.pt_xyz.shape[0]
    idx, ok, n_pt = _alloc_indices(m.pt_valid, create_mask, P)

    Twc = se3.inverse(Tcw)
    pc = cam_mod.backproject(K, frame.uv, torch.clamp(frame.depth, min=1e-6))
    pw = se3.apply(Twc, pc[None])[0]

    cam_c = Twc[:3, 3]
    view = pw - cam_c
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp(dist[:, None], min=1e-9)
    lvl_scale = scale_factors[torch.clamp(frame.level, 0,
                                          scale_factors.shape[0] - 1).long()]
    max_dist = dist * lvl_scale
    min_dist = max_dist / scale_factors[-1]
    kf_col = torch.full_like(idx, int(kf_id)).to(torch.int32)
    ones = torch.ones_like(idx, dtype=torch.int32)

    m = m._replace(
        pt_xyz=_masked_rows(m.pt_xyz, idx, ok, pw),
        pt_desc=_masked_rows(m.pt_desc, idx, ok, frame.desc),
        pt_normal=_masked_rows(m.pt_normal, idx, ok, normal),
        pt_min_dist=_masked_rows(m.pt_min_dist, idx, ok, min_dist),
        pt_max_dist=_masked_rows(m.pt_max_dist, idx, ok, max_dist),
        pt_valid=_masked_rows(m.pt_valid, idx, ok,
                              torch.ones_like(ok)),
        pt_first_kf=_masked_rows(m.pt_first_kf, idx, ok, kf_col),
        pt_ref_kf=_masked_rows(m.pt_ref_kf, idx, ok, kf_col),
        pt_visible=_masked_rows(m.pt_visible, idx, ok, ones),
        pt_found=_masked_rows(m.pt_found, idx, ok, ones),
        n_pt=n_pt)
    kp_pt = torch.where(ok, idx.to(torch.int32), frame.kp_pt)
    return m, kp_pt


def _set_row(arr, k, row):
    out = arr.clone()
    out[k] = row
    return out


def insert_keyframe(K, m: MapState, frame: FrameData, Tcw,
                    scale_factors, spawn_close_mask, frame_id=-1):
    """Write the KF row, record observations, spawn close points, and set
    the spanning-tree parent (strongest covisible earlier KF). Returns
    (m, kf_id) with kf_id a Python int."""
    K_cap = m.kf_pose.shape[0]
    kf_id = min(int(m.n_kf), K_cap - 1)

    m, kp_pt = spawn_points(K, m, frame, kf_id, Tcw, spawn_close_mask,
                            scale_factors)

    P = m.pt_xyz.shape[0]
    ok = (kp_pt >= 0) & frame.valid
    ptc = torch.clamp(kp_pt, 0, P - 1).long()
    n_kf = torch.clamp(m.n_kf + 1, max=K_cap)
    m = m._replace(
        pt_n_obs=scatter_add(m.pt_n_obs, ptc, ok.to(torch.int32)),
        kf_pose=_set_row(m.kf_pose, kf_id, Tcw),
        kf_valid=_set_row(m.kf_valid, kf_id, True),
        kf_timestamp=_set_row(m.kf_timestamp, kf_id, frame.timestamp),
        kf_kp_uv=_set_row(m.kf_kp_uv, kf_id, frame.uv),
        kf_kp_ur=_set_row(m.kf_kp_ur, kf_id, frame.ur),
        kf_kp_depth=_set_row(m.kf_kp_depth, kf_id, frame.depth),
        kf_kp_level=_set_row(m.kf_kp_level, kf_id, frame.level),
        kf_kp_angle=_set_row(m.kf_kp_angle, kf_id, frame.angle),
        kf_kp_desc=_set_row(m.kf_kp_desc, kf_id, frame.desc),
        kf_kp_valid=_set_row(m.kf_kp_valid, kf_id, frame.valid),
        kf_kp_pt=_set_row(m.kf_kp_pt, kf_id,
                          torch.where(ok, kp_pt, torch.full_like(kp_pt, -1))),
        kf_frame_id=_set_row(m.kf_frame_id, kf_id, int(frame_id)),
        n_kf=n_kf)

    W = covisibility(m)[kf_id]
    earlier = torch.arange(K_cap, device=W.device) < kf_id
    Wv = torch.where(earlier & m.kf_valid, W, torch.full_like(W, -1))
    parent = int(torch.argmax(Wv)) if kf_id > 0 else -1
    m = m._replace(kf_parent=_set_row(m.kf_parent, kf_id, parent))
    return m, kf_id


def cull_points(m: MapState, current_kf_id, min_found_ratio: float = 0.25,
                recency_scope: bool = True):
    """MapPointCulling: drop recent points with found/visible < 0.25, or
    older than 2 KFs with < 3 observations; erase their observations."""
    ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    age = int(current_kf_id) - m.pt_first_kf
    recent = (age < 3) if recency_scope else torch.ones_like(m.pt_valid)
    bad = recent & ((ratio < min_found_ratio) |
                    ((age >= 2) & (m.pt_n_obs < 3)))
    keep = m.pt_valid & ~bad
    P = m.pt_xyz.shape[0]
    kf_kp_pt = torch.where(
        (m.kf_kp_pt >= 0) & keep[torch.clamp(m.kf_kp_pt, 0, P - 1).long()],
        m.kf_kp_pt, torch.full_like(m.kf_kp_pt, -1))
    return m._replace(pt_valid=keep, kf_kp_pt=kf_kp_pt,
                      pt_obj=torch.where(keep, m.pt_obj,
                                         torch.full_like(m.pt_obj, -1)))


def _neighbors(m: MapState, kf_id, n, W_row):
    Kcap = m.kf_kp_pt.shape[0]
    W = covisibility(m)[kf_id] if W_row is None else W_row
    ar = torch.arange(Kcap, device=W.device)
    W = torch.where(m.kf_valid & (ar != kf_id), W, torch.full_like(W, -1))
    _, nbrs = topk(W, n)
    return W, nbrs


def triangulate_new_points(m: MapState, kf_id, n_neighbors: int,
                           K, inv_sigma2_lvl, scale_factors,
                           chi2_gate: float = 5.991, W_row=None):
    """CreateNewMapPoints: epipolar-match the new KF's unmatched keypoints
    against its top covisible neighbors and create points (parallax-gated
    DLT or the measured depth), with the reference's acceptance gates."""
    Kcap, N = m.kf_kp_pt.shape
    dev = m.pt_xyz.device
    W, nbrs = _neighbors(m, kf_id, n_neighbors, W_row)
    nbr_ok_all = W[nbrs] > 0

    T1 = m.kf_pose[kf_id]
    uv1 = m.kf_kp_uv[kf_id]
    desc1 = m.kf_kp_desc[kf_id]
    free1 = m.kf_kp_valid[kf_id] & (m.kf_kp_pt[kf_id] < 0)
    n_lvl = inv_sigma2_lvl.shape[0]
    Km = K.matrix(dev)
    Kinv = torch.linalg.inv(Km)
    baseline = K.bf / K.fx

    def bearing(T, uv):
        xn = torch.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy,
                          torch.ones(uv.shape[0], device=dev)], -1)
        r = xn @ T[:3, :3]
        return r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True),
                               min=1e-9)

    def to_xn(uv):
        return torch.stack([(uv[:, 0] - K.cx) / K.fx,
                            (uv[:, 1] - K.cy) / K.fy], -1)

    def reproj_chi2_fn(T, uv, ur, pw_, lvl_inv_s2):
        pc = se3.apply(T, pw_[None])[0]
        z = pc[:, 2]
        zc = torch.clamp(z, min=1e-6)
        u = K.fx * pc[:, 0] / zc + K.cx
        v = K.fy * pc[:, 1] / zc + K.cy
        urp = u - K.bf / zc
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        e2s = e2 + torch.where(ur >= 0, (urp - ur) ** 2, torch.zeros_like(ur))
        gate = torch.where(ur >= 0, torch.full_like(ur, 7.815),
                           torch.full_like(ur, 5.991))
        return (z > 0) & (e2s * lvl_inv_s2 < gate), z

    for i in range(n_neighbors):
        nb = int(nbrs[i])
        nbr_ok = nbr_ok_all[i]
        T2 = m.kf_pose[nb]
        uv2 = m.kf_kp_uv[nb]
        desc2 = m.kf_kp_desc[nb]
        free2 = m.kf_kp_valid[nb] & (m.kf_kp_pt[nb] < 0)

        T12 = T1 @ se3.inverse(T2)
        R12 = T12[:3, :3]
        t12 = T12[:3, 3]
        E = se3.hat(t12) @ R12
        F21 = Kinv.T @ E @ Kinv
        F12 = F21.T
        c1 = se3.inverse(T1)[:3, 3]
        c1_in2 = T2[:3, :3] @ c1 + T2[:3, 3]
        ex2 = cam_mod.project(K, c1_in2[None])[0]

        inv_s2 = inv_sigma2_lvl[torch.clamp(m.kf_kp_level[nb], 0,
                                            n_lvl - 1).long()]
        midx, mok = matching.search_for_triangulation(
            desc1, uv1, free1, desc2, uv2, free2, F12, ex2, inv_s2,
            angle1=m.kf_kp_angle[kf_id], angle2=m.kf_kp_angle[nb])
        mok = mok & nbr_ok

        mi = torch.clamp(midx, 0, N - 1).long()
        uv2m = uv2[mi]
        ur1 = m.kf_kp_ur[kf_id]
        ur2m = m.kf_kp_ur[nb][mi]
        neg = torch.full_like(ur1, -1.0)
        z1 = torch.where(ur1 >= 0, K.bf / torch.clamp(uv1[:, 0] - ur1,
                                                       min=1e-6), neg)
        z2 = torch.where(ur2m >= 0, K.bf / torch.clamp(uv2m[:, 0] - ur2m,
                                                       min=1e-6), neg)

        cos_rays = torch.sum(bearing(T1, uv1) * bearing(T2, uv2m), -1)
        two = torch.full_like(z1, 2.0)
        half_b = torch.full_like(z1, baseline / 2.0)
        cos_st1 = torch.where(z1 > 0, torch.cos(2.0 * torch.atan2(
            half_b, torch.clamp(z1, min=1e-6))), two)
        cos_st2 = torch.where(z2 > 0, torch.cos(2.0 * torch.atan2(
            half_b, torch.clamp(z2, min=1e-6))), two)
        cos_st = torch.minimum(cos_st1, cos_st2)
        any_st = (z1 > 0) | (z2 > 0)
        tri_sel = (cos_rays < cos_st) & (cos_rays > 0) \
            & (any_st | (cos_rays < 0.9998))

        pw_tri = tri_mod.triangulate_dlt(T1[:3, :4], T2[:3, :4],
                                         to_xn(uv1), to_xn(uv2m))
        T1i = se3.inverse(T1)
        T2i = se3.inverse(T2)
        pw_s1 = se3.apply(T1i, cam_mod.backproject(
            K, uv1, torch.clamp(z1, min=1e-6))[None])[0]
        pw_s2 = se3.apply(T2i, cam_mod.backproject(
            K, uv2m, torch.clamp(z2, min=1e-6))[None])[0]
        use_s1 = ~tri_sel & (z1 > 0) & (cos_st1 <= cos_st2)
        use_s2 = ~tri_sel & ~use_s1 & (z2 > 0)
        pw = torch.where(tri_sel[:, None], pw_tri,
                         torch.where(use_s1[:, None], pw_s1, pw_s2))
        has_src = tri_sel | use_s1 | use_s2

        lvl1 = torch.clamp(m.kf_kp_level[kf_id], 0, n_lvl - 1).long()
        lvl2 = torch.clamp(m.kf_kp_level[nb][mi], 0, n_lvl - 1).long()
        ok1, _ = reproj_chi2_fn(T1, uv1, ur1, pw, inv_sigma2_lvl[lvl1])
        ok2, _ = reproj_chi2_fn(T2, uv2m, ur2m, pw, inv_sigma2_lvl[lvl2])

        d1 = torch.linalg.norm(pw - T1i[:3, 3], dim=-1)
        d2 = torch.linalg.norm(pw - T2i[:3, 3], dim=-1)
        ratio_dist = d2 / torch.clamp(d1, min=1e-9)
        ratio_oct = scale_factors[lvl1] / scale_factors[lvl2]
        ratio_factor = 1.5 * scale_factors[1] / scale_factors[0]
        scale_ok = (ratio_dist * ratio_factor > ratio_oct) \
            & (ratio_dist < ratio_oct * ratio_factor)

        zc1 = se3.apply(T1, pw[None])[0][:, 2]
        zc2 = se3.apply(T2, pw[None])[0][:, 2]
        tru = torch.ones_like(mok)
        depth_ok = torch.where(z1 > 0, torch.abs(zc1 - z1) < 0.15 * z1, tru) \
            & torch.where(z2 > 0, torch.abs(zc2 - z2) < 0.15 * z2, tru)

        create = mok & has_src & ok1 & ok2 & scale_ok & depth_ok \
            & torch.all(torch.isfinite(pw), dim=-1)

        P = m.pt_xyz.shape[0]
        idx, ok, n_pt = _alloc_indices(m.pt_valid, create, P)
        cam_c = se3.inverse(T1)[:3, 3]
        view = pw - cam_c
        dist = torch.linalg.norm(view, dim=-1)
        normal = view / torch.clamp(dist[:, None], min=1e-9)
        lvl = torch.clamp(m.kf_kp_level[kf_id], 0,
                          scale_factors.shape[0] - 1).long()
        max_dist = dist * scale_factors[lvl]
        min_dist = max_dist / scale_factors[-1]
        kf_col = torch.full_like(idx, int(kf_id)).to(torch.int32)

        m = m._replace(
            pt_xyz=_masked_rows(m.pt_xyz, idx, ok, pw),
            pt_desc=_masked_rows(m.pt_desc, idx, ok, desc1),
            pt_normal=_masked_rows(m.pt_normal, idx, ok, normal),
            pt_min_dist=_masked_rows(m.pt_min_dist, idx, ok, min_dist),
            pt_max_dist=_masked_rows(m.pt_max_dist, idx, ok, max_dist),
            pt_valid=_masked_rows(m.pt_valid, idx, ok, torch.ones_like(ok)),
            pt_first_kf=_masked_rows(m.pt_first_kf, idx, ok, kf_col),
            pt_ref_kf=_masked_rows(m.pt_ref_kf, idx, ok, kf_col),
            pt_n_obs=scatter_add(m.pt_n_obs, idx,
                                 torch.where(ok, 2, 0).to(torch.int32)),
            n_pt=n_pt)

        new_pt = torch.where(ok, idx, torch.full_like(idx, -1)) \
            .to(torch.int32)
        kp_pt_1 = m.kf_kp_pt[kf_id]
        kf_kp_pt = _set_row(m.kf_kp_pt, kf_id,
                            torch.where(ok, new_pt, kp_pt_1))
        row = kf_kp_pt[nb]
        row = scatter_set(row, mi, torch.where(ok, new_pt, row[mi]))
        m = m._replace(kf_kp_pt=_set_row(kf_kp_pt, nb, row))
    return m


def cull_keyframes(m: MapState, kf_id, n_check: int = 10,
                   redundancy: float = 0.9, min_obs: int = 3,
                   scale_condition: bool = False, n_levels: int = 8,
                   W_row=None):
    """KeyFrameCulling: a covisible KF is redundant when >= 90% of its
    tracked points have >= 3 other observers; cull up to 3 per pass,
    re-parent children and freeze T_child_parent."""
    Kcap, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    Wrow, cands = _neighbors(m, kf_id, n_check, W_row)
    cand_ok = (Wrow[cands] > 0) & (cands != 0)

    om = obs_mask(m)
    ptc_all = torch.clamp(m.kf_kp_pt, 0, P - 1).long()
    if scale_condition:
        lvl_all = torch.clamp(m.kf_kp_level, 0, n_levels - 1).long()
        idx = (ptc_all * n_levels + lvl_all).reshape(-1)
        cnt = torch.zeros(P * n_levels, dtype=torch.int32, device=dev)
        cnt.index_add_(0, idx, om.reshape(-1).to(torch.int32))
        cnt_le = torch.cumsum(cnt.reshape(P, n_levels), dim=1)
    else:
        # the reference counts incidence (a KF observing a point through
        # two keypoints counts once)
        rows = torch.arange(Kcap, device=dev)[:, None].expand(Kcap, N)
        A = torch.zeros((Kcap, P), dtype=torch.bool, device=dev)
        A[rows[om], ptc_all[om]] = True
        obs_count = torch.sum(A, dim=0)

    kp_pt = m.kf_kp_pt[cands]                               # [C, N]
    tracked = (kp_pt >= 0) & m.kf_kp_valid[cands]
    ptc = torch.clamp(kp_pt, 0, P - 1).long()
    tracked = tracked & m.pt_valid[ptc]
    if scale_condition:
        thr = torch.clamp(m.kf_kp_level[cands] + 1, 0, n_levels - 1).long()
        others = cnt_le[ptc, thr] - 1
    else:
        others = obs_count[ptc] - 1
    red = tracked & (others >= min_obs)
    n_tr = torch.sum(tracked.to(torch.int32), dim=1)
    n_red = torch.sum(red.to(torch.int32), dim=1)
    is_red = (n_tr > 10) & (n_red >= redundancy * n_tr) & cand_ok

    is_red_h = is_red.tolist()
    cands_h = cands.tolist()
    n_culled = 0
    kf_valid, kf_kp_pt = m.kf_valid, m.kf_kp_pt
    kf_parent, kf_tcp = m.kf_parent, m.kf_tcp
    for i in range(n_check):
        vc = min(max(cands_h[i], 0), Kcap - 1)
        if not (is_red_h[i] and bool(kf_valid[vc]) and n_culled < 3):
            continue
        n_culled += 1
        kf_valid = _set_row(kf_valid, vc, False)
        kf_kp_pt = _set_row(kf_kp_pt, vc, -1)
        parent_of_victim = int(kf_parent[vc])
        kf_parent = torch.where(kf_parent == cands_h[i],
                                torch.full_like(kf_parent, parent_of_victim),
                                kf_parent)
        if parent_of_victim >= 0:
            pv = min(max(parent_of_victim, 0), Kcap - 1)
            tcp = m.kf_pose[vc] @ se3.inverse(m.kf_pose[pv])
            kf_tcp = _set_row(kf_tcp, vc, tcp)
    return m._replace(kf_valid=kf_valid, kf_kp_pt=kf_kp_pt,
                      kf_parent=kf_parent, kf_tcp=kf_tcp)


def apply_replacements(m: MapState, fwd, replaced):
    """MapPoint::Replace with explicit forwarding: redirect observations of
    replaced points to their winners and transfer counters."""
    P = m.pt_xyz.shape[0]
    kp = m.kf_kp_pt
    new_kp = torch.where(kp >= 0, fwd[torch.clamp(kp, 0, P - 1).long()]
                         .to(kp.dtype), torch.full_like(kp, -1))
    z = torch.zeros_like(m.pt_visible)
    return m._replace(
        kf_kp_pt=new_kp,
        pt_visible=scatter_add(m.pt_visible, fwd,
                               torch.where(replaced, m.pt_visible, z)),
        pt_found=scatter_add(m.pt_found, fwd,
                             torch.where(replaced, m.pt_found, z)),
        pt_n_obs=scatter_add(m.pt_n_obs, fwd,
                             torch.where(replaced, m.pt_n_obs, z)),
        pt_valid=m.pt_valid & ~replaced,
        pt_obj=torch.where(replaced, torch.full_like(m.pt_obj, -1), m.pt_obj))


def fuse_into_neighbors(m: MapState, kf_id, n_neighbors: int, K,
                        scale_factors, inv_sigma2_lvl, th_dist: int = 50,
                        W_row=None):
    """SearchInNeighbors/Fuse: project the new KF's points into covisible
    neighbors; bind free matching keypoints, and where the keypoint
    already observes another point, the less-observed one forwards to the
    other. The [K, N] rewrite applies once at the end."""
    Kcap, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    W, nbrs = _neighbors(m, kf_id, n_neighbors, W_row)
    fwd_tot = torch.arange(P, device=dev)
    ar_p = torch.arange(P, device=dev)

    for i in range(n_neighbors):
        src_pt0 = m.kf_kp_pt[kf_id]
        src_pt = torch.where(src_pt0 >= 0,
                             fwd_tot[torch.clamp(src_pt0, 0, P - 1).long()],
                             torch.full_like(src_pt0, -1).long())
        ptc = torch.clamp(src_pt, 0, P - 1)
        src_ok = (src_pt >= 0) & m.pt_valid[ptc]
        pw = m.pt_xyz[ptc]
        pdesc = m.pt_desc[ptc]
        nb = int(nbrs[i])
        nbr_ok = W[nb] > 0
        T = m.kf_pose[nb]
        pc = se3.apply(T, pw[None])[0]
        uv = cam_mod.project(K, pc)
        vis = (pc[:, 2] > 0) & cam_mod.in_image(K, uv) & src_ok & nbr_ok
        lvl = m.kf_kp_level[kf_id]
        radius = 3.0 * scale_factors[torch.clamp(
            lvl, 0, scale_factors.shape[0] - 1).long()]
        midx, mok = matching.search_by_projection(
            uv, lvl, pdesc, vis,
            m.kf_kp_uv[nb], m.kf_kp_level[nb],
            m.kf_kp_desc[nb], m.kf_kp_valid[nb],
            radius_per_row=radius, th_dist=th_dist, nn_ratio=None)
        row0 = m.kf_kp_pt[nb].long()
        row = torch.where(row0 >= 0, fwd_tot[torch.clamp(row0, 0, P - 1)],
                          row0)
        mi = torch.clamp(midx, 0, N - 1).long()
        existing = row[mi]
        fresh = mok & (existing < 0)
        row = scatter_set(row, mi, torch.where(fresh, src_pt, row[mi]))
        m = m._replace(
            kf_kp_pt=_set_row(m.kf_kp_pt, nb, row.to(torch.int32)),
            pt_n_obs=scatter_add(m.pt_n_obs, ptc, fresh.to(torch.int32)))

        dup = mok & (existing >= 0) & (existing != src_pt) \
            & m.pt_valid[torch.clamp(existing, 0, P - 1)]
        ec = torch.clamp(existing, 0, P - 1)
        keep_existing = m.pt_n_obs[ec] >= m.pt_n_obs[ptc]
        winner = torch.where(keep_existing, existing, src_pt)
        loser = torch.where(keep_existing, src_pt, existing)
        lc = torch.clamp(loser, 0, P - 1)
        fwd = scatter_set(ar_p, lc, torch.where(dup, winner, ar_p[lc]))
        fwd_tot = fwd[fwd_tot]

    replaced = (fwd_tot != ar_p) & m.pt_valid
    if bool(torch.any(replaced)):
        m = apply_replacements(m, fwd_tot, replaced)
    return m
