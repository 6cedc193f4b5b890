"""Front-end tracking: the per-frame pose pipeline.

Counterpart of object_slam_tpu/slam/tracking.py: motion-model tracking,
reference-KF tracking, local-map point selection and tracking, the fused
per-frame chain (with the object stages as hooks) and the keyframe
policy, one relocalization attempt against a candidate keyframe
(``relocalize_try``), and localization mode's motion tracking with
temporal VO points (``track_motion_model_vo``). The reference's
``lax.cond`` gates become host ``if``s on device scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from object_slam_tpu_torch.features import matching
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.ops.scatter import scatter_or, scatter_set, topk
from object_slam_tpu_torch.slam.frame import FrameData
from object_slam_tpu_torch.slam.map_state import (MapState, covisibility,
                                                  obs_mask)
from object_slam_tpu_torch.solvers.pose_opt import (PoseObs, pose_optimize,
                                                    pose_optimize_best)

MAX_LOCAL_POINTS = 4096
# offsets into track_frame_fused's packed readback vector
PACKED_TCW = slice(0, 16)
PACKED_TCR = slice(32, 48)
PACKED_OK = 48
PACKED_NEED_KF = 49
PACKED_N_INLIERS = 50
PACKED_N_SEMANTIC = 56
PACKED_NEED_KF_HARD = 57


class TrackResult(NamedTuple):
    Tcw: torch.Tensor
    kp_pt: torch.Tensor          # [N] matched point per keypoint (-1)
    inlier: torch.Tensor         # [N] bool pose-opt inliers
    n_matches: torch.Tensor      # [] int32
    n_inliers: torch.Tensor
    kp_pt_all: Optional[torch.Tensor] = None


def _motion_level_bounds(K, T_pred, T_last, last_level, n_levels):
    """Per-row level bounds for the frame-to-frame search: one-sided
    [last-1, n_levels) under forward motion, [0, last+1] backward, +-1
    otherwise."""
    if T_last is None:
        return None, None
    baseline = K.bf / K.fx
    cw = -T_pred[:3, :3].T @ T_pred[:3, 3]
    tlc_z = T_last[2, :3] @ cw + T_last[2, 3]
    forward = tlc_z > baseline
    backward = tlc_z < -baseline
    lo = torch.where(forward, last_level - 1,
                     torch.where(backward, torch.zeros_like(last_level),
                                 last_level - 1))
    hi = torch.where(forward, torch.full_like(last_level, n_levels - 1),
                     last_level + 1)
    return lo.to(torch.int32), hi.to(torch.int32)


def _match_table(N, midx, mok, vals, device):
    """kp_pt [N] = -1, then .at[clip(midx)].set(where(mok, vals, old))."""
    kp_pt = torch.full((N,), -1, dtype=torch.int32, device=device)
    tgt = torch.clamp(midx, 0, N - 1).long()
    return scatter_set(kp_pt, tgt, torch.where(mok, vals.to(torch.int32),
                                               kp_pt[tgt]))


def track_motion_model(K, m: MapState, frame: FrameData,
                       last_uv, last_pt, last_level, last_valid,
                       T_pred, scale_factors, inv_sigma2_lvl,
                       radius_th: float = 15.0,
                       min_matches: int = 20, T_last=None,
                       last_angle=None) -> TrackResult:
    """SearchByProjection(cur, last) + PoseOptimization."""
    P = m.pt_xyz.shape[0]
    rows_ok = last_valid & (last_pt >= 0)
    ptc = torch.clamp(last_pt, 0, P - 1).long()
    pw = m.pt_xyz[ptc]
    rows_ok = rows_ok & m.pt_valid[ptc]

    pc = se3.apply(T_pred, pw[None])[0]
    uv = cam_mod.project(K, pc)
    rows_ok = rows_ok & (pc[:, 2] > 0) & cam_mod.in_image(K, uv)

    lvl = torch.clamp(last_level, 0, scale_factors.shape[0] - 1)
    radius = radius_th * scale_factors[lvl.long()]
    ur_pred = uv[:, 0] - K.bf / torch.clamp(pc[:, 2], min=1e-6)

    lvl_lo, lvl_hi = _motion_level_bounds(K, T_pred, T_last, lvl,
                                          scale_factors.shape[0])
    midx, mok = matching.search_by_projection(
        uv, last_level, m.pt_desc[ptc], rows_ok,
        frame.uv, frame.level, frame.desc, frame.valid,
        radius_per_row=radius, th_dist=100, nn_ratio=None,
        kp_ur=frame.ur, proj_ur=ur_pred, r_ur=radius,
        lvl_lo=lvl_lo, lvl_hi=lvl_hi,
        angle_a=last_angle, angle_b=frame.angle)
    kp_pt = _match_table(frame.uv.shape[0], midx, mok, last_pt,
                         frame.uv.device)
    return _optimize_from_matches(K, m, frame, T_pred, kp_pt,
                                  inv_sigma2_lvl, min_matches, T_alt=T_last)


def track_motion_model_vo(K, m: MapState, frame: FrameData,
                          last: FrameData, T_pred, scale_factors,
                          inv_sigma2_lvl, radius_th: float = 15.0):
    """Localization-mode motion tracking with temporal VO points
    (Tracking.cc:384-514): every last-frame keypoint with measured depth
    but no map point acts as a temporary 3D point, so tracking survives
    where the frozen map has no coverage. Temporal matches enter the pose
    solve but never gain map-point ids.

    Returns (TrackResult, n_map_inliers []): the second drives the mbVO
    state ("few matches to map points")."""
    P = m.pt_xyz.shape[0]
    N = frame.uv.shape[0]
    dev = frame.uv.device
    ptc = torch.clamp(last.kp_pt, 0, P - 1).long()
    has_pt = last.valid & (last.kp_pt >= 0) & m.pt_valid[ptc]
    temporal = last.valid & ~has_pt & (last.depth > 0)
    rows_ok = has_pt | temporal

    pc_last = cam_mod.backproject(K, last.uv, torch.clamp(last.depth,
                                                          min=1e-6))
    pw_tmp = se3.apply(se3.inverse(last.Tcw), pc_last[None])[0]
    pw = torch.where(has_pt[:, None], m.pt_xyz[ptc], pw_tmp)
    desc = torch.where(has_pt[:, None], m.pt_desc[ptc], last.desc)

    pc = se3.apply(T_pred, pw[None])[0]
    uv = cam_mod.project(K, pc)
    rows_ok = rows_ok & (pc[:, 2] > 0) & cam_mod.in_image(K, uv)
    lvl = torch.clamp(last.level, 0, scale_factors.shape[0] - 1)
    radius = radius_th * scale_factors[lvl.long()]
    ur_pred = uv[:, 0] - K.bf / torch.clamp(pc[:, 2], min=1e-6)

    lvl_lo, lvl_hi = _motion_level_bounds(K, T_pred, last.Tcw, lvl,
                                          scale_factors.shape[0])
    midx, mok = matching.search_by_projection(
        uv, last.level, desc, rows_ok,
        frame.uv, frame.level, frame.desc, frame.valid,
        radius_per_row=radius, th_dist=100, nn_ratio=None,
        kp_ur=frame.ur, proj_ur=ur_pred, r_ur=radius,
        lvl_lo=lvl_lo, lvl_hi=lvl_hi,
        angle_a=last.angle, angle_b=frame.angle)

    tgt = torch.clamp(midx, 0, N - 1).long()
    kp_pw = torch.zeros((N, 3), dtype=pw.dtype, device=dev)
    kp_pw = scatter_set(kp_pw, tgt, torch.where(mok[:, None], pw,
                                                kp_pw[tgt]))
    kp_obs = scatter_or(torch.zeros(N, dtype=torch.bool, device=dev), tgt,
                        mok)
    kp_pt = torch.full((N,), -1, dtype=torch.int32, device=dev)
    kp_pt = scatter_set(kp_pt, tgt, torch.where(mok & has_pt, last.kp_pt,
                                                kp_pt[tgt]))

    matched = kp_obs & frame.valid
    obs = PoseObs(
        uv=frame.uv,
        ur=torch.where(matched, frame.ur, torch.full_like(frame.ur, -1.0)),
        pw=kp_pw,
        inv_sigma2=inv_sigma2_lvl[torch.clamp(
            frame.level, 0, inv_sigma2_lvl.shape[0] - 1).long()],
        valid=matched)
    Tcw, inlier, n_inl = pose_optimize_best(
        K, torch.stack([T_pred, last.Tcw]), obs)
    kp_pt_out = torch.where(inlier, kp_pt, torch.full_like(kp_pt, -1))
    n_map_inl = torch.sum((kp_pt_out >= 0).to(torch.int32))
    res = TrackResult(Tcw=Tcw, kp_pt=kp_pt_out, inlier=inlier,
                      n_matches=torch.sum(matched.to(torch.int32)),
                      n_inliers=n_inl.to(torch.int32), kp_pt_all=kp_pt)
    return res, n_map_inl


def _optimize_from_matches(K, m, frame, T0, kp_pt, inv_sigma2_lvl,
                           min_matches, T_alt=None) -> TrackResult:
    """Pose solve over the matched set; with T_alt both inits run and the
    lower-cost result wins."""
    P = m.pt_xyz.shape[0]
    matched = (kp_pt >= 0) & frame.valid
    ptc = torch.clamp(kp_pt, 0, P - 1).long()
    obs = PoseObs(
        uv=frame.uv,
        ur=torch.where(matched, frame.ur, torch.full_like(frame.ur, -1.0)),
        pw=m.pt_xyz[ptc],
        inv_sigma2=inv_sigma2_lvl[torch.clamp(
            frame.level, 0, inv_sigma2_lvl.shape[0] - 1).long()],
        valid=matched)
    n_matches = torch.sum(matched.to(torch.int32)).to(torch.int32)
    if T_alt is not None:
        Tcw, inlier, n_inl = pose_optimize_best(K, torch.stack([T0, T_alt]),
                                                obs)
    else:
        Tcw, inlier, n_inl = pose_optimize(K, T0, obs)
    kp_pt_out = torch.where(inlier, kp_pt, torch.full_like(kp_pt, -1))
    return TrackResult(Tcw=Tcw, kp_pt=kp_pt_out, inlier=inlier,
                       n_matches=n_matches, n_inliers=n_inl.to(torch.int32),
                       kp_pt_all=kp_pt)


def track_reference_kf(K, m: MapState, frame: FrameData, ref_kf,
                       T0, inv_sigma2_lvl,
                       min_matches: int = 15) -> TrackResult:
    """Brute descriptor match against the reference KF's mapped keypoints,
    then pose optimization."""
    kf_desc = m.kf_kp_desc[ref_kf]
    kf_pt = m.kf_kp_pt[ref_kf]
    P = m.pt_xyz.shape[0]
    rows_ok = m.kf_kp_valid[ref_kf] & (kf_pt >= 0) & \
        m.pt_valid[torch.clamp(kf_pt, 0, P - 1).long()]
    midx, mok = matching.brute_match(
        kf_desc, rows_ok, frame.desc, frame.valid,
        th_dist=50, nn_ratio=0.7,
        angle_a=m.kf_kp_angle[ref_kf], angle_b=frame.angle,
        check_rotation=True)
    kp_pt = _match_table(frame.uv.shape[0], midx, mok, kf_pt,
                         frame.uv.device)
    return _optimize_from_matches(K, m, frame, T0, kp_pt,
                                  inv_sigma2_lvl, min_matches)


def relocalize_try(K, m: MapState, frame: FrameData, kf_id: int, sets_fn,
                   inv_sigma2_lvl) -> TrackResult:
    """One relocalization attempt against candidate keyframe kf_id
    (Tracking.cc:1606-1767): descriptor match to its mapped keypoints, PnP
    RANSAC on the index sets ``sets_fn(matched)`` gives, pose optimization,
    a guided projection re-search over its covisible points, and a final
    optimization. n_inliers is 0 unless the pose is finite and PnP found
    its consensus; the caller accepts at >= 50."""
    from object_slam_tpu_torch.solvers.epnp import pnp_ransac_sets
    N = frame.uv.shape[0]
    P = m.pt_xyz.shape[0]
    Kcap = m.kf_pose.shape[0]
    dev = frame.uv.device

    kf_pt = m.kf_kp_pt[kf_id]
    rows_ok = (m.kf_kp_valid[kf_id] & (kf_pt >= 0)
               & m.pt_valid[torch.clamp(kf_pt, 0, P - 1).long()])
    midx, mok = matching.brute_match(
        m.kf_kp_desc[kf_id], rows_ok, frame.desc, frame.valid,
        th_dist=50, nn_ratio=0.75,
        angle_a=m.kf_kp_angle[kf_id], angle_b=frame.angle)
    kp_pt = _match_table(N, midx, mok, kf_pt, dev)
    matched = (kp_pt >= 0) & frame.valid

    pw = m.pt_xyz[torch.clamp(kp_pt, 0, P - 1).long()]
    pnp = pnp_ransac_sets(sets_fn(matched), K, pw, frame.uv, matched,
                          min_inliers=10)
    tr = _optimize_from_matches(K, m, frame, pnp.Tcw, kp_pt,
                                inv_sigma2_lvl, 10)

    # guided re-search over the candidate's covisible point set
    W = covisibility(m)[kf_id]
    nbr = (W > 0) | (torch.arange(Kcap, device=dev) == kf_id)
    A = m.kf_kp_pt
    cand_pts = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                          torch.clamp(A, 0, P - 1).reshape(-1),
                          ((A >= 0) & m.kf_kp_valid
                           & nbr[:, None]).reshape(-1))
    cand_pts = cand_pts & m.pt_valid
    pc = se3.apply(tr.Tcw, m.pt_xyz[None])[0]
    uv = cam_mod.project(K, pc)
    already = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                         torch.clamp(tr.kp_pt, 0, P - 1), tr.kp_pt >= 0)
    vis = cand_pts & ~already & (pc[:, 2] > 0) & cam_mod.in_image(K, uv)
    kp_free = frame.valid & (tr.kp_pt < 0)
    midx2, mok2 = matching.search_by_projection(
        uv, torch.zeros(P, dtype=torch.int32, device=dev), m.pt_desc, vis,
        frame.uv, frame.level, frame.desc, kp_free,
        radius_per_row=torch.full((P,), 10.0, device=dev), th_dist=100,
        nn_ratio=None, level_window=8)
    tgt2 = torch.clamp(midx2, 0, N - 1).long()
    kp_pt2 = scatter_set(tr.kp_pt, tgt2, torch.where(
        mok2, torch.arange(P, dtype=torch.int32, device=dev),
        tr.kp_pt[tgt2]))

    tr2 = _optimize_from_matches(K, m, frame, tr.Tcw, kp_pt2,
                                 inv_sigma2_lvl, 50)
    sane = torch.all(torch.isfinite(tr2.Tcw)) & pnp.ok
    return tr2._replace(n_inliers=torch.where(
        sane, tr2.n_inliers, torch.zeros_like(tr2.n_inliers)))


def select_local_points(m: MapState, kp_pt, n_local_kf: int = 16,
                        cap: int = MAX_LOCAL_POINTS):
    """Local keyframes (top votes of KFs sharing the frame's points) and
    their points, compacted to ``cap`` with fresh spawns first. Returns
    (local_pts [cap] int64, local_ok [cap], ref_kf int64 [])."""
    Kcap, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    matched = kp_pt >= 0
    ptc = torch.clamp(kp_pt, 0, P - 1).long()

    matched_set = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                             ptc, matched)
    om = obs_mask(m)
    votes = torch.sum(matched_set[torch.clamp(m.kf_kp_pt, 0, P - 1).long()]
                      & om, dim=1)

    _, local_kfs = topk(votes, min(n_local_kf, Kcap))
    kf_ok = votes[local_kfs] > 0

    sel = m.kf_kp_pt[local_kfs]
    sel_ok = (sel >= 0) & m.kf_kp_valid[local_kfs] & kf_ok[:, None]
    local_mask = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                            torch.clamp(sel, 0, P - 1).reshape(-1),
                            sel_ok.reshape(-1))
    local_mask = local_mask & m.pt_valid
    recent = m.pt_first_kf >= m.n_kf - 3
    score = torch.where(local_mask,
                        m.pt_n_obs + torch.where(recent, 100000, 0),
                        torch.full_like(m.pt_n_obs, -1))
    _, local_pts = topk(score, min(cap, P))
    local_ok = score[local_pts] >= 0
    return local_pts, local_ok, local_kfs[0]


def track_local_map(K, m: MapState, frame: FrameData, tr: TrackResult,
                    scale_factors, inv_sigma2_lvl, log_scale: float,
                    radius_th: float = 7.0,
                    view_cos_limit: float = 0.5, T_last=None,
                    local_cap: int = MAX_LOCAL_POINTS,
                    radius_mult: float = 1.0, level_window: int = 1):
    """SearchLocalPoints + pose re-optimization. Returns (TrackResult,
    map with updated visible/found counters, ref_kf)."""
    local_pts, local_ok, ref_kf = select_local_points(m, tr.kp_pt,
                                                      cap=local_cap)
    pw = m.pt_xyz[local_pts]
    ok, uv, z, dist, view_cos = cam_mod.frustum_check(
        K, tr.Tcw, pw, m.pt_normal[local_pts],
        m.pt_min_dist[local_pts] * 0.8, m.pt_max_dist[local_pts] * 1.2,
        view_cos_limit)
    ok = ok & local_ok

    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    already = scatter_or(torch.zeros(P, dtype=torch.bool, device=dev),
                         torch.clamp(tr.kp_pt, 0, P - 1), tr.kp_pt >= 0)
    ok_search = ok & ~already[local_pts]

    lvl = cam_mod.predict_scale_level(dist, m.pt_max_dist[local_pts],
                                      log_scale, scale_factors.shape[0])
    r0 = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                     torch.full_like(view_cos, 4.0))
    radius = r0 * scale_factors[lvl.long()] * (radius_th / 7.0) * radius_mult

    ur_pred = uv[:, 0] - K.bf / torch.clamp(z, min=1e-6)
    kp_free = frame.valid & (tr.kp_pt < 0)
    midx, mok = matching.search_by_projection(
        uv, lvl, m.pt_desc[local_pts], ok_search,
        frame.uv, frame.level, frame.desc, kp_free,
        radius_per_row=radius, th_dist=100, nn_ratio=0.9,
        level_window=level_window,
        kp_ur=frame.ur, proj_ur=ur_pred, r_ur=radius)

    N = frame.uv.shape[0]
    tgt = torch.clamp(midx, 0, N - 1).long()
    kp_pt = scatter_set(tr.kp_pt, tgt,
                        torch.where(mok, local_pts.to(torch.int32),
                                    tr.kp_pt[tgt]))

    res = _optimize_from_matches(K, m, frame, tr.Tcw, kp_pt,
                                 inv_sigma2_lvl, 30, T_alt=T_last)

    vis_ids = torch.where(ok, local_pts, torch.zeros_like(local_pts))
    pt_visible = m.pt_visible.clone()
    pt_visible.index_add_(0, vis_ids, ok.to(torch.int32))
    pt_found = m.pt_found.clone()
    pt_found.index_add_(0, torch.clamp(res.kp_pt, 0, P - 1).long(),
                        (res.kp_pt >= 0).to(torch.int32))
    m = m._replace(pt_visible=pt_visible, pt_found=pt_found)
    return res, m, ref_kf


def kf_decision(n_inliers, n_ref_matches, n_close_tracked,
                n_close_untracked, frames_since_kf,
                max_frames: int, sensor_is_mono: bool = False,
                last_kf_inliers=0, min_gap: int = 0):
    """NeedNewKeyFrame reduced to its decision variables (the single
    source of truth for the policy; works on ints and on tensors)."""
    gap_ok = frames_since_kf >= min_gap
    need_close = (n_close_tracked < 100) & (n_close_untracked > 70) & gap_ok
    ratio = 0.9 if sensor_is_mono else 0.75
    weak = n_inliers < n_ref_matches * ratio
    decayed = (n_inliers < 0.6 * last_kf_inliers) & gap_ok
    c1a = frames_since_kf >= max_frames
    if sensor_is_mono:
        c1c = need_close & False
    else:
        c1c = (n_inliers < n_ref_matches * 0.25) | need_close
    c2 = weak | need_close | decayed
    ok_inliers = n_inliers > 15
    return ok_inliers & (c1a | c1c | c2)


def need_new_keyframe(n_inliers, n_ref_matches, n_close_tracked,
                      n_close_untracked, frames_since_kf,
                      max_frames: int, sensor_is_mono: bool = False,
                      last_kf_inliers: int = 0, min_gap: int = 0):
    """Host wrapper of kf_decision (ints in, bool out)."""
    return bool(kf_decision(n_inliers, n_ref_matches, n_close_tracked,
                            n_close_untracked, frames_since_kf, max_frames,
                            sensor_is_mono, last_kf_inliers, min_gap))


def track_frame_fused(K, m: MapState, frame: FrameData, last: FrameData,
                      velocity, last_kf_id, frames_since_kf, frame_id,
                      last_kf_inliers,
                      scale_factors, inv_sigma2_lvl, log_scale: float,
                      motion_radius: float, close_depth: float,
                      max_frames_between_kf: int,
                      local_cap: int = MAX_LOCAL_POINTS,
                      local_radius_mult: float = 1.0,
                      local_level_window: int = 1,
                      motion_rot_check: bool = True, obj_hooks=None):
    """The per-frame tracking chain: motion model (+ wide retry) ->
    reference-KF fallback -> [object association] -> local map ->
    pre-LOST retry -> [semantic pose refinement] -> [object landmark
    update] -> keyframe decision.

    obj_hooks: None (objects off) or (assoc_fn, semopt_fn, update_fn) of
    slam/objects.ObjectEngine (semopt_fn may be None):
      assoc_fn(m, frame, last) -> obj3d [I]
      semopt_fn(m, frame, tr)  -> (Tcw, kp_pt, inlier, n_sem)
      update_fn(m, frame)      -> (m, obj3d)
    The refined pose and its re-gated matches replace the local-map
    result (the reference's default "full" adoption).

    Returns (m, TrackResult, obj3d, packed [58] f32, vel, ok) with packed
    laid out as in the reference (the PACKED_* offsets):
      0:16 Tcw, 16:32 velocity, 32:48 Tcr, 48 ok, 49 need_kf,
      50 n_inliers, 51 n_matches, 52 ref_kf, 53 n_close_tracked,
      54 n_close_untracked, 55 motion n_inliers, 56 n_semantic,
      57 need_kf with the close/decay triggers suppressed."""
    T_pred = velocity @ last.Tcw
    motion_angle = last.angle if motion_rot_check else None

    def motion(radius):
        return track_motion_model(
            K, m, frame, last.uv, last.kp_pt, last.level, last.valid,
            T_pred, scale_factors, inv_sigma2_lvl, radius_th=radius,
            T_last=last.Tcw, last_angle=motion_angle)

    tr = motion(motion_radius)
    if int(tr.n_matches) < 20:
        tr = motion(2.0 * motion_radius)

    if int(tr.n_matches) < 20 or int(tr.n_inliers) < 10:
        tr_kf = track_reference_kf(K, m, frame, last_kf_id, last.Tcw,
                                   inv_sigma2_lvl)
        if int(tr_kf.n_inliers) > int(tr.n_inliers):
            tr = tr_kf
    tr_motion_inl = tr.n_inliers

    # object association before local-map tracking, at the motion-model
    # pose; skipped when the frame carries no valid detection
    if obj_hooks is not None:
        assoc_fn, semopt_fn, update_fn = obj_hooks
        has_dets = bool(torch.any(frame.obj.valid))
        if has_dets:
            frame = frame._replace(
                obj3d=assoc_fn(m, frame._replace(Tcw=tr.Tcw), last))

    tr2, m2, ref_kf = track_local_map(
        K, m, frame, tr, scale_factors, inv_sigma2_lvl, log_scale,
        T_last=last.Tcw, local_cap=local_cap,
        radius_mult=local_radius_mult, level_window=local_level_window)

    if int(tr2.n_inliers) < 30 and int(tr.n_inliers) >= 10:
        tr_kf = track_reference_kf(K, m, frame, last_kf_id, last.Tcw,
                                   inv_sigma2_lvl)
        tr2b, m2b, refb = track_local_map(
            K, m, frame, tr_kf, scale_factors, inv_sigma2_lvl, log_scale,
            T_last=last.Tcw, local_cap=local_cap,
            radius_mult=local_radius_mult, level_window=local_level_window)
        if int(tr2b.n_inliers) > int(tr2.n_inliers):
            tr2, m2, ref_kf = tr2b, m2b, refb
    m = m2

    # semantically constrained refinement of the local-map pose, when a
    # detection matched a map object
    n_sem = torch.zeros((), dtype=torch.int32, device=frame.uv.device)
    if (obj_hooks is not None and semopt_fn is not None
            and bool(torch.any(frame.obj3d >= 0))):
        Tcw, kp_pt, inl, n_sem = semopt_fn(m, frame, tr2)
        tr2 = tr2._replace(
            Tcw=Tcw, kp_pt=kp_pt, inlier=inl,
            n_inliers=torch.sum((kp_pt >= 0).to(torch.int32)))

    ok = (tr2.n_inliers >= 30) | ((tr2.n_inliers >= 10) & (frame_id < 5))

    # object landmark create/update + map regularization, on a good pose
    obj3d_out = frame.obj3d
    if obj_hooks is not None and has_dets and bool(ok):
        m, obj3d_out = update_fn(
            m, frame._replace(Tcw=tr2.Tcw, kp_pt=tr2.kp_pt))

    close = frame.valid & (frame.depth > 0) & (frame.depth < close_depth)
    tracked = tr2.kp_pt >= 0
    n_close_trk = torch.sum((close & tracked).to(torch.int32))
    n_close_untrk = torch.sum((close & ~tracked).to(torch.int32))
    P = m.pt_xyz.shape[0]
    ref_pt = m.kf_kp_pt[last_kf_id]
    min_obs = 3 if int(m.n_kf) > 2 else 1
    rpc = torch.clamp(ref_pt, 0, P - 1).long()
    ref_matches = torch.sum(((ref_pt >= 0) & (m.pt_n_obs[rpc] >= min_obs)
                             & m.pt_valid[rpc]).to(torch.int32))
    need_kf = ok & kf_decision(
        tr2.n_inliers, ref_matches, n_close_trk, n_close_untrk,
        frames_since_kf, max_frames_between_kf,
        sensor_is_mono=False, last_kf_inliers=last_kf_inliers, min_gap=0)
    need_kf_hard = ok & kf_decision(
        tr2.n_inliers, ref_matches, n_close_trk, n_close_untrk,
        frames_since_kf, max_frames_between_kf,
        sensor_is_mono=False, last_kf_inliers=last_kf_inliers,
        min_gap=10 ** 9)

    vel = tr2.Tcw @ se3.inverse(last.Tcw)
    Kc = m.kf_pose.shape[0]
    Tcr = tr2.Tcw @ se3.inverse(m.kf_pose[min(max(int(last_kf_id), 0),
                                              Kc - 1)])
    f32 = torch.float32
    scalars = torch.stack([
        torch.as_tensor(x, device=tr2.Tcw.device).to(f32) for x in (
            ok, need_kf, tr2.n_inliers, tr2.n_matches, ref_kf, n_close_trk,
            n_close_untrk, tr_motion_inl, n_sem, need_kf_hard)])
    packed = torch.cat([tr2.Tcw.reshape(-1), vel.reshape(-1),
                        Tcr.reshape(-1), scalars])
    return m, tr2, obj3d_out, packed, vel, ok
