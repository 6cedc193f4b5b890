"""Object landmarks: association, lifecycle, merging, and the semantically
constrained pose optimizer.

Counterpart of object_slam_tpu/slam/objects.py, the fused path's stages:

  * association: frame-to-frame (HSV cosine > 0.8 and 2D IoU > 0.5 among
    same-label detections, one [I, I] score matrix) then map-to-frame
    (best-over-history HSV similarity and centroid distances, [J, Hc, I]);
  * lifecycle: create / bind / label voting, the history rings, per-object
    3-sigma and small-cluster rejection (one batched [I, 512, 512]
    label propagation over the matched objects, not a loop), the label
    membership gate, validity, and the pairwise AABB merge;
  * semantic refinement: pose-only Gauss-Newton with mask-attraction edges
    answered by the frame's feature-transform maps, 4 rounds x 10 steps
    with fixed counts and no read back to the host.

The staged path (a LOST frame's, or ``tracking.fused=False``) runs the
local-map search and the same optimizer through
``track_local_map_semantic``.

The reference's scatters keep their semantics through ops/scatter.py
(duplicate indices: last write wins; out-of-range indices dropped;
``lax.top_k`` ties by the lower index).
"""

from __future__ import annotations

import math

import torch

from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.ops.distance_transform import (
    nearest_mask_pixel_batched)
from object_slam_tpu_torch.ops.scatter import scatter_or, scatter_set, topk
from object_slam_tpu_torch.semantic.hsv import cosine_similarity
from object_slam_tpu_torch.semantic.object2d import bbox_iou_2d
from object_slam_tpu_torch.slam.frame import FrameData
from object_slam_tpu_torch.slam import tracking as trk
from object_slam_tpu_torch.slam.map_state import MapState, N_LABEL_SLOTS
from object_slam_tpu_torch.slam.tracking import TrackResult
from object_slam_tpu_torch.solvers.pose_opt import (PoseObs, edge_chi2,
                                                    huber_weight,
                                                    reproj_residual_jac)

MAX_SEM_POINTS = 2048     # static slab of object member points per frame
MAX_CLUSTER_POINTS = 512  # per-object clustering slab


def _clip(idx, n: int):
    return torch.clamp(idx, 0, n - 1).long()


def _scatter_max(dst, idx, vals):
    """``dst.at[idx].max(vals)`` for in-range idx."""
    return dst.scatter_reduce(0, idx.long(), vals.to(dst.dtype), "amax",
                              include_self=True)


def _segment_max(vals, seg, n: int):
    """jax.ops.segment_max: empty segments stay at -inf."""
    return _scatter_max(torch.full((n,), -torch.inf, dtype=vals.dtype,
                                   device=vals.device), seg, vals)


def _det_of_obj(obj3d, J: int):
    """[J] detection index per map object (-1), by scatter-max: invalid
    rows clip to object 0 and never win."""
    I = obj3d.shape[0]
    ar = torch.arange(I, device=obj3d.device, dtype=torch.int32)
    return _scatter_max(torch.full((J,), -1, dtype=torch.int32,
                                   device=obj3d.device),
                        _clip(obj3d, J),
                        torch.where(obj3d >= 0, ar, torch.full_like(ar, -1)))


def _centers_world(K, frame: FrameData):
    """Detection centroids unprojected at their mean depth, in the world."""
    Twc = se3.inverse(frame.Tcw)
    pc = cam_mod.backproject(K, frame.obj.centroid_uv,
                             torch.clamp(frame.obj.mean_depth, min=1e-6))
    return Twc, se3.apply(Twc, pc[None])[0]


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------

def match_two_frame(m: MapState, frame: FrameData, last: FrameData):
    """Frame-to-frame: carry the last frame's Object3D ids onto the current
    detections by appearance + box overlap. Returns obj3d [I] int32."""
    I = frame.obj.label.shape[0]
    dev = frame.obj.label.device
    last_ok = last.obj.valid & (last.obj3d >= 0)
    sim = cosine_similarity(last.obj.hist[:, None, :],
                            frame.obj.hist[None, :, :])          # [I, I]
    iou = bbox_iou_2d(last.obj.bbox, frame.obj.bbox)
    same_label = last.obj.label[:, None] == frame.obj.label[None, :]
    ok = (same_label & last_ok[:, None] & frame.obj.valid[None, :]
          & (sim > 0.8) & (iou > 0.5))
    score = torch.where(ok, sim, torch.full_like(sim, -1.0))
    best_s = torch.max(score, dim=1).values
    best_det = torch.argmax(score, dim=1)         # the first maximum
    best_ok = best_s > 0
    # one-to-one: a current det takes the best-scoring claimant
    claim = _clip(torch.where(best_ok, best_det, torch.full_like(best_det,
                                                                 -1)), I)
    claim_score = torch.where(best_ok, best_s, torch.full_like(best_s, -1.0))
    order_best = _segment_max(claim_score, claim, I)
    winner = best_ok & (claim_score >= order_best[claim])
    return _scatter_max(torch.full((I,), -1, dtype=torch.int32, device=dev),
                        claim, torch.where(winner, last.obj3d,
                                           torch.full_like(last.obj3d, -1)))


def match_map_to_frame(m: MapState, frame: FrameData, obj3d, K,
                       mean_dist_max: float, min_dist_max: float = 0.1):
    """Map-to-frame association for the detections still unmatched."""
    I = frame.obj.label.shape[0]
    J = m.obj_valid.shape[0]
    Hc = m.obj_hist_ring.shape[1]
    dev = obj3d.device

    taken = scatter_or(torch.zeros(J, dtype=torch.bool, device=dev),
                       _clip(obj3d, J), obj3d >= 0)
    obj_ok = m.obj_valid & ~taken & (m.obj_replaced < 0)
    det_ok = frame.obj.valid & (obj3d < 0)

    # appearance: best over the history ring
    ring_n = m.obj_hist_n[:, None] > torch.arange(Hc, device=dev)[None, :]
    sims = cosine_similarity(m.obj_hist_ring[:, :, None, :],
                             frame.obj.hist[None, None, :, :])  # [J, Hc, I]
    sims = torch.where(ring_n[:, :, None], sims, torch.full_like(sims, -1.0))
    sim_best = torch.max(sims, dim=1).values                     # [J, I]

    # geometry: the detection centroid unprojected at its mean depth
    _, pw = _centers_world(K, frame)                             # [I, 3]
    diff = m.obj_center_ring[:, :, None, :] - pw[None, None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))               # [J, Hc, I]
    d = torch.where(ring_n[:, :, None], d, torch.full_like(d, torch.inf))
    n_hist = torch.clamp(m.obj_hist_n[:, None], min=1)
    mean_d = torch.sum(torch.where(torch.isfinite(d), d,
                                   torch.zeros_like(d)), dim=1) / n_hist
    min_d = torch.min(d, dim=1).values

    same_label = m.obj_label[:, None] == frame.obj.label[None, :]
    ok = (same_label & obj_ok[:, None] & det_ok[None, :]
          & (sim_best > 0.8)
          & ((mean_d < mean_dist_max) | (min_d < min_dist_max)))
    score = torch.where(ok, sim_best, torch.full_like(sim_best, -1.0))
    best_det = _clip(torch.argmax(score, dim=1), I)
    best_s = torch.max(score, dim=1).values
    best_ok = best_s > 0
    # winner per detection
    col_best = _segment_max(torch.where(best_ok, best_s,
                                        torch.full_like(best_s, -1.0)),
                            best_det, I)
    winner = best_ok & (best_s >= col_best[best_det])
    ar_j = torch.arange(J, device=dev, dtype=torch.int32)
    return _scatter_max(obj3d, best_det,
                        torch.where(winner, ar_j, torch.full_like(ar_j, -1)))


# ---------------------------------------------------------------------------
# Lifecycle: create / update / reject / merge
# ---------------------------------------------------------------------------

def _cluster_reject(pts, valid, centroid, tol: float,
                    sigma_gate: float = 3.0,
                    small_frac: float = 0.1, min_n_for_cluster: int = 15,
                    n_prop: int = 12):
    """Batched over objects: pts [B, n, 3], valid [B, n], centroid [B, 3].
    Drop points > 3 sigma from the centroid; with enough points, also drop
    the connected components (distance < tol) holding < 10% of the kept
    points. Label propagation stands in for euclidean cluster extraction.
    Returns the keep mask [B, n]."""
    B, n = valid.shape
    dev = pts.device
    diff = pts - centroid[:, None]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    zero = torch.zeros_like(d)
    nv = torch.clamp(torch.sum(valid.to(torch.float32), dim=1), min=1.0)
    mu = torch.sum(torch.where(valid, d, zero), dim=1) / nv
    var = torch.sum(torch.where(valid, (d - mu[:, None]) ** 2, zero),
                    dim=1) / nv
    keep = valid & (d <= (mu + sigma_gate * torch.sqrt(var))[:, None])

    # connected components by distance < tol
    pd = pts[:, :, None] - pts[:, None, :]
    dist2 = torch.sum(pd * pd, dim=-1)                           # [B, n, n]
    adj = (dist2 < tol * tol) & keep[:, :, None] & keep[:, None, :]
    ar = torch.arange(n, device=dev).expand(B, n)
    labels = torch.where(keep, ar, torch.full_like(ar, n))
    for _ in range(n_prop):
        neigh = torch.where(adj, labels[:, None, :],
                            torch.full_like(labels[:, None, :], n))
        labels = torch.minimum(labels, torch.min(neigh, dim=2).values)
    sizes = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    sizes.scatter_add_(1, labels, keep.to(torch.int32))
    total = torch.sum(keep.to(torch.int32), dim=1)
    big = torch.gather(sizes, 1, labels) >= small_frac * total[:, None]
    apply_cluster = total > min_n_for_cluster
    return keep & (big | ~apply_cluster[:, None])


class ObjectEngine:
    """The object subsystem: the fused chain's association, update and
    semantic-refinement stages, and the semantic-constraint counter."""

    def __init__(self, cfg, K, device=None):
        device = resolve_device(device)
        self.cfg = cfg
        self.K = K
        self.tol = (cfg.objects.cluster_tolerance_indoor if cfg.indoor
                    else cfg.objects.cluster_tolerance_outdoor)
        self.mean_dist_max = (cfg.objects.mean_dist_max_indoor if cfg.indoor
                              else cfg.objects.mean_dist_max_outdoor)
        self.label_slots = {lab: i for i, lab in enumerate(
            (cfg.semantic.valid_labels_tum if cfg.indoor
             else cfg.semantic.valid_labels_kitti)[:N_LABEL_SLOTS])}
        self.semantic_constraints = 0  # N_AllSemanticConstraintNum analogue
        lut = torch.full((256,), -1, dtype=torch.int32)
        for lab, slot in self.label_slots.items():
            lut[lab] = slot
        self.lut = lut.to(device)
        scale = cfg.orb.scale_factor
        self.inv_sigma2_lvl = torch.tensor(
            [1.0 / scale ** (2 * l) for l in range(cfg.orb.n_levels)],
            dtype=torch.float32, device=device)
        self.scale_factors = torch.tensor(
            [scale ** l for l in range(cfg.orb.n_levels)],
            dtype=torch.float32, device=device)

    # -- association ----------------------------------------------------
    def associate(self, m: MapState, frame: FrameData,
                  last: FrameData) -> FrameData:
        return frame._replace(obj3d=self.assoc_impl(m, frame, last))

    def assoc_impl(self, m, frame, last):
        obj3d = match_two_frame(m, frame, last)
        # forward merged objects (CheckReplacedObjInLastFrame analogue)
        J = m.obj_valid.shape[0]
        oc = _clip(obj3d, J)
        fwd = m.obj_replaced[oc]
        obj3d = torch.where((obj3d >= 0) & (fwd >= 0), fwd, obj3d)
        obj3d = torch.where((obj3d >= 0) & m.obj_valid[_clip(obj3d, J)],
                            obj3d, torch.full_like(obj3d, -1))
        return match_map_to_frame(m, frame, obj3d, self.K,
                                  self.mean_dist_max,
                                  self.cfg.objects.min_dist_max)

    # -- lifecycle -------------------------------------------------------
    def update(self, m: MapState, frame: FrameData):
        m2, obj3d = self.update_impl(m, frame)
        return m2, frame._replace(obj3d=obj3d)

    def update_impl(self, m: MapState, frame: FrameData):
        cfg = self.cfg.objects
        I = frame.obj.label.shape[0]
        J = m.obj_valid.shape[0]
        P = m.pt_xyz.shape[0]
        Hc = m.obj_hist_ring.shape[1]
        dev = m.pt_xyz.device
        i32 = torch.int32
        obj3d = frame.obj3d
        kp2obj = frame.obj.kp2obj
        kc = _clip(kp2obj, I)

        # --- create new objects for unmatched detections with 3D support
        det_pts = (kp2obj >= 0) & (frame.kp_pt >= 0) & frame.valid
        n3d = torch.zeros(I, dtype=i32, device=dev).index_add_(
            0, kc, det_pts.to(i32))
        create = frame.obj.valid & (obj3d < 0) & (n3d > cfg.min_points_valid)
        offs = torch.cumsum(create.to(i32), 0).to(i32) - 1
        new_slot = torch.clamp(m.n_obj + offs, max=J - 1)
        can = create & (m.n_obj + offs < J)
        obj3d = torch.where(can, new_slot, obj3d)
        track_ids = m.next_track_id + offs
        # dead rows go out of bounds and are dropped
        slot_s = torch.where(can, new_slot, torch.full_like(new_slot, J))
        n_can = torch.sum(can.to(i32))
        m = m._replace(
            obj_valid=scatter_set(m.obj_valid, slot_s, True),
            obj_label=scatter_set(m.obj_label, slot_s, frame.obj.label),
            obj_track_id=scatter_set(m.obj_track_id, slot_s, track_ids),
            obj_replaced=scatter_set(m.obj_replaced, slot_s, -1),
            n_obj=torch.clamp(m.n_obj + n_can, max=J).to(i32),
            next_track_id=(m.next_track_id + n_can).to(i32))

        # --- bind member points: pt_obj[p] = matched object (duplicate
        # indices: the last write wins, as XLA's scatter)
        kp_obj = torch.where(kp2obj >= 0, obj3d[kc],
                             torch.full_like(kp2obj, -1))
        bind = (kp_obj >= 0) & (frame.kp_pt >= 0) & frame.valid
        ptc = _clip(frame.kp_pt, P)
        m = m._replace(pt_obj=scatter_set(
            m.pt_obj, ptc, torch.where(bind, kp_obj, m.pt_obj[ptc])))

        # --- label voting (Tracking.cc:1083-1099 + MapPoint::AddLabelCnt)
        det_lab = frame.obj.label[kc]
        slot = self.lut[torch.clamp(det_lab, 0, 255).long()]
        vote = (bind & (slot >= 0)).to(i32)
        lin = ptc * N_LABEL_SLOTS + _clip(slot, N_LABEL_SLOTS)
        cnt = m.pt_label_cnt.reshape(-1).clone().index_add_(0, lin, vote)
        m = m._replace(
            pt_label_cnt=cnt.reshape(P, N_LABEL_SLOTS),
            pt_label_tot=m.pt_label_tot.clone().index_add_(0, ptc, vote))

        # --- per-matched-object update: history ring + centroid/bbox +
        #     outlier rejection
        oc = _clip(obj3d, J)
        matched_obj = scatter_or(torch.zeros(J, dtype=torch.bool, device=dev),
                                 oc, obj3d >= 0)
        det_of_obj = _det_of_obj(obj3d, J)
        Twc, centers_w = _centers_world(self.K, frame)            # [I, 3]
        cam_c = Twc[:3, 3]

        ar_j = torch.arange(J, device=dev)
        ring_pos = torch.remainder(m.obj_hist_n, Hc).long()
        dsel = _clip(det_of_obj, I)
        mo = matched_obj[:, None]

        def ring(r, new):
            r = r.clone()
            r[ar_j, ring_pos] = torch.where(mo, new, r[ar_j, ring_pos])
            return r

        m = m._replace(
            obj_hist_ring=ring(m.obj_hist_ring, frame.obj.hist[dsel]),
            obj_center_ring=ring(m.obj_center_ring, centers_w[dsel]),
            obj_campos_ring=ring(m.obj_campos_ring,
                                 cam_c[None].expand(J, 3)),
            obj_hist_n=m.obj_hist_n + matched_obj.to(i32),
            obj_n_updates=m.obj_n_updates + matched_obj.to(i32))

        # --- outlier rejection + stats for each matched object
        m = self._reject_and_stats(m, matched_obj)

        # --- label-probability membership gate (ObjectTypes.cc:143-148)
        owner = _clip(m.pt_obj, J)
        oslot = self.lut[torch.clamp(m.obj_label[owner], 0, 255).long()]
        sel = (torch.arange(N_LABEL_SLOTS, device=dev)[None, :]
               == torch.clamp(oslot, 0, N_LABEL_SLOTS - 1)[:, None])
        prob = torch.sum(torch.where(sel, m.pt_label_cnt,
                                     torch.zeros_like(m.pt_label_cnt)),
                         dim=1) / torch.clamp(m.pt_label_tot, min=1)
        bad_member = ((m.pt_obj >= 0) & (m.pt_label_tot > 2)
                      & (prob < cfg.label_prob_min))
        m = m._replace(pt_obj=torch.where(bad_member,
                                          torch.full_like(m.pt_obj, -1),
                                          m.pt_obj))

        # --- validity: > 5 updates and < 5 points -> invalid
        n_pts = torch.zeros(J, dtype=i32, device=dev).index_add_(
            0, _clip(m.pt_obj, J), (m.pt_obj >= 0).to(i32))
        invalid = ((m.obj_n_updates > cfg.min_updates_for_validity)
                   & (n_pts < cfg.min_points_valid))
        m = m._replace(obj_valid=m.obj_valid & ~invalid)

        # --- map regularization: pairwise merge
        return self._regularize(m), obj3d

    def _reject_and_stats(self, m: MapState, matched_obj):
        """3-sigma + cluster rejection of the matched objects' member
        points (compacted to MAX_CLUSTER_POINTS each, in point order), then
        their centroid / AABB refresh. One batched computation over the
        [<= I] matched slots."""
        J = m.obj_valid.shape[0]
        P = m.pt_xyz.shape[0]
        I = min(self.cfg.semantic.max_instances, J)
        C = MAX_CLUSTER_POINTS
        cfg = self.cfg.objects
        dev = m.pt_xyz.device

        do_slot = matched_obj & m.obj_valid
        _, oidx = topk(do_slot.to(torch.float32), I)                 # [I]
        o_ok = do_slot[oidx]

        member = ((m.pt_obj[None, :] == oidx[:, None]) & m.pt_valid[None, :]
                  & o_ok[:, None])                                   # [I, P]
        # cumsum compaction: one pass over P, no sort
        pos = torch.cumsum(member.to(torch.int32), dim=1) - 1
        in_slab = member & (pos < C)
        slot = torch.where(in_slab, pos, torch.full_like(pos, C)).long()
        # rows past the slab all land in the spare column C, cut off
        lin = torch.arange(I, device=dev)[:, None] * (C + 1) + slot
        idx = torch.full((I * (C + 1),), P - 1, dtype=torch.int64,
                         device=dev)
        idx.scatter_(0, lin.reshape(-1),
                     torch.arange(P, device=dev).expand(I, P).reshape(-1))
        idx = idx.reshape(I, C + 1)[:, :C]
        n_member = torch.sum(in_slab.to(torch.int32), dim=1)
        ok = torch.arange(C, device=dev)[None, :] < n_member[:, None]
        pts = m.pt_xyz[idx]                                          # [I, C, 3]
        w = ok.to(torch.float32)[..., None]
        centroid = torch.sum(pts * w, dim=1) / torch.clamp(
            torch.sum(w, dim=1), min=1.0)
        keep = _cluster_reject(pts, ok, centroid, self.tol, cfg.sigma_gate,
                               cfg.small_cluster_frac,
                               cfg.small_cluster_min_n)
        drop_ids = torch.where(ok & ~keep & o_ok[:, None], idx,
                               torch.full_like(idx, P - 1)).reshape(-1)
        w2 = keep.to(torch.float32)[..., None]
        c2 = torch.sum(pts * w2, dim=1) / torch.clamp(torch.sum(w2, dim=1),
                                                      min=1.0)
        kp = keep[..., None]
        mn = torch.min(torch.where(kp, pts, torch.full_like(pts, torch.inf)),
                       dim=1).values
        mx = torch.max(torch.where(kp, pts, torch.full_like(pts, -torch.inf)),
                       dim=1).values

        pt_obj = scatter_set(m.pt_obj, drop_ids,
                             torch.where(drop_ids < P - 1,
                                         torch.full_like(drop_ids, -1),
                                         m.pt_obj[drop_ids].long()))
        # the refreshed stats go back to the matched slots only
        osel = torch.where(o_ok, oidx, torch.full_like(oidx, J))
        return m._replace(
            pt_obj=pt_obj,
            obj_centroid=scatter_set(m.obj_centroid, osel, c2),
            obj_bbox=scatter_set(m.obj_bbox, osel, torch.cat([mn, mx], -1)))

    def _regularize(self, m: MapState):
        """ObjectMapRegularization: merge same-label objects whose AABB
        overlap ratio > merge_overlap_min into the larger-track-id one."""
        J = m.obj_valid.shape[0]
        dev = m.obj_valid.device
        mn_a, mx_a = m.obj_bbox[:, :3], m.obj_bbox[:, 3:]
        inter = torch.clamp(torch.minimum(mx_a[:, None], mx_a[None])
                            - torch.maximum(mn_a[:, None], mn_a[None]),
                            min=0.0)
        ivol = inter[..., 0] * inter[..., 1] * inter[..., 2]
        ext = mx_a - mn_a
        vol = torch.clamp(ext[:, 0] * ext[:, 1] * ext[:, 2], min=1e-9)
        ratio = ivol / torch.minimum(vol[:, None], vol[None])
        ar = torch.arange(J, device=dev)
        same = ((m.obj_label[:, None] == m.obj_label[None])
                & m.obj_valid[:, None] & m.obj_valid[None]
                & (ar[:, None] != ar[None]))
        mergeable = same & (ratio > self.cfg.objects.merge_overlap_min)

        # target: the partner with the largest track id, if larger than mine
        tid = m.obj_track_id
        partner_tid = torch.where(mergeable, tid[None, :],
                                  torch.full_like(mergeable, -1,
                                                  dtype=tid.dtype))
        best_partner = torch.argmax(partner_tid, dim=1)
        best_tid = torch.max(partner_tid, dim=1).values
        absorb = (best_tid > tid) & torch.any(mergeable, dim=1)
        target = torch.where(absorb, best_partner, ar)
        target = target[target]     # one hop handles chains across frames

        owner = _clip(m.pt_obj, J)
        new_owner = torch.where(m.pt_obj >= 0, target[owner].to(torch.int32),
                                m.pt_obj)
        return m._replace(
            pt_obj=new_owner,
            obj_valid=m.obj_valid & ~absorb,
            obj_replaced=torch.where(absorb, target.to(torch.int32),
                                     m.obj_replaced))

    # -- semantically constrained pose optimization ---------------------
    def track_local_map_semantic(self, m: MapState, frame: FrameData,
                                 tr: TrackResult):
        """The staged path's local-map tracking with the object edges in
        the final pose solve (TrackLocalMap -> PoseOptimization2,
        Tracking.cc:1011-1022): the local-map search and first solve at
        the reference's default windows, then semopt_impl. Returns
        (TrackResult, map with the search's visible / found counters, n_sem
        device scalar, the pre-refinement pose)."""
        o = self.cfg.orb
        res, m, _ = trk.track_local_map(
            self.K, m, frame, tr, self.scale_factors, self.inv_sigma2_lvl,
            math.log(o.scale_factor), local_cap=self.cfg.caps.local_search_pts)
        Tcw, kp_pt, inl, n_sem = self.semopt_impl(m, frame, res)
        return TrackResult(Tcw=Tcw, kp_pt=kp_pt, inlier=inl,
                           n_matches=res.n_matches,
                           n_inliers=torch.sum((kp_pt >= 0).to(torch.int32))
                           ), m, n_sem, res.Tcw

    def semopt_impl(self, m: MapState, frame: FrameData, res: TrackResult):
        """PoseOptimization2: standard edges plus M_joint / M_semantic
        mask-attraction edges, 4 rounds x 10 GN steps. Returns (Tcw, kp_pt,
        inlier, n_sem) with n_sem a device scalar."""
        cfg = self.cfg.solver
        K = self.K
        P = m.pt_xyz.shape[0]
        I = frame.obj.label.shape[0]
        J = m.obj_valid.shape[0]
        N = frame.uv.shape[0]
        dev = m.pt_xyz.device
        gate = cfg.sem_reproj_gate_px

        # ------ standard edges (matched keypoints)
        matched = (res.kp_pt >= 0) & frame.valid
        ptc = _clip(res.kp_pt, P)
        lv = self.inv_sigma2_lvl
        obs = PoseObs(
            uv=frame.uv,
            ur=torch.where(matched, frame.ur, torch.full_like(frame.ur, -1.0)),
            pw=m.pt_xyz[ptc],
            inv_sigma2=lv[torch.clamp(frame.level, 0, lv.shape[0] - 1).long()],
            valid=matched)

        # ------ semantic point slab: members of matched objects
        det_of_obj = _det_of_obj(frame.obj3d, J)
        p_det = torch.where(m.pt_obj >= 0, det_of_obj[_clip(m.pt_obj, J)],
                            torch.full_like(m.pt_obj, -1))           # [P]
        sem_ok = (p_det >= 0) & m.pt_valid
        _, sidx = topk(sem_ok.to(torch.float32), min(MAX_SEM_POINTS, P))
        s_ok = sem_ok[sidx]
        s_pw = m.pt_xyz[sidx]
        s_det = _clip(p_det[sidx], I)

        # M_joint candidates: matched in the frame, keypoint outside the
        # mask (unmatched rows clip to point 0 and write it in order)
        ar_n = torch.arange(N, device=dev, dtype=torch.int32)
        kp_of_pt = scatter_set(
            torch.full((P,), -1, dtype=torch.int32, device=dev), ptc,
            torch.where(matched, ar_n, torch.full_like(ar_n, -1)))
        s_kp = kp_of_pt[sidx]
        s_joint = s_ok & (s_kp >= 0) & (
            frame.obj.kp2obj[_clip(s_kp, N)].long() != s_det)
        s_semantic = s_ok

        ftmaps = frame.obj.ftmap                               # [I, C, C, 2]
        ft_org = frame.obj.ft_origin[s_det]                    # [S, 2] (y, x)
        org_uv = torch.stack([ft_org[:, 1], ft_org[:, 0]], -1).to(
            torch.float32)

        def nearest(uv):
            # the maps are crop-local: shift queries in, answers back
            near_l, d = nearest_mask_pixel_batched(ftmaps, s_det, uv - org_uv)
            return near_l + org_uv, d

        def project(T):
            pc = se3.apply(T, s_pw[None])[0]
            return cam_mod.project(K, pc), pc[:, 2], pc

        eye = torch.eye(3, device=dev).expand(s_pw.shape[0], 3, 3)
        eye6 = 1e-5 * torch.eye(6, device=dev)

        def gn_iter(Tc, tgt, active, std_active):
            # standard edges
            r, Jb, stereo, z = reproj_residual_jac(K, Tc, obs)
            chi2 = edge_chi2(r, obs.inv_sigma2, stereo)
            delta2 = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
            w = huber_weight(chi2, delta2) * obs.inv_sigma2
            w = torch.where(std_active & (z > 0), w, torch.zeros_like(w))
            Jw = Jb * w[..., None, None]
            H = torch.einsum('nij,nik->jk', Jw, Jb)
            b = -torch.einsum('nij,ni->j', Jw, r)
            # semantic edges: e = tgt - proj(p), the target fixed per round
            uvs, zs, pc = project(Tc)
            es = tgt - uvs
            x, y = pc[:, 0], pc[:, 1]
            zz = torch.clamp(pc[:, 2], min=1e-6)
            iz = 1.0 / zz
            iz2 = iz * iz
            zero = torch.zeros_like(zz)
            du = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], -1)
            dv = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], -1)
            dproj = torch.stack([du, dv], -2)
            dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)
            Js = -(dproj @ dpc)                                   # [S, 2, 6]
            chi2s = torch.sum(es * es, -1)
            ws = huber_weight(chi2s, cfg.chi2_mono)
            ws = torch.where(active & (zs > 0), ws, torch.zeros_like(ws))
            Jsw = Js * ws[:, None, None]
            H2 = H + torch.einsum('nij,nik->jk', Jsw, Js) + eye6
            b2 = b - torch.einsum('nij,ni->j', Jsw, es)
            dx = torch.linalg.solve_ex(H2, b2)[0]
            return se3.retract(Tc, dx)

        # initial-pose gating for M_semantic (ObjectOptimizer.cc:977-1032)
        uv0, z0, _ = project(res.Tcw)
        _, d0 = nearest(uv0)
        sem_active = s_semantic & (z0 > 0) & (d0 <= gate)
        joint_active = s_joint & (z0 > 0) & (d0 > cfg.sem_min_shift_px)

        T = res.Tcw
        n_used = torch.zeros((), dtype=torch.int32, device=dev)
        for round_idx in range(4):
            uvp, zp, _ = project(T)
            tgt, dist = nearest(uvp)
            # M_joint edges pull only in round 0 (the reference re-sets
            # their measurement to the point's own projection afterwards)
            jr = joint_active if round_idx == 0 else torch.zeros_like(
                joint_active)
            active = (sem_active | jr) & (zp > 0) & (dist <= gate)
            n_used = torch.sum(active.to(torch.int32))
            # standard edges re-classified by chi2 at the round-start pose
            r0, _, stereo0, z0r = reproj_residual_jac(K, T, obs)
            chi20 = edge_chi2(r0, obs.inv_sigma2, stereo0)
            gate0 = torch.where(stereo0, cfg.chi2_stereo, cfg.chi2_mono)
            std_active = obs.valid & (z0r > 0)
            if round_idx > 0:
                std_active = std_active & (chi20 <= gate0)
            for _ in range(10):
                T = gn_iter(T, tgt, active, std_active)
            # re-validate (ObjectOptimizer.cc:1036-1158)
            uvp, zp, _ = project(T)
            _, dist = nearest(uvp)
            sem_active = s_semantic & (zp > 0) & (dist <= gate)
            joint_active = joint_active & (zp > 0)

        # final chi2 gate on the standard edges
        r, _, stereo, z = reproj_residual_jac(K, T, obs)
        chi2 = edge_chi2(r, obs.inv_sigma2, stereo)
        gate_f = torch.where(stereo, cfg.chi2_stereo, cfg.chi2_mono)
        inlier = obs.valid & (chi2 <= gate_f) & (z > 0)
        kp_pt = torch.where(inlier, res.kp_pt, torch.full_like(res.kp_pt, -1))
        return T, kp_pt, inlier, n_used
