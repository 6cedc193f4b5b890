"""Loop closing: detection, Sim3 verification, correction, global BA.

Counterpart of object_slam_tpu/loop/loop_closing.py (LoopClosing.cc):

* detection (``:104-230``): BoW candidates above the covisible minimum
  score, then 3-consecutive-keyframe group consistency (host sets, as the
  reference's mvConsistentGroups);
* ``_compute_sim3`` (``:232-401``): descriptor matches between the query
  and the candidate's mapped keypoints, RANSAC Horn (SE3 for stereo and
  RGB-D), Gauss-Newton with bidirectional edges, a guided projection
  count;
* ``_correct_loop`` (``:403-644``): the pre-gate on the predicted bend,
  then, speculatively, propagation to the query's covisible group, loop
  point fusion, the essential graph, global BA, and the reference's
  benefit and bend gates, rolled back when they refuse.

The reference's jitted ``_LoopKernels`` bodies are plain methods here.
The closer runs on the caller's stream (the tracker's), after a mapping
merge, never on the mapping thread. Every map it returns is built from
new tensors: the async mapper's snapshot may still hold the old ones.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

import numpy as np
import torch

from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.features import matching
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.geometry import se3, sim3
from object_slam_tpu_torch.loop import kfdb
from object_slam_tpu_torch.loop.vocabulary import Vocabulary, l1_score
from object_slam_tpu_torch.ops.scatter import scatter_or, scatter_set, topk
from object_slam_tpu_torch.slam.map_ops import apply_replacements
from object_slam_tpu_torch.slam.map_state import MapState, covisibility
from object_slam_tpu_torch.solvers import ransac, sim3_solver
from object_slam_tpu_torch.solvers.ba import (BAProblem, _robust_cost,
                                              global_ba)
from object_slam_tpu_torch.solvers.pose_graph import (PoseGraphProblem,
                                                      correct_points,
                                                      optimize_pose_graph)

_VOCAB_FILE = os.path.join(os.path.dirname(__file__), "vocab_synth.txt")
_DEFAULT_VOCAB_CACHE: dict = {}


def default_vocabulary(cfg) -> Vocabulary:
    """The corpus-trained vocabulary (vocab_synth.txt, DBoW2 text), or the
    seeded random tree when the file is absent; parsed once per process
    (parsing the 1.5 MB text costs seconds)."""
    key = (_VOCAB_FILE, cfg.loop.vocab_branching, cfg.loop.vocab_depth)
    if key not in _DEFAULT_VOCAB_CACHE:
        if os.path.exists(_VOCAB_FILE):
            _DEFAULT_VOCAB_CACHE[key] = Vocabulary.load_dbow2_text(
                _VOCAB_FILE)
        else:
            _DEFAULT_VOCAB_CACHE[key] = Vocabulary.train_random(
                cfg.loop.vocab_branching, cfg.loop.vocab_depth)
    return _DEFAULT_VOCAB_CACHE[key]


@contextmanager
def _range(name: str):
    with torch.profiler.record_function(name):
        yield


def _ids(n, device):
    return torch.arange(n, device=device)


class LoopCloser:
    def __init__(self, cfg, K, vocab: Optional[Vocabulary] = None,
                 fix_scale: bool = True, device=None, span=None):
        self.cfg = cfg
        self.K = K
        self.vocab = vocab or default_vocabulary(cfg)
        self.fix_scale = fix_scale
        self.device = resolve_device(device)
        # span(name): a profiler range per stage (the system's _span, which
        # also times the stage when profiling)
        self.span = span or _range
        self.consistent_groups: List[Tuple[set, int]] = []
        self.last_loop_kf = -10
        self._cooldown = 10
        # the Sim3 sampler's stream (the reference's PRNGKey(42))
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(42)
        self.n_loops_closed = 0
        self.n_loops_rejected = 0     # benefit/bend-gate rollbacks
        self.events: List[dict] = []

    # ------------------------------------------------------------------
    # the reference's _LoopKernels bodies
    # ------------------------------------------------------------------
    def bow_row(self, m: MapState, kf_id: int) -> MapState:
        _, bow = self.vocab.transform(m.kf_kp_desc[kf_id],
                                      m.kf_kp_valid[kf_id])
        kf_bow = m.kf_bow.clone()
        kf_bow[kf_id] = bow
        return m._replace(kf_bow=kf_bow)

    def detect(self, m: MapState, kf_id: int):
        """(keep [K] candidates after the group gate, W [K, K])."""
        W = covisibility(m)
        covis_row = W[kf_id] > 0
        scores_covis = l1_score(m.kf_bow, m.kf_bow[kf_id][None, :])
        min_score = torch.min(torch.where(covis_row & m.kf_valid,
                                          scores_covis,
                                          torch.ones_like(scores_covis)))
        cand, scores = kfdb.detect_loop_candidates(
            m.kf_bow, m.kf_valid, m.kf_bow[kf_id], kf_id, covis_row,
            min_score)
        keep, _ = kfdb.aggregate_group_scores(cand, scores, W)
        return keep, W

    def match_pairs(self, m: MapState, q: int, l: int):
        """Descriptor matches between two keyframes' mapped keypoints ->
        camera-frame point pairs (pc_q, pc_l [N, 3], ok [N]) and the match
        index [N]."""
        P = m.pt_xyz.shape[0]
        N = m.kf_kp_pt.shape[1]
        ptq = torch.clamp(m.kf_kp_pt[q], 0, P - 1).long()
        ptl = torch.clamp(m.kf_kp_pt[l], 0, P - 1).long()
        okq = m.kf_kp_valid[q] & (m.kf_kp_pt[q] >= 0) & m.pt_valid[ptq]
        okl = m.kf_kp_valid[l] & (m.kf_kp_pt[l] >= 0) & m.pt_valid[ptl]
        midx, mok = matching.brute_match(
            m.kf_kp_desc[q], okq, m.kf_kp_desc[l], okl,
            th_dist=50, nn_ratio=0.75,
            angle_a=m.kf_kp_angle[q], angle_b=m.kf_kp_angle[l])
        mi = torch.clamp(midx, 0, N - 1).long()
        pc_q = se3.apply(m.kf_pose[q], m.pt_xyz[ptq][None])[0]
        pc_l = se3.apply(m.kf_pose[l], m.pt_xyz[ptl[mi]][None])[0]
        return pc_q, pc_l, mok, midx

    def loop_points(self, m: MapState, l: int, W_row):
        """[P] points observed by l and its covisible keyframes."""
        P = m.pt_xyz.shape[0]
        Kcap = W_row.shape[0]
        nbr = (W_row > 0) | (_ids(Kcap, W_row.device) == l)
        A = m.kf_kp_pt
        pts = scatter_or(torch.zeros(P, dtype=torch.bool, device=A.device),
                         torch.clamp(A, 0, P - 1).reshape(-1),
                         ((A >= 0) & m.kf_kp_valid
                          & nbr[:, None]).reshape(-1))
        return pts & m.pt_valid

    def propagate(self, m: MapState, q: int, l: int, T12, s12):
        """The measured correction propagated to the query's covisible
        group and their reference points (LoopClosing.cc:462-540).
        Returns (m, T_old [K, 4, 4], group [K], s_corr [K])."""
        Kcap = m.kf_pose.shape[0]
        dev = m.kf_pose.device
        T_old = m.kf_pose
        W = covisibility(m)
        group = ((W[q] > 0) | (_ids(Kcap, dev) == q)) & m.kf_valid
        one = torch.ones((), dtype=torch.float32, device=dev)
        Sq_T, Sq_s = sim3.compose(T12, s12, m.kf_pose[l], one)
        T_iq = torch.einsum('kij,jl->kil', T_old, se3.inverse(T_old[q]))
        T_corr = torch.einsum('kij,jl->kil', T_iq, Sq_T)
        s_corr = torch.where(group, Sq_s, one)
        T_corr = torch.where(group[:, None, None], T_corr, T_old)
        pt_new = correct_points(
            m.pt_xyz, torch.clamp(m.pt_ref_kf, 0, Kcap - 1), T_old,
            torch.ones(Kcap, dtype=torch.float32, device=dev), T_corr,
            s_corr)
        T_folded = T_corr.clone()
        T_folded[:, :3, 3] = T_corr[:, :3, 3] / s_corr[:, None]
        m = m._replace(kf_pose=T_folded, pt_xyz=pt_new,
                       version=m.version + 1)
        return m, T_old, group, s_corr

    def pose_graph(self, m: MapState, q: int, l: int, T12, s12, T_old,
                   s_init) -> MapState:
        """The essential graph after a loop (Optimizer.cc:781): spanning
        tree, strong covisibility (>= 100) and the loop edge; measurements
        from the pre-correction poses T_old, the loop edge the measured
        Sim3; initial values the propagated poses."""
        Kcap = m.kf_pose.shape[0]
        dev = m.kf_pose.device
        W = covisibility(m)
        parents = m.kf_parent
        has_parent = (parents >= 0) & m.kf_valid
        ei_tree = torch.clamp(parents, 0, Kcap - 1).long()
        ej_tree = _ids(Kcap, dev)

        strong = (torch.triu(W >= 100, 1) & m.kf_valid[:, None]
                  & m.kf_valid[None, :])
        nz = torch.nonzero(strong)[:4 * Kcap]          # row-major
        si = torch.zeros(4 * Kcap, dtype=torch.long, device=dev)
        sj = torch.zeros(4 * Kcap, dtype=torch.long, device=dev)
        si[:nz.shape[0]] = nz[:, 0]
        sj[:nz.shape[0]] = nz[:, 1]
        s_ok = strong[si, sj]

        lt = torch.tensor([l], dtype=torch.long, device=dev)
        qt = torch.tensor([q], dtype=torch.long, device=dev)
        ei = torch.cat([ei_tree, si, lt])
        ej = torch.cat([ej_tree, sj, qt])
        e_ok = torch.cat([has_parent, s_ok,
                          torch.ones(1, dtype=torch.bool, device=dev)])

        rel_T = torch.einsum('kij,kjl->kil', T_old[ej],
                             se3.inverse(T_old[ei]))
        rel_T[-1] = T12
        rel_s = torch.ones(ei.shape[0], dtype=torch.float32, device=dev)
        rel_s[-1] = s12

        T_init = m.kf_pose.clone()
        T_init[:, :3, 3] = m.kf_pose[:, :3, 3] * s_init[:, None]
        prob = PoseGraphProblem(
            T=T_init, s=s_init,
            fixed=(~m.kf_valid) | (_ids(Kcap, dev) == l),
            ei=ei, ej=ej, rel_T=rel_T, rel_s=rel_s, valid=e_ok,
            weight=torch.ones(ei.shape[0], dtype=torch.float32,
                              device=dev))
        T_new, s_new = optimize_pose_graph(
            prob, n_iters=self.cfg.solver.pose_graph_iters)
        pt_new = correct_points(m.pt_xyz,
                                torch.clamp(m.pt_ref_kf, 0, Kcap - 1),
                                T_init, s_init, T_new, s_new)
        T_new = T_new.clone()
        T_new[:, :3, 3] = T_new[:, :3, 3] / s_new[:, None]
        kf_loop_edge = m.kf_loop_edge.clone()
        kf_loop_edge[q] = l
        return m._replace(kf_pose=T_new, pt_xyz=pt_new,
                          kf_loop_edge=kf_loop_edge, version=m.version + 1)

    def fuse(self, m: MapState, q: int, l: int,
             n_neighbors: int = 10) -> MapState:
        """SearchAndFuse (LoopClosing.cc:588-615): the loop side's points
        projected into the corrected query side (q and its strongest
        covisible keyframes); a free keypoint binds the loop point, and a
        keypoint bound to another point has that point replaced by the
        loop point. The scatters keep the last writer of a duplicate
        index, as XLA:CPU's in-order scatter."""
        Kcap, N = m.kf_kp_pt.shape
        P = m.pt_xyz.shape[0]
        dev = m.kf_pose.device
        W = covisibility(m)
        loop_pts = self.loop_points(m, l, W[l])

        Wq = torch.where(m.kf_valid & (_ids(Kcap, dev) != q), W[q],
                         torch.full_like(W[q], -1))
        _, nbrs = topk(Wq, n_neighbors - 1)
        kfs = torch.cat([torch.tensor([q], dtype=torch.long, device=dev),
                         nbrs]).tolist()
        kf_ok = [True] + (Wq[nbrs] > 0).tolist()

        pt_ids = torch.arange(P, dtype=torch.int32, device=dev)
        radius = torch.full((P,), 4.0, device=dev)
        zero_lvl = torch.zeros(P, dtype=torch.int32, device=dev)
        for k, ok in zip(kfs, kf_ok):
            lpts = loop_pts & m.pt_valid
            pc = se3.apply(m.kf_pose[k], m.pt_xyz[None])[0]
            uv = cam_mod.project(self.K, pc)
            vis = lpts & ok & (pc[:, 2] > 0) & cam_mod.in_image(self.K, uv)
            midx, mok = matching.search_by_projection(
                uv, zero_lvl, m.pt_desc, vis,
                m.kf_kp_uv[k], m.kf_kp_level[k] * 0, m.kf_kp_desc[k],
                m.kf_kp_valid[k], radius_per_row=radius, th_dist=50,
                nn_ratio=None, level_window=8)
            row = m.kf_kp_pt[k]
            mi = torch.clamp(midx, 0, N - 1).long()
            existing = row[mi]
            fresh = mok & (existing < 0)
            row = scatter_set(row, mi, torch.where(fresh, pt_ids, row[mi]))
            kf_kp_pt = m.kf_kp_pt.clone()
            kf_kp_pt[k] = row
            m = m._replace(kf_kp_pt=kf_kp_pt,
                           pt_n_obs=m.pt_n_obs + fresh.to(torch.int32))
            ec = torch.clamp(existing, 0, P - 1).long()
            dup = (mok & (existing >= 0) & (existing != pt_ids)
                   & m.pt_valid[ec] & ~loop_pts[ec])
            fwd = scatter_set(pt_ids, ec, torch.where(dup, pt_ids,
                                                      pt_ids[ec]))
            replaced = scatter_or(torch.zeros(P, dtype=torch.bool,
                                              device=dev), ec, dup)
            replaced = replaced & (fwd != pt_ids)
            m = apply_replacements(m, fwd, replaced)
        return m

    def ba_problem(self, m: MapState) -> BAProblem:
        Kcap, N = m.kf_kp_pt.shape
        P = m.pt_xyz.shape[0]
        dev = m.kf_pose.device
        kp_pt = m.kf_kp_pt
        ptc = torch.clamp(kp_pt, 0, P - 1)
        obs_valid = ((kp_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
                     & m.pt_valid[ptc.long()])
        fixed = torch.zeros(Kcap, dtype=torch.bool, device=dev)
        fixed[0] = True
        return BAProblem(
            kf_pose=m.kf_pose, kf_fixed=fixed | ~m.kf_valid,
            kf_valid=m.kf_valid, pt_xyz=m.pt_xyz, pt_valid=m.pt_valid,
            obs_kf=torch.repeat_interleave(_ids(Kcap, dev), N),
            obs_pt=ptc.reshape(-1),
            obs_uv=m.kf_kp_uv.reshape(-1, 2),
            obs_ur=torch.where(obs_valid, m.kf_kp_ur,
                               torch.full_like(m.kf_kp_ur, -1.0)).reshape(-1),
            obs_inv_sigma2=torch.ones(Kcap * N, dtype=torch.float32,
                                      device=dev),
            obs_valid=obs_valid.reshape(-1))

    def gba(self, m: MapState) -> MapState:
        prob = self.ba_problem(m)
        kf_pose, pt_xyz = global_ba(self.K, prob,
                                    iters=self.cfg.solver.global_ba_iters,
                                    block_n=m.kf_kp_pt.shape[1])
        return m._replace(kf_pose=kf_pose, pt_xyz=pt_xyz,
                          version=m.version + 1)

    def quality(self, m: MapState):
        """Mean Huber reprojection cost per live observation (the benefit
        gate's metric), a device scalar."""
        prob = self.ba_problem(m)
        cost = _robust_cost(self.K, prob, prob.kf_pose, prob.pt_xyz,
                            self.cfg.solver.chi2_mono,
                            self.cfg.solver.chi2_stereo,
                            block_n=m.kf_kp_pt.shape[1])
        n = torch.clamp(torch.sum(prob.obs_valid.to(torch.float32)),
                        min=1.0)
        return cost / n

    # ------------------------------------------------------------------
    def _minimal_sets(self, valid, n_trials: int = 256):
        """[T, 3] Sim3 RANSAC index sets drawn from this closer's
        generator (the reference splits PRNGKey(42) per attempt)."""
        return ransac.sample_minimal_sets(self.rng, valid.shape[0], valid,
                                          n_trials, 3)

    def on_keyframe(self, m: MapState, kf_id: int):
        """BoW row, detection and, on a consistent candidate, the
        verification and correction. Returns (m, closed)."""
        with self.span("loop.detect"):
            m = self.bow_row(m, kf_id)
            if kf_id < 10 or kf_id - self.last_loop_kf < self._cooldown:
                self.consistent_groups = []
                return m, False
            cand_mask, W = self.detect(m, kf_id)
            cand_np = cand_mask.cpu().numpy()
        cand_ids = np.nonzero(cand_np)[0]
        if len(cand_ids) == 0:
            self.consistent_groups = []
            return m, False

        # the 3-consistency bookkeeping (LoopClosing.cc:150-226)
        Wnp = W.cpu().numpy()
        covis_th = self.cfg.loop.covis_consistency_th
        new_groups: List[Tuple[set, int]] = []
        enough: List[int] = []
        for c in cand_ids:
            group = set(np.nonzero(Wnp[c] > 0)[0].tolist()) | {int(c)}
            consistent_cnt = 0
            for prev_group, prev_cnt in self.consistent_groups:
                if group & prev_group:
                    consistent_cnt = max(consistent_cnt, prev_cnt + 1)
            new_groups.append((group, consistent_cnt))
            if consistent_cnt >= covis_th:
                enough.append(int(c))
        self.consistent_groups = new_groups
        if not enough:
            return m, False

        for loop_kf in enough:
            t_att = time.perf_counter()
            ok, T12, s12, _ = self._compute_sim3(m, kf_id, loop_kf)
            if ok:
                n_ev = len(self.events)
                m, accepted = self._correct_loop(m, kf_id, loop_kf, T12,
                                                 s12)
                if len(self.events) > n_ev:
                    self.events[-1]["wall_ms"] = round(
                        (time.perf_counter() - t_att) * 1e3, 1)
                # the cooldown fires either way, half as long after a
                # rejection (the reference's rule)
                self.last_loop_kf = kf_id
                self.consistent_groups = []
                if accepted:
                    self._cooldown = 10
                    self.n_loops_closed += 1
                    return m, True
                self._cooldown = 5
                self.n_loops_rejected += 1
                return m, False
        return m, False

    # ------------------------------------------------------------------
    def _compute_sim3(self, m: MapState, q: int, l: int):
        """(ok, T12, s12, n_inliers): >= 20 matches, RANSAC, GN with at
        least sim3_inliers survivors, and at least total_matches_accept
        inliers plus guided matches."""
        with self.span("loop.sim3"):
            pc_q, pc_l, mok, _ = self.match_pairs(m, q, l)
            if int(torch.sum(mok)) < 20:
                return False, None, None, 0
            res = sim3_solver.sim3_ransac_sets(
                self._minimal_sets(mok), self.K, pc_q, pc_l, mok,
                fix_scale=self.fix_scale,
                min_inliers=self.cfg.loop.sim3_inliers)
            if not bool(res.ok):
                return False, None, None, 0
            T12, s12, _, n_inl = sim3_solver.sim3_gn_refine(
                self.K, pc_q, pc_l, res.inliers, res.T12, res.s12,
                fix_scale=self.fix_scale)
            n_total = int(n_inl)
            if n_total < self.cfg.loop.sim3_inliers:
                return False, None, None, 0
            n_guided = self.guided_matches(m, q, l, T12, s12)
            if n_total + n_guided < self.cfg.loop.total_matches_accept:
                return False, None, None, 0
        return True, T12, s12, n_total

    def guided_matches(self, m: MapState, q: int, l: int, T12, s12) -> int:
        """SearchByProjection of the loop neighborhood's points into the
        query keyframe under the measured Sim3 (LoopClosing.cc:372-390);
        the Sim3 scales the rotated point only."""
        P = m.pt_xyz.shape[0]
        dev = m.kf_pose.device
        pts_mask = self.loop_points(m, l, covisibility(m)[l])
        pc_l = se3.apply(m.kf_pose[l], m.pt_xyz[None])[0]
        pc = s12 * (pc_l @ T12[:3, :3].T) + T12[:3, 3]
        uv = cam_mod.project(self.K, pc)
        vis = pts_mask & (pc[:, 2] > 0) & cam_mod.in_image(self.K, uv)
        _, mok = matching.search_by_projection(
            uv, torch.zeros(P, dtype=torch.int32, device=dev), m.pt_desc,
            vis, m.kf_kp_uv[q], m.kf_kp_level[q] * 0, m.kf_kp_desc[q],
            m.kf_kp_valid[q], radius_per_row=torch.full((P,), 8.0,
                                                        device=dev),
            th_dist=50, nn_ratio=None, level_window=8)
        return int(torch.sum(mok))

    # ------------------------------------------------------------------
    def pre_gate(self, m: MapState, q: int, l: int, T12):
        """The correction the closure claims, its scaled bend budgets and
        the predicted per-edge bend over the q..l slot-id chain: a dict,
        with ``pre_gated`` True when the prediction is refused. The chain
        length is |q - l| in slot ids, as the reference's (it is unreliable
        once slots recycle; ROADMAP queue 3)."""
        pose = m.kf_pose[[q, l]].cpu().numpy()
        Tq, Tl = pose[0], pose[1]
        D = T12.cpu().numpy() @ np.linalg.inv(Tq @ np.linalg.inv(Tl))
        corr_trans = float(np.linalg.norm(D[:3, 3]))
        corr_rot_deg = float(np.degrees(np.arccos(
            np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1))))
        n_edges = max(int(m.kf_valid.sum()) - 1, 1)
        med_edge = max(self._median_edge_len(m), 1e-6)
        loop = self.cfg.loop
        budget_deg = max(loop.max_edge_bend_deg, 3.0 * corr_rot_deg / n_edges)
        budget_frac = max(loop.max_edge_bend_frac,
                          3.0 * (corr_trans / n_edges) / med_edge)
        chain_edges = max(abs(int(q) - int(l)), 1)
        pred_bend_deg = corr_rot_deg / chain_edges
        pred_bend_frac = (corr_trans / chain_edges) / med_edge
        refused = (pred_bend_deg > 4.0 * budget_deg
                   or pred_bend_frac > 4.0 * budget_frac
                   or pred_bend_deg > loop.pregate_bend_deg_abs
                   or pred_bend_frac > loop.pregate_bend_frac_abs)
        return dict(corr_trans=corr_trans, corr_rot_deg=corr_rot_deg,
                    pred_bend_deg=pred_bend_deg,
                    pred_bend_frac=pred_bend_frac, budget_deg=budget_deg,
                    budget_frac=budget_frac, pre_gated=bool(refused))

    def _correct_loop(self, m: MapState, q: int, l: int, T12, s12):
        """CorrectLoop (LoopClosing.cc:403-644) in the reference's order,
        applied speculatively and rolled back when the post-GBA map is
        less self-consistent (benefit gate) or the pose graph bent the
        odometry edges past the budget. Returns (m, accepted)."""
        m_before = m
        g = self.pre_gate(m, q, l, T12)
        if g["pre_gated"]:
            self.events.append(dict(
                q=int(q), l=int(l), s12=float(s12),
                corr_trans=g["corr_trans"], corr_rot_deg=g["corr_rot_deg"],
                pred_bend_deg=g["pred_bend_deg"],
                pred_bend_frac=g["pred_bend_frac"],
                budget_deg=g["budget_deg"], budget_frac=g["budget_frac"],
                accepted=False, pre_gated=True))
            return m_before, False

        with self.span("loop.quality"):
            q_before = self.quality(m)
        s12 = torch.as_tensor(s12, dtype=torch.float32, device=self.device)
        with self.span("loop.propagate"):
            m, T_old, _, s_init = self.propagate(m, q, l, T12, s12)
        with self.span("loop.fuse"):
            m = self.fuse(m, q, l)
        with self.span("loop.pose_graph"):
            m = self.pose_graph(m, q, l, T12, s12, T_old, s_init)
        # the bend of the pose graph's correction, before the GBA moves
        # every pose (the reference's measuring point)
        bend_deg, bend_frac = self._edge_deformation(m_before, m)
        with self.span("loop.gba"):
            m = self.gba(m)
        with self.span("loop.quality"):
            q_after = self.quality(m)
            qb, qa = (float(x) for x in torch.stack([q_before,
                                                     q_after]).cpu())
        loop = self.cfg.loop
        accepted = (qa <= (qb * (1.0 + loop.benefit_gate_tolerance)
                           + loop.benefit_gate_abs_floor)
                    and bend_deg <= g["budget_deg"]
                    and bend_frac <= g["budget_frac"])
        self.events.append(dict(
            q=int(q), l=int(l), s12=float(s12),
            corr_trans=g["corr_trans"], corr_rot_deg=g["corr_rot_deg"],
            q_before=qb, q_after=qa, bend_deg=bend_deg, bend_frac=bend_frac,
            budget_deg=g["budget_deg"], budget_frac=g["budget_frac"],
            accepted=bool(accepted)))
        if not accepted:
            return m_before, False
        return m, True

    @staticmethod
    def _median_edge_len(m: MapState) -> float:
        """Median translation between consecutive valid keyframes."""
        kfv = m.kf_valid.cpu().numpy()
        ids = np.nonzero(kfv)[0]
        if len(ids) < 2:
            return 0.0
        T = m.kf_pose.cpu().numpy()[ids].astype(np.float64)
        lens = [np.linalg.norm((T[i] @ np.linalg.inv(T[i + 1]))[:3, 3])
                for i in range(len(ids) - 1)]
        return float(np.median(lens))

    @staticmethod
    def _edge_deformation(m_before: MapState, m_after: MapState):
        """Median per-odometry-edge change between the two trajectories:
        rotation (deg) and translation as a fraction of the edge
        length."""
        kfv = m_before.kf_valid.cpu().numpy()
        ids = np.nonzero(kfv)[0]
        if len(ids) < 3:
            return 0.0, 0.0
        Tb = m_before.kf_pose.cpu().numpy()[ids].astype(np.float64)
        Ta = m_after.kf_pose.cpu().numpy()[ids].astype(np.float64)
        rot, frac = [], []
        for i in range(len(ids) - 1):
            rb = Tb[i] @ np.linalg.inv(Tb[i + 1])
            ra = Ta[i] @ np.linalg.inv(Ta[i + 1])
            e = ra @ np.linalg.inv(rb)
            ang = np.degrees(np.arccos(
                np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
            edge_len = max(np.linalg.norm(rb[:3, 3]), 1e-6)
            rot.append(ang)
            frac.append(np.linalg.norm(e[:3, 3]) / edge_len)
        return float(np.median(rot)), float(np.median(frac))
