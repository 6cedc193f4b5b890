"""The map as a struct-of-arrays state of fixed-capacity slabs.

Counterpart of object_slam_tpu/slam/map_state.py, with every field at the
same shape (object fields included, though this slice leaves them at
their initial values). The reference's functions are pure MapState ->
MapState transforms; the port keeps that form (``_replace`` returns a new
tuple) and allocates new tensors where the reference's ``.at[]`` did.

Descriptors are int32 holding the reference's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.features.matching import popcount32
from object_slam_tpu_torch.ops.scatter import (scatter_add, scatter_min,
                                               scatter_or, scatter_set)
from object_slam_tpu_torch.semantic.hsv import HIST_DIM

# number of tracked semantic label slots for per-point label voting
N_LABEL_SLOTS = 16


class MapState(NamedTuple):
    # --- counters ---
    n_pt: torch.Tensor
    n_kf: torch.Tensor
    n_obj: torch.Tensor
    version: torch.Tensor
    next_track_id: torch.Tensor

    # --- points [P] ---
    pt_xyz: torch.Tensor
    pt_desc: torch.Tensor
    pt_normal: torch.Tensor
    pt_min_dist: torch.Tensor
    pt_max_dist: torch.Tensor
    pt_valid: torch.Tensor
    pt_visible: torch.Tensor
    pt_found: torch.Tensor
    pt_first_kf: torch.Tensor
    pt_ref_kf: torch.Tensor
    pt_n_obs: torch.Tensor
    pt_label_cnt: torch.Tensor
    pt_label_tot: torch.Tensor
    pt_obj: torch.Tensor

    # --- keyframes [K] ---
    kf_pose: torch.Tensor
    kf_valid: torch.Tensor
    kf_frame_id: torch.Tensor
    kf_timestamp: torch.Tensor
    kf_kp_uv: torch.Tensor
    kf_kp_ur: torch.Tensor
    kf_kp_depth: torch.Tensor
    kf_kp_level: torch.Tensor
    kf_kp_angle: torch.Tensor
    kf_kp_desc: torch.Tensor
    kf_kp_valid: torch.Tensor
    kf_kp_pt: torch.Tensor
    kf_parent: torch.Tensor
    kf_tcp: torch.Tensor
    kf_loop_edge: torch.Tensor
    kf_bow: torch.Tensor

    # --- objects [J] ---
    obj_valid: torch.Tensor
    obj_label: torch.Tensor
    obj_track_id: torch.Tensor
    obj_replaced: torch.Tensor
    obj_n_updates: torch.Tensor
    obj_centroid: torch.Tensor
    obj_bbox: torch.Tensor
    obj_hist_ring: torch.Tensor
    obj_center_ring: torch.Tensor
    obj_campos_ring: torch.Tensor
    obj_hist_n: torch.Tensor


def init_map(caps, history_capacity: int = 64, n_bow_words: int = 0,
             device=None) -> MapState:
    P, K, N, J = caps.max_points, caps.max_keyframes, caps.n_kp, \
        caps.max_objects
    Hc = history_capacity
    i32, f32 = torch.int32, torch.float32

    def full(shape, val, dtype=f32):
        return torch.full(shape, val, dtype=dtype, device=device)

    def eye4(n):
        return torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1)

    return MapState(
        n_pt=full((), 0, i32), n_kf=full((), 0, i32),
        n_obj=full((), 0, i32), version=full((), 0, i32),
        next_track_id=full((), 0, i32),
        pt_xyz=full((P, 3), 0.0), pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0), pt_min_dist=full((P,), 0.0),
        pt_max_dist=full((P,), 1e9), pt_valid=full((P,), False, torch.bool),
        pt_visible=full((P,), 1, i32), pt_found=full((P,), 1, i32),
        pt_first_kf=full((P,), -1, i32), pt_ref_kf=full((P,), 0, i32),
        pt_n_obs=full((P,), 0, i32),
        pt_label_cnt=full((P, N_LABEL_SLOTS), 0, i32),
        pt_label_tot=full((P,), 0, i32),
        pt_obj=full((P,), -1, i32),
        kf_pose=eye4(K),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_timestamp=full((K,), 0.0),
        kf_kp_uv=full((K, N, 2), 0.0), kf_kp_ur=full((K, N), -1.0),
        kf_kp_depth=full((K, N), -1.0),
        kf_kp_level=full((K, N), 0, i32), kf_kp_angle=full((K, N), 0.0),
        kf_kp_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_kp_pt=full((K, N), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_tcp=eye4(K),
        kf_loop_edge=full((K,), -1, i32),
        kf_bow=full((K, max(n_bow_words, 1)), 0.0),
        obj_valid=full((J,), False, torch.bool),
        obj_label=full((J,), -1, i32),
        obj_track_id=full((J,), -1, i32),
        obj_replaced=full((J,), -1, i32),
        obj_n_updates=full((J,), 0, i32),
        obj_centroid=full((J, 3), 0.0), obj_bbox=full((J, 6), 0.0),
        obj_hist_ring=full((J, Hc, HIST_DIM), 0.0),
        obj_center_ring=full((J, Hc, 3), 0.0),
        obj_campos_ring=full((J, Hc, 3), 0.0),
        obj_hist_n=full((J,), 0, i32))


# ---------------------------------------------------------------------------
# Derived structures
# ---------------------------------------------------------------------------

def obs_mask(m: MapState):
    """[K, N] live observations."""
    return (m.kf_kp_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]


def incidence(m: MapState):
    """[K, P] bool: KF k observes point p."""
    K, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    ok = obs_mask(m)
    pt = torch.clamp(m.kf_kp_pt, 0, P - 1).long()
    A = torch.zeros((K, P), dtype=torch.bool, device=pt.device)
    rows = torch.arange(K, device=pt.device)[:, None].expand(K, N)
    A[rows[ok], pt[ok]] = True
    return A


def covisibility(m: MapState):
    """[K, K] int32 shared-point counts, diagonal zeroed. The {0, 1}
    incidence product is exact in float32."""
    A = incidence(m).to(torch.float32)
    W = (A @ A.T).round().to(torch.int32)
    W.fill_diagonal_(0)
    return W


def camera_centers(m: MapState):
    R = m.kf_pose[:, :3, :3]
    t = m.kf_pose[:, :3, 3]
    return -torch.einsum('kji,kj->ki', R, t)


def _elect(desc, obs_ok):
    """Distinctive descriptor per row: the member with least median
    Hamming distance to the others. desc [L, M, 8], obs_ok [L, M]."""
    L, M = obs_ok.shape
    x = desc[:, :, None, :] ^ desc[:, None, :, :]
    dist = torch.sum(popcount32(x), dim=-1).to(torch.int32)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    dist = torch.where(pair_ok, dist, torch.full_like(dist, 9999))
    ds, _ = torch.sort(dist, dim=-1)
    n_valid = torch.sum(obs_ok, dim=-1)
    med_idx = torch.clamp((n_valid - 1) // 2, 0, M - 1)
    med = torch.gather(ds, -1, med_idx[:, None, None].expand(L, M, 1))[..., 0]
    med = torch.where(obs_ok, med, torch.full_like(med, 10000))
    best = torch.argmin(med, dim=-1)
    new_desc = torch.gather(desc, 1, best[:, None, None].expand(L, 1, 8))[:, 0]
    return new_desc, n_valid


def recompute_point_stats_windowed(m: MapState, kf_sel, cap: int,
                                   max_observers: int = 8) -> MapState:
    """Refresh pt_desc / pt_normal for the points observed by the
    ``kf_sel`` window (compacted to [cap]) and pt_n_obs from the full
    observation structure — the reference's windowed form, including its
    write-back scatter (padding rows write point 0's old values after the
    real rows, and the last write wins)."""
    Kcap, N = m.kf_kp_pt.shape
    P = m.pt_xyz.shape[0]
    dev = m.pt_xyz.device
    Wsel = kf_sel.shape[0]
    M = min(max_observers, Wsel)
    L = min(cap, P)
    kf_sel = kf_sel.long()

    sel_pt = m.kf_kp_pt[kf_sel]
    om = ((sel_pt >= 0) & m.kf_kp_valid[kf_sel]
          & m.kf_valid[kf_sel][:, None])
    ptc = torch.where(om, sel_pt, torch.full_like(sel_pt, P)).long()

    active = scatter_or(torch.zeros(P + 1, dtype=torch.bool, device=dev),
                        ptc.reshape(-1), om.reshape(-1))[:P] & m.pt_valid
    pos = torch.cumsum(active.to(torch.int64), 0) - 1
    inl = active & (pos < L)
    ar_p = torch.arange(P, device=dev)
    lidx = scatter_set(torch.zeros(L + 1, dtype=torch.int64, device=dev),
                       torch.where(inl, pos, torch.full_like(pos, L)),
                       ar_p)[:L]
    l_ok = scatter_set(torch.zeros(L + 1, dtype=torch.bool, device=dev),
                       torch.where(inl, pos, torch.full_like(pos, L)),
                       torch.ones(P, dtype=torch.bool, device=dev))[:L]
    pmap = scatter_set(torch.full((P + 1,), L, dtype=torch.int64,
                                  device=dev),
                       torch.where(inl, ar_p, torch.full_like(ar_p, P)), pos)

    lptc = pmap[ptc]                                   # [Wsel, N] in [0..L]
    kf_glob = kf_sel[:, None]
    code = kf_glob * N + torch.arange(N, device=dev)[None, :]
    SENT = Kcap * N
    slot = (kf_glob % M).expand(Wsel, N)
    lin = torch.where(lptc < L, lptc * M + slot,
                      torch.full_like(lptc, (L + 1) * M))
    table = scatter_min(torch.full(((L + 1) * M,), SENT, dtype=torch.int64,
                                   device=dev),
                        lin.reshape(-1), code.reshape(-1))
    table = table.reshape(L + 1, M)[:L]
    obs_ok = table < SENT
    obs_kf = torch.clamp(table // N, 0, Kcap - 1)
    kp_idx = table % N

    desc = m.kf_kp_desc[obs_kf, torch.clamp(kp_idx, 0, N - 1)]  # [L, M, 8]
    new_desc, n_valid = _elect(desc, obs_ok)

    C = camera_centers(m)
    pw = m.pt_xyz[lidx]
    d = pw[:, None, :] - C[obs_kf]
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(obs_ok[..., None], dn,
                                   torch.zeros_like(dn)), dim=1)
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.clamp(nn, min=1e-9)

    use = l_ok & (n_valid > 0)
    pt_desc = scatter_set(m.pt_desc, lidx,
                          torch.where(use[:, None], new_desc,
                                      m.pt_desc[lidx]))
    pt_normal = scatter_set(m.pt_normal, lidx,
                            torch.where(use[:, None], normal,
                                        m.pt_normal[lidx]))

    all_mask = obs_mask(m)
    all_ptc = torch.where(all_mask, m.kf_kp_pt,
                          torch.full_like(m.kf_kp_pt, P)).long()
    n_obs = scatter_add(torch.zeros(P + 1, dtype=torch.int32, device=dev),
                        all_ptc.reshape(-1),
                        all_mask.reshape(-1).to(torch.int32))[:P]
    return m._replace(pt_desc=pt_desc, pt_normal=pt_normal,
                      pt_n_obs=torch.where(m.pt_valid, n_obs,
                                           torch.zeros_like(n_obs)))


def recompute_point_stats(m: MapState, max_observers: int = 8) -> MapState:
    """The full-slab refresh: the windowed form over every keyframe, with
    no compaction cap (the observer sample is the earliest keyframe per
    residue class, as in the reference)."""
    Kcap = m.kf_kp_pt.shape[0]
    P = m.pt_xyz.shape[0]
    M = min(max_observers, Kcap)
    N = m.kf_kp_pt.shape[1]
    dev = m.pt_xyz.device
    om = obs_mask(m)
    ptc = torch.where(om, m.kf_kp_pt, torch.full_like(m.kf_kp_pt, P)).long()
    kk = torch.arange(Kcap, device=dev)[:, None].expand(Kcap, N)
    code = kk * N + torch.arange(N, device=dev)[None, :]
    SENT = Kcap * N
    lin = torch.where(ptc < P, ptc * M + kk % M,
                      torch.full_like(ptc, (P + 1) * M))
    table = scatter_min(torch.full(((P + 1) * M,), SENT, dtype=torch.int64,
                                   device=dev),
                        lin.reshape(-1), code.reshape(-1)).reshape(
        P + 1, M)[:P]
    obs_ok = table < SENT
    obs_kf = torch.clamp(table // N, 0, Kcap - 1)
    kp_idx = table % N
    n_obs = scatter_add(torch.zeros(P + 1, dtype=torch.int32, device=dev),
                        ptc.reshape(-1), om.reshape(-1).to(torch.int32))[:P]
    desc = m.kf_kp_desc[obs_kf, torch.clamp(kp_idx, 0, N - 1)]
    new_desc, n_valid = _elect(desc, obs_ok)
    use = m.pt_valid & (n_valid > 0)
    pt_desc = torch.where(use[:, None], new_desc, m.pt_desc)
    C = camera_centers(m)
    d = m.pt_xyz[:, None, :] - C[obs_kf]
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    normal = torch.sum(torch.where(obs_ok[..., None], dn,
                                   torch.zeros_like(dn)), dim=1)
    nn = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.clamp(nn, min=1e-9)
    normal = torch.where(use[:, None], normal, m.pt_normal)
    return m._replace(pt_desc=pt_desc, pt_normal=normal,
                      pt_n_obs=torch.where(m.pt_valid, n_obs,
                                           torch.zeros_like(n_obs)))
