"""Descriptor matching: Hamming distances + the reference's search modes.

Counterpart of object_slam_tpu/features/matching.py. Descriptors are
``int32[N, 8]`` (the reference's uint32 bits). torch has no popcount:
``hamming_matrix`` unpacks the 256 bits to {0, 1} floats and forms
|a| + |b| - 2 a.b with one matrix product. Every term is an integer no
larger than 256, so the product is exact in float32 whatever the
summation order, and the distances equal the reference's XOR+popcount.
``popcount32`` is the SWAR popcount for the elementwise uses.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.ops.scatter import scatter_min, topk

BIG = 1 << 15


def popcount32(x):
    """Per-element popcount of an int32 tensor (SWAR; every mask keeps bit
    31 clear, so arithmetic right shifts are harmless)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def unpack_bits(desc):
    """[M, 8] int32 -> [M, 256] float32 {0, 1}."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def hamming_matrix(desc_a, desc_b):
    """[M, 8] x [N, 8] int32 -> [M, N] int32 Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    na = a.sum(dim=1)
    nb = b.sum(dim=1)
    d = na[:, None] + nb[None, :] - 2.0 * (a @ b.T)
    return d.round().to(torch.int32)


def masked_best2(dist, mask):
    """Per-row best and second-best over masked columns (masked-out
    entries count as BIG). Returns (best_idx, best, second)."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best_idx] = BIG
    second = torch.amin(d2, dim=1) if d2.shape[1] > 0 else best
    return best_idx, best, second


def masked_best2_idx(dist, mask):
    """masked_best2 that also returns the second-best column index."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    rows = torch.arange(d.shape[0], device=d.device)
    d2 = d.clone()
    d2[rows, best_idx] = BIG
    second_idx = torch.argmin(d2, dim=1)
    second = torch.gather(d2, 1, second_idx[:, None])[:, 0]
    return best_idx, best, second_idx, second


def rotation_consistency(angle_a, angle_b, matched_mask,
                         histo_length: int = 30):
    """Keep only matches in the 3 dominant rotation-difference bins, each
    at least 0.1x the best bin (ORBmatcher.cc:1601-1643)."""
    import math
    rot = (angle_a - angle_b) * (histo_length / (2.0 * math.pi))
    bins = torch.remainder(torch.round(rot).to(torch.int64), histo_length)
    ar = torch.arange(histo_length, device=bins.device)
    counts = torch.sum((bins[:, None] == ar[None, :])
                       & matched_mask[:, None], dim=0)
    _, top3 = topk(counts, 3)
    cmax = torch.amax(counts)
    keep_bin = torch.zeros(histo_length, dtype=torch.bool,
                           device=bins.device)
    for i in range(3):
        keep_bin[top3[i]] = counts[top3[i]] >= 0.1 * cmax
    return matched_mask & keep_bin[bins]


def resolve_duplicates(best_idx, best_dist, matched, n_targets):
    """One-to-one: among rows matched to one column keep the lowest
    distance, and on exact ties the first row."""
    d = torch.where(matched, best_dist, torch.full_like(best_dist, BIG))
    col_min = scatter_min(torch.full((n_targets,), 2 ** 31 - 1,
                                     dtype=d.dtype, device=d.device),
                          best_idx, d)
    keep = matched & (d <= col_min[best_idx])
    row_ids = torch.arange(best_idx.shape[0], device=d.device,
                           dtype=d.dtype)
    first_row = scatter_min(torch.full((n_targets,), 2 ** 31 - 1,
                                       dtype=d.dtype, device=d.device),
                            best_idx,
                            torch.where(keep, row_ids,
                                        torch.full_like(row_ids, BIG)))
    return keep & (row_ids == first_row[best_idx])


def search_by_projection(proj_uv, proj_level, proj_desc, proj_valid,
                         kp_uv, kp_level, kp_desc, kp_valid,
                         radius_per_row, th_dist: int = 100,
                         nn_ratio: float | None = 0.9,
                         level_window: int = 1,
                         kp_ur=None, proj_ur=None, r_ur=None,
                         lvl_lo=None, lvl_hi=None,
                         angle_a=None, angle_b=None):
    """Projection-window search (SearchByProjection family). Returns
    (match_idx [M] (-1 = none), match_mask [M])."""
    dist = hamming_matrix(proj_desc, kp_desc)
    du = torch.abs(proj_uv[:, None, 0] - kp_uv[None, :, 0])
    dv = torch.abs(proj_uv[:, None, 1] - kp_uv[None, :, 1])
    window = (du < radius_per_row[:, None]) & (dv < radius_per_row[:, None])
    if lvl_lo is not None:
        lvl_ok = ((kp_level[None, :] >= lvl_lo[:, None])
                  & (kp_level[None, :] <= lvl_hi[:, None]))
    else:
        lvl_ok = (torch.abs(kp_level[None, :] - proj_level[:, None])
                  <= level_window)
    mask = window & lvl_ok & proj_valid[:, None] & kp_valid[None, :]
    if kp_ur is not None and proj_ur is not None and r_ur is not None:
        ur_ok = (kp_ur[None, :] < 0) | (
            torch.abs(proj_ur[:, None] - kp_ur[None, :]) < r_ur[:, None])
        mask = mask & ur_ok

    best_idx, best, second_idx, second = masked_best2_idx(dist, mask)
    matched = best <= th_dist
    if nn_ratio is not None:
        same_lvl = kp_level[best_idx] == kp_level[second_idx]
        ratio_fail = same_lvl & (best.to(torch.float32) >=
                                 nn_ratio * second.to(torch.float32))
        matched = matched & ~ratio_fail
    if angle_a is not None and angle_b is not None:
        matched = rotation_consistency(angle_a, angle_b[best_idx], matched)
    matched = resolve_duplicates(best_idx, best, matched, kp_uv.shape[0])
    return torch.where(matched, best_idx, torch.full_like(best_idx, -1)), \
        matched


def brute_match(desc_a, valid_a, desc_b, valid_b,
                th_dist: int = 50, nn_ratio: float = 0.9,
                angle_a=None, angle_b=None, check_rotation=True,
                histo_length: int = 30):
    """Dense best match with ratio test and optional rotation
    consistency."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    best_idx, best, second = masked_best2(dist, mask)
    matched = (best <= th_dist) & (
        best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    if check_rotation and angle_a is not None:
        matched = rotation_consistency(angle_a, angle_b[best_idx], matched,
                                       histo_length)
    matched = resolve_duplicates(best_idx, best, matched, desc_b.shape[0])
    return torch.where(matched, best_idx, torch.full_like(best_idx, -1)), \
        matched


def search_for_triangulation(desc1, uv1, valid1, desc2, uv2, valid2,
                             F12, ex2, inv_sigma2_lvl2,
                             th_dist: int = 50, nn_ratio: float = 0.8,
                             angle1=None, angle2=None):
    """Epipolar-constrained matching between two keyframes
    (SearchForTriangulation) with the ratio test. Returns
    (match_idx [N1], mask [N1])."""
    ones = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    l2 = torch.cat([uv1, ones], -1) @ F12.T
    num = (l2[:, None, 0] * uv2[None, :, 0]
           + l2[:, None, 1] * uv2[None, :, 1] + l2[:, None, 2])
    den = torch.clamp(l2[:, None, 0] ** 2 + l2[:, None, 1] ** 2, min=1e-12)
    dline2 = num * num / den
    line_ok = dline2 * inv_sigma2_lvl2[None, :] < 3.84
    de2 = torch.sum((uv2 - ex2[None, :]) ** 2, -1)
    ep_ok = de2[None, :] > 100.0

    dist = hamming_matrix(desc1, desc2)
    mask = line_ok & ep_ok & valid1[:, None] & valid2[None, :]
    best_idx, best, second = masked_best2(dist, mask)
    matched = (best <= th_dist) & (
        best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    if angle1 is not None and angle2 is not None:
        matched = rotation_consistency(angle1, angle2[best_idx], matched)
    matched = resolve_duplicates(best_idx, best, matched, desc2.shape[0])
    return torch.where(matched, best_idx, torch.full_like(best_idx, -1)), \
        matched
