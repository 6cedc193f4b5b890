"""Stereo depth: L/R keypoint matching with SAD subpixel refinement, and the
RGB-D virtual right coordinate.

Counterpart of object_slam_tpu/features/stereo.py
(Frame::ComputeStereoMatches, Frame.cc:706-880, and
Frame::ComputeStereoFromRGBD, Frame.cc:883-904). The candidate search is
one masked [NL, NR] Hamming matrix (row band, disparity range, level
window) reduced by ``masked_best2``; the SAD refinement gathers one wide
[N, 11, 21] right window per keypoint and takes the 11 shifts as static
slices of it, as the reference does. Ties in the best match and in the
best shift break by the lower index, as XLA's argmin does (torch.argmin
returns the first minimum).
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.features.matching import (hamming_matrix,
                                                     masked_best2)


def rgbd_virtual_right(uv, depth, bf):
    """uv [N, 2] (undistorted), depth [N] -> (ur [N], valid_depth [N]);
    ur = -1 where the depth is invalid."""
    ok = depth > 0
    ur = torch.where(ok, uv[..., 0] - bf / torch.clamp(depth, min=1e-6),
                     torch.full_like(depth, -1.0))
    return ur, ok


def _window_index(center, offsets, size):
    """clip(round(center + offset), 0, size - 1) as int64 indices: the
    offset is added in f32 before rounding, as the reference adds it."""
    return torch.clamp(torch.round(center + offsets).to(torch.int64), 0,
                       size - 1)


def stereo_candidates(kpl_uv, kpl_level, kpl_desc, kpl_valid,
                      kpr_uv, kpr_level, kpr_desc, kpr_valid,
                      scale_factors, max_d: float, th_dist: int):
    """The best right keypoint of each left one within the row band
    (2 x its level's scale), the disparity range (0.1, max_d) and one
    level: (best_idx [NL], matched [NL] = best distance <= th_dist)."""
    band = 2.0 * scale_factors[kpl_level.long()]
    dv = torch.abs(kpl_uv[:, None, 1] - kpr_uv[None, :, 1])
    disp = kpl_uv[:, None, 0] - kpr_uv[None, :, 0]
    lvl_ok = torch.abs(kpl_level[:, None] - kpr_level[None, :]) <= 1
    mask = ((dv <= band[:, None]) & (disp > 0.1) & (disp < max_d)
            & lvl_ok & kpl_valid[:, None] & kpr_valid[None, :])
    dist = hamming_matrix(kpl_desc, kpr_desc)
    best_idx, best, _ = masked_best2(dist, mask)
    return best_idx, best <= th_dist


def match_stereo(kpl_uv, kpl_level, kpl_desc, kpl_valid,
                 kpr_uv, kpr_level, kpr_desc, kpr_valid,
                 img_l, img_r, scale_factors, bf, fx,
                 min_z: float, th_dist: int = 100,
                 sad_half: int = 5, sad_shift: int = 5):
    """Returns (ur [NL], depth [NL], ok [NL]) for the left keypoints.

    min_z: the least depth (the baseline; maxD = bf / min_z). The SAD
    refinement runs on the level-0 images around the best match, shifting
    the right window by [-sad_shift, +sad_shift] pixels, with parabolic
    subpixel interpolation (Frame.cc:800-860)."""
    dev = kpl_uv.device
    max_d = bf / min_z
    best_idx, matched = stereo_candidates(
        kpl_uv, kpl_level, kpl_desc, kpl_valid, kpr_uv, kpr_level, kpr_desc,
        kpr_valid, scale_factors, max_d, th_dist)

    # --- SAD subpixel on the level-0 images ---
    ur0 = kpr_uv[best_idx, 0]
    v0 = kpl_uv[:, 1]
    u_l = kpl_uv[:, 0]
    h, w = img_l.shape
    d = torch.arange(-sad_half, sad_half + 1, device=dev)
    yy = _window_index(v0[:, None, None], d[None, :, None], h)   # [N, W, 1]
    xl = _window_index(u_l[:, None, None], d[None, None, :], w)  # [N, 1, W]
    wl = img_l[yy, xl]                                           # [N, W, W]
    wl = wl - wl[:, sad_half:sad_half + 1, sad_half:sad_half + 1]

    # one wide right-window gather [N, W, W + 2 * sad_shift]; each shift is
    # a static slice (integer shifts commute with round())
    wide = torch.arange(-sad_half - sad_shift, sad_half + sad_shift + 1,
                        device=dev)
    xr = _window_index(ur0[:, None, None], wide[None, None, :], w)
    wr_wide = img_r[yy, xr]
    W = 2 * sad_half + 1
    sad_list = []
    for si in range(2 * sad_shift + 1):
        wr = wr_wide[:, :, si:si + W]
        wr = wr - wr[:, sad_half:sad_half + 1, sad_half:sad_half + 1]
        sad_list.append(torch.sum(torch.abs(wl - wr), dim=(1, 2)))
    sads = torch.stack(sad_list, dim=1)                          # [N, S]
    shifts = torch.arange(-sad_shift, sad_shift + 1, dtype=torch.float32,
                          device=dev)
    S = shifts.shape[0]
    bi_c = torch.clamp(torch.argmin(sads, dim=1), 1, S - 2)
    s_m = torch.gather(sads, 1, (bi_c - 1)[:, None])[:, 0]
    s_0 = torch.gather(sads, 1, bi_c[:, None])[:, 0]
    s_p = torch.gather(sads, 1, (bi_c + 1)[:, None])[:, 0]
    denom = torch.clamp(s_m + s_p - 2.0 * s_0, min=1e-6)
    delta = torch.clamp(0.5 * (s_m - s_p) / denom, -1.0, 1.0)
    # the windows sample at rounded centres, so the disparity relates the
    # rounded coordinates (mixing in the subpixel keypoint position biases
    # it by up to 0.5 px; the reference's comment at stereo.py:101-106)
    disparity = torch.round(u_l) - (torch.round(ur0) + shifts[bi_c] + delta)
    ur = u_l - disparity
    ok = matched & (disparity > 1e-3) & (disparity < max_d)
    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-6),
                        torch.full_like(disparity, -1.0))
    ur = torch.where(ok, ur, torch.full_like(ur, -1.0))
    return ur, depth, ok
