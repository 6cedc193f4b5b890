"""FAST-9/16 corner detection as dense tensor compute.

Counterpart of object_slam_tpu/features/fast.py: the segment test runs
for every pixel at once on 16 rolled copies of the image (the ring stack
WRAPS at the borders, as the reference's ``jnp.roll`` does), and non-max
suppression compares on a quarter-intensity lattice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the standard FAST-16 ring (dy, dx),
# in circular order.
RING_16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring_stack(img):
    """[H, W] -> [16, H, W]: slice i is the image shifted so that ring
    pixel i aligns with the center pixel."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                        for dy, dx in RING_16])


def _arc_all(mask, arc_len):
    acc = mask
    for s in range(1, arc_len):
        acc = acc & torch.roll(mask, -s, dims=0)
    return acc


def _arc_min(vals, mask, arc_len):
    m = vals
    for s in range(1, arc_len):
        m = torch.minimum(m, torch.roll(vals, -s, dims=0))
    return torch.where(mask, m, torch.zeros_like(m))


def fast_score_dual(img, th_lo: float, th_hi: float, arc_len: int = 9):
    """Both thresholds' responses from ONE ring stack. Returns
    (score_lo, score_hi) [H, W] maps."""
    d = _ring_stack(img) - img[None]
    out = []
    for th in (th_lo, th_hi):
        ab = _arc_all(d > th, arc_len)
        ad = _arc_all(d < -th, arc_len)
        is_corner = torch.any(ab | ad, dim=0)
        score_b = torch.amax(_arc_min(d, ab, arc_len), dim=0)
        score_d = torch.amax(_arc_min(-d, ad, arc_len), dim=0)
        score = torch.maximum(score_b, score_d) - th
        out.append(torch.where(is_corner, torch.clamp(score, min=0.0) + th,
                               torch.zeros_like(score)))
    return out[0], out[1]


def nonmax_suppress(score, quantum: float = 0.25):
    """3x3 non-maximum suppression on the quantized lattice (the window is
    'SAME'-padded with -inf, so borders compare only inside the image)."""
    q = torch.floor(score * (1.0 / quantum))
    neigh = F.max_pool2d(q[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(q >= neigh, score, torch.zeros_like(score))


def detect_dual(img, th_lo: float, th_hi: float, arc_len: int = 9,
                border: int = 3):
    """NMS'd low-threshold response with high-threshold corners boosted by
    1e4. Returns (ranking_response, raw_score)."""
    s_lo, s_hi = fast_score_dual(img, th_lo, th_hi, arc_len)
    s = nonmax_suppress(s_lo)
    sb = torch.where((s > 0) & (s_hi > 0), s + 1e4, s)
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = ((ys >= border) & (ys < h - border) &
           (xs >= border) & (xs < w - border))
    return torch.where(inb, sb, torch.zeros_like(sb)), s_lo


def subpixel_refine(raw_score, ys, xs):
    """Parabolic subpixel localization on the corner-score surface.
    Returns (dy, dx) in [-0.5, 0.5]."""
    h, w = raw_score.shape
    yc = torch.clamp(ys, 1, h - 2).long()
    xc = torch.clamp(xs, 1, w - 2).long()

    def fit(m, p, c):
        denom = m + p - 2.0 * c
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (m - p) / denom,
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    c = raw_score[yc, xc]
    dy = fit(raw_score[yc - 1, xc], raw_score[yc + 1, xc], c)
    dx = fit(raw_score[yc, xc - 1], raw_score[yc, xc + 1], c)
    return dy, dx
