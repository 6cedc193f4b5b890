"""Nearest-mask-pixel maps (feature transform) via jump flooding.

Counterpart of object_slam_tpu/ops/distance_transform.py: one jump-flooding
pass per mask gives a dense [H, W, 2] map of the nearest mask pixel, so
every query of the semantic optimizer is one gather. The port floods all
masks of a frame at once ([I, H, W]); the rounds, the neighbour order, the
strict compare and the wrapping rolls are the reference's, and the
distances are exact integers in f32, so the maps are identical.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_INF = 1e12
# the reference's neighbour order; later neighbours roll the map as the
# earlier ones of the same round left it
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
               (0, 1), (1, -1), (1, 0), (1, 1))


def _steps(h: int, w: int):
    n = max(h, w)
    n_steps = max(int(math.ceil(math.log2(n))), 1)
    return [s for s in (n >> (i + 1) for i in range(n_steps)) if s >= 1] + [1]


def _grid(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)


def feature_transform_batch(masks):
    """[I, H, W] bool -> [I, H, W, 2] float32 (y, x) of each pixel's
    nearest True pixel of its mask (itself inside the mask; (-1, -1) for
    an empty mask)."""
    h, w = masks.shape[-2], masks.shape[-1]
    grid = _grid(h, w, masks.device)                       # [H, W, 2]
    seed = torch.where(masks[..., None], grid, torch.full_like(grid, -1.0))

    def dist2(s):
        d = torch.sum((s - grid) ** 2, dim=-1)
        return torch.where(s[..., 0] < 0, torch.full_like(d, _INF), d)

    for step in _steps(h, w):
        best = dist2(seed)
        for dy, dx in _NEIGHBOURS:
            cand = torch.roll(seed, (dy * step, dx * step), dims=(-3, -2))
            cd = dist2(cand)
            take = cd < best
            seed = torch.where(take[..., None], cand, seed)
            best = torch.where(take, cd, best)
    return seed


def feature_transform(mask):
    """mask [H, W] bool -> [H, W, 2]."""
    return feature_transform_batch(mask[None])[0]


def _sqrt(x):
    """Correctly rounded f32 square root (as the reference's): torch's
    vectorized f32 sqrt on the CPU is not, its f64 one rounds back
    exactly."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _length(diff):
    """|diff| over a last axis of 2, as the compiled reference computes
    it: XLA contracts the sum of squares to fma(d1, d1, d0 * d0) (one
    rounding of d1^2 + round(d0^2)), then a correctly rounded sqrt."""
    d0, d1 = diff[..., 0], diff[..., 1]
    d1 = d1.to(torch.float64)
    return _sqrt(((d0 * d0).to(torch.float64) + d1 * d1).to(torch.float32))


def _near(near, uv):
    near_uv = torch.stack([near[..., 1], near[..., 0]], dim=-1)
    d = _length(near_uv - uv)
    return near_uv, torch.where(near[..., 0] < 0,
                                torch.full_like(d, math.inf), d)


def _pixel(uv, h, w):
    yy = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    xx = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    return yy, xx


def nearest_mask_pixel(ftmap, uv):
    """ftmap [H, W, 2] (y, x); uv [..., 2] (u=x, v=y) -> nearest mask pixel
    as (u, v) [..., 2] and its distance [...] (inf for an empty mask)."""
    yy, xx = _pixel(uv, ftmap.shape[0], ftmap.shape[1])
    return _near(ftmap[yy, xx], uv)


def nearest_mask_pixel_batched(ftmaps, map_idx, uv):
    """ftmaps [I, H, W, 2], map_idx [S], uv [S, 2] -> (near_uv [S, 2],
    dist [S]): one gather of S elements (never ftmaps[map_idx] whole)."""
    yy, xx = _pixel(uv, ftmaps.shape[1], ftmaps.shape[2])
    return _near(ftmaps[map_idx.long(), yy, xx], uv)


def distance_transform(mask):
    """Euclidean distance [H, W] to the nearest True pixel (0 inside)."""
    ft = feature_transform(mask)
    grid = _grid(mask.shape[0], mask.shape[1], mask.device)
    d = _sqrt((ft[..., 0] - grid[..., 0]) ** 2
              + (ft[..., 1] - grid[..., 1]) ** 2)
    return torch.where(ft[..., 0] < 0, torch.full_like(d, _INF), d)


def erode(masks, half: int):
    """Binary erosion of [..., H, W] masks by a (2*half)x(2*half) box: a
    pixel stays iff every pixel of rows y-half..y+half-1 and columns
    x-half..x+half-1 is set, where outside the image counts as set (the
    reference's min-window padding with 1.0). Two 1-D max pools of the
    complement."""
    shape = masks.shape
    out = (~masks).to(torch.float32).reshape((-1, 1) + tuple(shape[-2:]))
    out = F.max_pool2d(F.pad(out, (0, 0, half, half - 1)), (2 * half, 1),
                       stride=1)
    out = F.max_pool2d(F.pad(out, (half, half - 1, 0, 0)), (1, 2 * half),
                       stride=1)
    return (out < 0.5).reshape(shape)
