"""Image pyramid with static per-level shapes.

Counterpart of object_slam_tpu/features/pyramid.py. The reference resizes
with ``jax.image.resize(..., 'linear')``, which ANTIALIASES when it
downsamples: its triangle kernel widens by 1/scale. ``F.interpolate``
with ``mode="bilinear"`` does not, and its ``antialias=True`` uses other
weights. So each level's separable weight matrices are built on the host
the way ``jax.image.resize`` builds them (jax/_src/image/scale.py,
``compute_weight_mat``) and applied as two matrix products.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(h: int, w: int, n_levels: int,
                 scale: float) -> List[Tuple[int, int]]:
    return [(max(int(round(h / scale ** l)), 16),
             max(int(round(w / scale ** l)), 16)) for l in range(n_levels)]


@lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of jax.image.resize 'linear'
    (antialiased triangle kernel, translation 0), computed in float32 as
    jax computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    # XLA fuses (i + 0.5) * inv_scale - 0.5 into one fused multiply-add
    # (one rounding); float64 arithmetic rounded once reproduces it
    a = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(f32)
    sample_f = (a.astype(np.float64) * np.float64(inv_scale)
                - 0.5).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_linear(img: torch.Tensor, out_shape: Tuple[int, int]):
    """jax.image.resize(img, out_shape, 'linear') for a 2-D image."""
    h, w = img.shape
    oh, ow = out_shape
    wy = torch.from_numpy(resize_weights(h, oh)).to(img.device)
    wx = torch.from_numpy(resize_weights(w, ow)).to(img.device)
    return wy.T @ img @ wx


def build_pyramid(img, n_levels: int, scale: float):
    """img [H, W] float32 in [0, 255] -> list of [Hl, Wl] tensors."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    out = [img]
    cur = img
    for l in range(1, n_levels):
        cur = resize_linear(cur, shapes[l])
        out.append(cur)
    return out


def blur_weights(sigma: float = 2.0, radius: int = 3) -> np.ndarray:
    """The blur's 2*radius+1 float32 taps; tap i weighs img[x - radius + i]."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """Separable 7x7 Gaussian blur as shift-and-accumulate with the
    reference's WRAPPING borders (torch.roll with the same signs)."""
    k = blur_weights(sigma, radius)
    out = torch.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + float(wgt) * torch.roll(img, radius - i, dims=1)
    img2 = out
    out = torch.zeros_like(img)
    for i, wgt in enumerate(k):
        out = out + float(wgt) * torch.roll(img2, radius - i, dims=0)
    return out
