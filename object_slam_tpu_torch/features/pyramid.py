"""Image pyramid with static per-level shapes.

Counterpart of object_slam_tpu/features/pyramid.py. The reference resizes
with ``jax.image.resize(..., 'linear')``, which ANTIALIASES when it
downsamples: its triangle kernel widens by 1/scale. ``F.interpolate``
with ``mode="bilinear"`` does not, and its ``antialias=True`` uses other
weights. So each level's separable weight matrices are built on the host
the way ``jax.image.resize`` builds them (jax/_src/image/scale.py,
``compute_weight_mat``) and applied as two matrix products.

On the CPU, for the image sizes in ``xla_resize.npz`` (TUM VGA), each
product is instead summed tap by tap in the order XLA:CPU sums it, with
the weights the compiled reference computes (``resize_taps``), so that the
levels equal the reference's bit for bit: a last-ulp difference moves a
FAST response across a quarter step of the lattice and reorders
keypoints. The card keeps the two matrix products: there the tracking
that follows the pyramid sums in another order than the CPU's anyway
(a TUM-VGA run with the reference's levels on the card parted from the
CPU port's run at a keyframe decision one inlier from its threshold), and
the products are its paths' arithmetic since the first slice. The file is
written by tests/torch_fixtures/make_reference.py xla_resize.

The offline harvests (scripts/train_vocab_torch.py,
train_brief_pattern_torch.py) track nothing, so they ask for XLA:CPU's
order on every device (``order="xla"``): the plan's index and weight
tensors move to the device, and index_select, float64 products and
roundings to float32 round alike on any IEEE device, so the card's levels
equal the CPU's bit for bit. Asking for that order at a size the file has
no plan for raises; it never falls back to the products.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, List, Tuple

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


_PLAN_FILE = os.path.join(os.path.dirname(__file__), "xla_resize.npz")


@lru_cache(maxsize=None)
def _plans() -> Dict[tuple, tuple]:
    """(axis, n_in, n_out, n_other) -> (start [n_out] int, w [n_out, 3]
    f32, group [n_out, 3] int8, rounded bool) for each product the file
    records: output j sums taps start[j] + s (s = 0, 1, 2) with weights
    w[j, s] into two partial sums chosen by group[j, s], each an FMA chain
    (rounded False) or a chain of rounded products (rounded True), and
    adds the two."""
    if not os.path.exists(_PLAN_FILE):
        return {}
    f = np.load(_PLAN_FILE)
    out = {}
    for key in {k.rsplit(".", 1)[0] for k in f.files}:
        axis, n_in, n_out, other = key.split("_")
        out[(axis, int(n_in), int(n_out), int(other))] = (
            f[key + ".start"], f[key + ".w"], f[key + ".group"],
            bool(f[key + ".rounded"]))
    return out


TAPS = 3
_plan_cache: Dict[tuple, tuple] = {}


def _plan(key, device):
    """One product's plan as tensors on `device` (built once per device):
    the flat tap indices [n_out * 3], the weights [n_out, 3, 1] in float64
    and the group masks [n_out, 3, 1], with the rounded flag."""
    if (key, device) not in _plan_cache:
        start, w, group, rounded = _plans()[key]
        idx = np.minimum(start[:, None] + np.arange(TAPS), key[1] - 1)
        _plan_cache[key, device] = (
            torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(device),
            torch.from_numpy(w.astype(np.float64))[:, :, None].to(device),
            torch.from_numpy(group.astype(bool))[:, :, None].to(device),
            rounded)
    return _plan_cache[key, device]


def resize_taps(x, key, axis: int):
    """One of jax.image.resize's two products as XLA:CPU sums it: for each
    output o, the taps k = start[o] + s (s = 0, 1, 2) with weights w[o, s]
    go into two partial sums chosen by group[o, s], each in tap order, and
    the output is their sum. A step adds the exact product (float64) to the
    float32 partial sum and rounds once to float32 (XLA's FMA), or, for a
    rounded plan, adds the product rounded to float32. axis 0 contracts
    the rows of x ([n_in, m] -> [n_out, m]), 1 its columns."""
    idx, w, group, rounded = _plan(key, x.device)
    xt = x if axis == 0 else x.T
    n_out = w.shape[0]
    p = xt.double().index_select(0, idx).reshape(n_out, TAPS, -1) * w
    if rounded:
        p = p.float().double()
    acc0 = torch.zeros_like(p[:, 0])
    acc1 = torch.zeros_like(acc0)
    for s in range(TAPS):
        g = group[:, s]
        u = (p[:, s] + torch.where(g, acc1, acc0)).float().double()
        acc0 = torch.where(g, acc0, u)
        acc1 = torch.where(g, u, acc1)
    out = acc0.float() + acc1.float()
    return out if axis == 0 else out.T.contiguous()


ORDERS = ("auto", "xla")


def resize_linear(img: torch.Tensor, out_shape: Tuple[int, int],
                  order: str = "auto"):
    """jax.image.resize(img, out_shape, 'linear') for a 2-D image.
    order "auto": XLA:CPU's tap order on the CPU where xla_resize.npz has
    a plan, else the two matrix products (every tracking path); "xla":
    XLA:CPU's order on any device, a ValueError where there is no plan."""
    if order not in ORDERS:
        raise ValueError(f"resize order {order!r} is not one of {ORDERS}")
    h, w = img.shape
    oh, ow = out_shape
    rows, cols = ("rows", h, oh, w), ("cols", w, ow, oh)
    planned = rows in _plans() and cols in _plans()
    if order == "xla" and not planned:
        raise ValueError(
            f"xla_resize.npz has no plan for {h}x{w} -> {oh}x{ow}: XLA:CPU's "
            f"order is recorded only for the sizes the file holds")
    if planned and (order == "xla" or img.device.type == "cpu"):
        return resize_taps(resize_taps(img, rows, 0), cols, 1)
    wy = torch.from_numpy(resize_weights(h, oh)).to(img.device)
    wx = torch.from_numpy(resize_weights(w, ow)).to(img.device)
    return wy.T @ img @ wx


def build_pyramid(img, n_levels: int, scale: float, order: str = "auto"):
    """img [H, W] float32 in [0, 255] -> list of [Hl, Wl] tensors; order
    as resize_linear's."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    out = [img]
    cur = img
    for l in range(1, n_levels):
        cur = resize_linear(cur, shapes[l], order)
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
