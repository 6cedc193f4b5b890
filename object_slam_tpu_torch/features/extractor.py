"""ORB keypoint extraction: pyramid FAST + per-cell top-k + steered BRIEF.

Counterpart of object_slam_tpu/features/extractor.py, with the same
contract: a fixed-size keypoint slab (cfg.caps.n_kp) with a validity
mask, level-0 pixel coordinates, IC angles and 256-bit steered-BRIEF
descriptors.

Descriptors are ``int32[N, 8]`` holding the same bits as the reference's
``uint32[N, 8]`` (torch's uint32 has no bitwise or shift ops on the CPU).

Extraction runs in two passes: detection (FAST, cell top-k, top-k,
subpixel refinement) level by level, then one ``orb_describe`` call for
the keypoints of every level (ops/describe.py: one CUDA kernel launch per
frame on the card; the reference's blur, patch gathers, IC angle and
BRIEF on the CPU).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.features import fast as fast_mod
from object_slam_tpu_torch.features import pyramid as pyr_mod
from object_slam_tpu_torch.ops.describe import (HALF, N_ANGLE_BINS, PATCH,
                                                orb_describe)
from object_slam_tpu_torch.ops.scatter import topk


class Keypoints(NamedTuple):
    """uv [N, 2] level-0 (x, y) distorted; response [N]; angle [N] rad;
    level [N] int32; desc [N, 8] int32 (uint32 bits); valid [N] bool."""

    uv: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    level: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self):
        return self.uv.shape[0]


_PATTERN_FILE = os.path.join(os.path.dirname(__file__), "brief_pattern.npy")


def make_pattern(n_bits: int = 256, patch_radius: int = 13, seed: int = 7):
    """BRIEF test pattern [n_bits, 4] (y1, x1, y2, x2) as float32 numpy:
    the learned pattern file, or the reference's seeded Gaussian fallback."""
    if os.path.exists(_PATTERN_FILE):
        pat = np.load(_PATTERN_FILE)
        if pat.shape == (n_bits, 4):
            return np.asarray(pat, np.float32)
    rng = np.random.RandomState(seed)
    sigma = patch_radius / 2.0
    pts = np.clip(rng.randn(n_bits, 4) * sigma, -patch_radius, patch_radius)
    return np.asarray(pts, np.float32)


def _level_budgets(n_features: int, n_levels: int, scale: float):
    """Geometric per-level budget (ORBextractor.cc:435-446)."""
    inv = 1.0 / scale
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    budgets = [int(round(first * inv ** l)) for l in range(n_levels)]
    budgets[-1] = max(n_features - sum(budgets[:-1]), 0)
    return budgets


def _cell_topk(resp, cell: int, k_per_cell: int):
    """Per-cell top-k over a [H, W] response map on the quarter-intensity
    lattice; ties go to the lowest linear index (torch.argmax returns the
    first maximum, as jnp.argmax does). Returns (scores, ys, xs) [C]."""
    h, w = resp.shape
    rows, cols = h // cell, w // cell
    r = torch.floor(resp[:rows * cell, :cols * cell] * 4.0) * 0.25
    r = r.reshape(rows, cell, cols, cell).permute(0, 2, 1, 3)
    r = r.reshape(rows, cols, cell * cell)
    ar = torch.arange(cell * cell, device=resp.device)
    vals_l, idx_l = [], []
    for _ in range(k_per_cell):
        idx = torch.argmax(r, dim=-1)
        val = torch.gather(r, -1, idx[..., None])[..., 0]
        r = torch.where(ar[None, None, :] == idx[..., None],
                        torch.full_like(r, -math.inf), r)
        vals_l.append(val)
        idx_l.append(idx)
    vals = torch.stack(vals_l, dim=-1)
    idx = torch.stack(idx_l, dim=-1)
    cy = idx // cell
    cx = idx % cell
    base_y = (torch.arange(rows, device=resp.device) * cell)[:, None, None]
    base_x = (torch.arange(cols, device=resp.device) * cell)[None, :, None]
    ys = (base_y + cy).reshape(-1)
    xs = (base_x + cx).reshape(-1)
    return vals.reshape(-1), ys, xs


def make_brief_matrix(pattern, n_bins: int = N_ANGLE_BINS):
    """The reference's binned steered-BRIEF difference operator
    D [PATCH*PATCH, n_bins*256] (float32 numpy): for bin b and bit j, -1 at
    the first rotated sample and +1 at the second."""
    pat = np.asarray(pattern)
    D = np.zeros((PATCH * PATCH, n_bins * 256), np.float32)
    i1, i2 = make_brief_index(pat, n_bins)
    cols = np.arange(n_bins * 256)
    np.add.at(D, (i1.reshape(-1), cols), -1.0)
    np.add.at(D, (i2.reshape(-1), cols), 1.0)
    return D


def make_brief_index(pattern, n_bins: int = N_ANGLE_BINS):
    """Flat patch indices [n_bins, 256] of each bit's two rotated samples
    (the nonzeros of the reference's difference operator D)."""
    pat = np.asarray(pattern)
    i1 = np.zeros((n_bins, 256), np.int64)
    i2 = np.zeros((n_bins, 256), np.int64)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        c, s = np.cos(th), np.sin(th)
        for j in range(256):
            y1, x1, y2, x2 = pat[j]
            r1y = min(max(int(round(HALF + s * x1 + c * y1)), 0), PATCH - 1)
            r1x = min(max(int(round(HALF + c * x1 - s * y1)), 0), PATCH - 1)
            r2y = min(max(int(round(HALF + s * x2 + c * y2)), 0), PATCH - 1)
            r2x = min(max(int(round(HALF + c * x2 - s * y2)), 0), PATCH - 1)
            i1[b, j] = r1y * PATCH + r1x
            i2[b, j] = r2y * PATCH + r2x
    return i1, i2


class OrbExtractor:
    """ORB pipeline for a fixed image geometry.

    Usage: ex = OrbExtractor(cfg, device="cpu"); kps = ex(image_f32)."""

    def __init__(self, cfg, height: int | None = None,
                 width: int | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        o = cfg.orb
        self.h = height or cfg.camera.height
        self.w = width or cfg.camera.width
        self.n_kp = cfg.caps.n_kp
        self.shapes = pyr_mod.level_shapes(self.h, self.w, o.n_levels,
                                           o.scale_factor)
        self.budgets = _level_budgets(o.n_features, o.n_levels,
                                      o.scale_factor)
        total = sum(self.budgets)
        if total < self.n_kp:
            self.budgets[0] += self.n_kp - total
        self.pattern = make_pattern()
        i1, i2 = make_brief_index(self.pattern)
        self.brief_idx1 = torch.from_numpy(i1.astype(np.int16)).to(self.device)
        self.brief_idx2 = torch.from_numpy(i2.astype(np.int16)).to(self.device)
        self._ids: dict = {}

    def __call__(self, img) -> Keypoints:
        return self._extract(img)

    def _level_ids(self, counts, device):
        """[N] int32 pyramid level of each keypoint for counts ((level, n),
        ...); the counts follow from the geometry, so this builds once."""
        key = (counts, device)
        if key not in self._ids:
            lvl = np.repeat(np.asarray([l for l, _ in counts], np.int32),
                            [n for _, n in counts])
            self._ids[key] = torch.from_numpy(lvl).to(device)
        return self._ids[key]

    def _extract(self, img) -> Keypoints:
        o = self.cfg.orb
        levels = [x.contiguous() for x in
                  pyr_mod.build_pyramid(img, o.n_levels, o.scale_factor)]
        # pass 1, level by level: detection and subpixel refinement
        det, counts = [], []
        for l, lvl_img in enumerate(levels):
            n_l = self.budgets[l]
            if n_l <= 0:
                continue
            resp, raw_score = fast_mod.detect_dual(
                lvl_img, float(o.min_th_fast), float(o.ini_th_fast),
                o.fast_arc_len, border=o.edge_threshold)
            cell = max(o.cell_size // max(int(o.scale_factor ** l * 0.75), 1),
                       8)
            k_per_cell = max(1, min(4, math.ceil(
                n_l / max((lvl_img.shape[0] // cell)
                          * (lvl_img.shape[1] // cell), 1))))
            scores, ys, xs = _cell_topk(resp, cell, k_per_cell)
            vals, sel = topk(scores, min(n_l, scores.shape[0]))
            ys, xs = ys[sel], xs[sel]
            valid = vals > 0
            dy, dx = fast_mod.subpixel_refine(raw_score, ys, xs)
            scale = o.scale_factor ** l
            uv = torch.stack([(xs.to(torch.float32) + dx) * scale,
                              (ys.to(torch.float32) + dy) * scale], -1)
            det.append((uv, torch.where(valid, vals, torch.zeros_like(vals)),
                        valid, ys, xs))
            counts.append((l, ys.shape[0]))
        uv, response, valid, ys, xs = [torch.cat(c) for c in zip(*det)]
        # pass 2: the IC angle and steered BRIEF of every level at once
        level = self._level_ids(tuple(counts), img.device)
        angle, desc = orb_describe(
            levels, (ys - HALF).to(torch.int32), (xs - HALF).to(torch.int32),
            level, self.brief_idx1, self.brief_idx2, radius=o.half_patch)
        kp = Keypoints(uv=uv, response=response, angle=angle, level=level,
                       desc=desc, valid=valid)
        n = kp.uv.shape[0]
        if n < self.n_kp:
            pad = self.n_kp - n
            kp = Keypoints(*[torch.cat(
                [getattr(kp, f), torch.zeros((pad,) + getattr(kp, f).shape[1:],
                                             dtype=getattr(kp, f).dtype,
                                             device=img.device)], 0)
                for f in Keypoints._fields])
        elif n > self.n_kp:
            _, sel = topk(torch.where(kp.valid, kp.response,
                                      torch.full_like(kp.response, -1.0)),
                          self.n_kp)
            kp = Keypoints(*[getattr(kp, f)[sel] for f in Keypoints._fields])
        return kp

    def scale_factors(self):
        o = self.cfg.orb
        return torch.tensor([o.scale_factor ** l for l in range(o.n_levels)],
                            dtype=torch.float32, device=self.device)

    def inv_level_sigma2(self):
        sf = np.asarray([self.cfg.orb.scale_factor ** l
                         for l in range(self.cfg.orb.n_levels)])
        return torch.tensor(1.0 / (sf * sf), dtype=torch.float32,
                            device=self.device)
