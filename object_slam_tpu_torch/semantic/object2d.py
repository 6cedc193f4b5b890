"""Object2D: per-frame instance detections fused with keypoints.

Counterpart of object_slam_tpu/semantic/object2d.py: a keypoint belongs to
an instance iff the full (2*margin)^2 window around it lies inside the
mask and its depth is in (0, th_depth]; each keypoint joins at most one
instance (the first in file order); an instance keeps only with more than
``min_kps`` members; each carries its HSV histogram and the feature
transform of an FT_CROP-sized crop of its mask for the semantic optimizer.
The whole frame's slab builds in batched ops over the [I] instances.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from object_slam_tpu_torch.ops.distance_transform import (
    erode, feature_transform_batch)
from object_slam_tpu_torch.semantic import hsv as hsv_mod

FT_CROP = 256   # per-instance feature-transform window


def pack_mask_bits(masks) -> np.ndarray:
    """Host side: [..., W] bool -> [..., ceil(W/8)] uint8 (np.packbits,
    big-endian bit order), the form in which masks travel to the card."""
    return np.packbits(np.asarray(masks, dtype=bool), axis=-1)


def unpack_mask_bits(packed, width: int):
    """Device side inverse of pack_mask_bits: [..., B] uint8 ->
    [..., width] bool (width <= B*8)."""
    shifts = 7 - torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return flat[..., :width].to(torch.bool)


class Object2DSlab(NamedTuple):
    """Static [I]-capacity slab of per-frame detections (field meanings as
    in the reference): label, prob, bbox [I, 4] (x, y, w, h), kp2obj [N],
    n_kps [I], hist [I, HIST_DIM], ftmap [I, C, C, 2] (crop-local (y, x)),
    ft_origin [I, 2] (y0, x0), masks [I, H, W], centroid_uv [I, 2],
    mean_depth [I], valid [I]."""

    label: torch.Tensor
    prob: torch.Tensor
    bbox: torch.Tensor
    kp2obj: torch.Tensor
    n_kps: torch.Tensor
    hist: torch.Tensor
    ftmap: torch.Tensor
    ft_origin: torch.Tensor
    masks: torch.Tensor
    centroid_uv: torch.Tensor
    mean_depth: torch.Tensor
    valid: torch.Tensor


def build_object2ds(rgb, masks, labels, probs, bboxes, inst_valid,
                    kp_uv, kp_depth, kp_valid,
                    th_depth: float, min_kps: int,
                    mask_margin: int = 10) -> Object2DSlab:
    """Assemble the frame's Object2D slab.

    rgb [H, W, 3] f32 0..255; masks [I, H, W] bool; labels / probs /
    bboxes / inst_valid [I] detector rows; kp_uv [N, 2] RAW (distorted)
    keypoint pixels; kp_depth [N] (-1 invalid); kp_valid [N]."""
    I, h, w = masks.shape
    dev = masks.device
    ar_i = torch.arange(I, device=dev)

    eroded = erode(masks, mask_margin)                          # [I, H, W]
    yy = torch.clamp(torch.round(kp_uv[:, 1]).long(), 0, h - 1)
    xx = torch.clamp(torch.round(kp_uv[:, 0]).long(), 0, w - 1)
    interior = eroded[:, yy, xx]                                # [I, N]

    depth_ok = (kp_depth > 0) & (kp_depth <= th_depth)
    member = (interior & depth_ok[None, :] & kp_valid[None, :]
              & inst_valid[:, None])

    # first instance wins (file order)
    first = torch.argmax(member.to(torch.int32), dim=0)         # [N]
    any_m = torch.any(member, dim=0)
    kp2obj_pre = torch.where(any_m, first, torch.full_like(first, -1))

    one_hot = (kp2obj_pre[None, :] == ar_i[:, None]) & any_m[None, :]
    n_kps = torch.sum(one_hot, dim=1).to(torch.int32)
    valid = inst_valid & (n_kps > min_kps)
    kp2obj = torch.where(valid[torch.clamp(kp2obj_pre, 0, I - 1)] & any_m,
                         kp2obj_pre, torch.full_like(kp2obj_pre, -1))

    w_kp = one_hot.to(torch.float32) * valid[:, None]
    denom = torch.clamp(torch.sum(w_kp, dim=1), min=1.0)
    centroid_uv = (w_kp @ kp_uv) / denom[:, None]
    mean_depth = (w_kp @ torch.where(depth_ok, kp_depth,
                                     torch.zeros_like(kp_depth))) / denom

    hists = hsv_mod.batched_histograms(rgb, masks)

    # feature transform on per-instance crops around the detector bbox
    ch, cw = min(FT_CROP, h), min(FT_CROP, w)
    cy = torch.clamp((bboxes[:, 1] + bboxes[:, 3] / 2).to(torch.int32)
                     - FT_CROP // 2, 0, max(h - FT_CROP, 0))
    cx = torch.clamp((bboxes[:, 0] + bboxes[:, 2] / 2).to(torch.int32)
                     - FT_CROP // 2, 0, max(w - FT_CROP, 0))
    rows = cy.long()[:, None] + torch.arange(ch, device=dev)[None]
    cols = cx.long()[:, None] + torch.arange(cw, device=dev)[None]
    crops = masks[ar_i[:, None, None], rows[:, :, None], cols[:, None, :]]
    ftmaps = feature_transform_batch(crops)                    # [I, C, C, 2]

    return Object2DSlab(
        label=labels.to(torch.int32), prob=probs, bbox=bboxes,
        kp2obj=kp2obj.to(torch.int32), n_kps=n_kps, hist=hists,
        ftmap=ftmaps, ft_origin=torch.stack([cy, cx], -1).to(torch.int32),
        masks=masks, centroid_uv=centroid_uv, mean_depth=mean_depth,
        valid=valid)


def empty_slab(max_instances: int, height: int, width: int, n_kp: int,
               device=None) -> Object2DSlab:
    I, H, W = max_instances, height, width
    i32, f32 = torch.int32, torch.float32

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=device)

    return Object2DSlab(
        label=full((I,), -1, i32), prob=full((I,), 0.0, f32),
        bbox=full((I, 4), 0.0, f32), kp2obj=full((n_kp,), -1, i32),
        n_kps=full((I,), 0, i32), hist=full((I, hsv_mod.HIST_DIM), 0.0, f32),
        ftmap=full((I, min(FT_CROP, H), min(FT_CROP, W), 2), -1.0, f32),
        ft_origin=full((I, 2), 0, i32),
        masks=full((I, H, W), False, torch.bool),
        centroid_uv=full((I, 2), 0.0, f32), mean_depth=full((I,), 0.0, f32),
        valid=full((I,), False, torch.bool))


def bbox_iou_2d(boxes_a, boxes_b):
    """[A, 4] x [B, 4] (x, y, w, h) -> IoU [A, B]."""
    ax0, ay0 = boxes_a[:, 0], boxes_a[:, 1]
    ax1, ay1 = ax0 + boxes_a[:, 2], ay0 + boxes_a[:, 3]
    bx0, by0 = boxes_b[:, 0], boxes_b[:, 1]
    bx1, by1 = bx0 + boxes_b[:, 2], by0 + boxes_b[:, 3]
    ix = torch.clamp(torch.minimum(ax1[:, None], bx1[None])
                     - torch.maximum(ax0[:, None], bx0[None]), min=0.0)
    iy = torch.clamp(torch.minimum(ay1[:, None], by1[None])
                     - torch.maximum(ay0[:, None], by0[None]), min=0.0)
    inter = ix * iy
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-9)
