"""Object2D slab: per-frame instance detections fused with keypoints.

Counterpart of object_slam_tpu/semantic/object2d.py, reduced to what the
objects-off slice needs: the slab's layout and the empty slab that every
frame carries. ``build_object2ds`` (mask erosion, HSV histograms, feature
transforms) is the next slice's work (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.semantic.hsv import HIST_DIM

FT_CROP = 256   # per-instance feature-transform window


class Object2DSlab(NamedTuple):
    """Static [I]-capacity slab of per-frame detections (field meanings as
    in the reference): label, prob, bbox [I, 4] (x, y, w, h), kp2obj [N],
    n_kps [I], hist [I, HIST_DIM], ftmap [I, C, C, 2], ft_origin [I, 2],
    masks [I, H, W], centroid_uv [I, 2], mean_depth [I], valid [I]."""

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


def empty_slab(max_instances: int, height: int, width: int, n_kp: int,
               device=None) -> Object2DSlab:
    I, H, W = max_instances, height, width
    i32, f32 = torch.int32, torch.float32

    def full(shape, val, dtype):
        return torch.full(shape, val, dtype=dtype, device=device)

    return Object2DSlab(
        label=full((I,), -1, i32), prob=full((I,), 0.0, f32),
        bbox=full((I, 4), 0.0, f32), kp2obj=full((n_kp,), -1, i32),
        n_kps=full((I,), 0, i32), hist=full((I, HIST_DIM), 0.0, f32),
        ftmap=full((I, min(FT_CROP, H), min(FT_CROP, W), 2), -1.0, f32),
        ft_origin=full((I, 2), 0, i32),
        masks=full((I, H, W), False, torch.bool),
        centroid_uv=full((I, 2), 0.0, f32), mean_depth=full((I,), 0.0, f32),
        valid=full((I,), False, torch.bool))
