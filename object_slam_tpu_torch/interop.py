"""Carry state between the JAX reference and the port as numpy arrays.

The reference's MapState / FrameData / Keypoints fields become the port's
field for field. Descriptors are the only layout change: the reference
stores ``uint32[..., 8]``, the port ``int32[..., 8]`` with the same bits
(``view``, not a value cast), because torch's uint32 lacks bitwise and
shift ops on the CPU.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from object_slam_tpu_torch.features.extractor import Keypoints
from object_slam_tpu_torch.semantic.object2d import empty_slab
from object_slam_tpu_torch.slam.frame import FrameData
from object_slam_tpu_torch.slam.map_state import MapState

_DESC_FIELDS = {"pt_desc", "kf_kp_desc", "desc"}


def _to_torch(name, a, device):
    a = np.array(a)                  # a C-contiguous copy, 0-d stays 0-d
    if name in _DESC_FIELDS:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def _to_numpy(name, t):
    a = np.array(t.detach().cpu().numpy())
    if name in _DESC_FIELDS:
        a = a.view(np.uint32)
    return a


def map_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device="cpu") -> MapState:
    """Reference MapState fields (numpy, uint32 descriptors) -> MapState."""
    return MapState(**{f: _to_torch(f, arrays[f], device)
                       for f in MapState._fields})


def map_state_to_numpy(m: MapState) -> dict:
    """MapState -> numpy fields in the reference's layout."""
    return {f: _to_numpy(f, getattr(m, f)) for f in MapState._fields}


def keypoints_from_numpy(arrays: Mapping[str, np.ndarray],
                         device="cpu") -> Keypoints:
    return Keypoints(**{f: _to_torch(f, arrays[f], device)
                        for f in Keypoints._fields})


def frame_from_numpy(arrays: Mapping[str, np.ndarray], cfg,
                     device="cpu") -> FrameData:
    """Reference FrameData fields except ``obj`` (numpy) -> FrameData with
    an empty detection slab (this slice runs objects off)."""
    fields = {f: _to_torch(f, arrays[f], device)
              for f in FrameData._fields if f != "obj"}
    n = fields["uv"].shape[0]
    obj = empty_slab(cfg.semantic.max_instances, cfg.camera.height,
                     cfg.camera.width, n, device=device)
    return FrameData(obj=obj, **fields)
