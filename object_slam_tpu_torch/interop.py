"""Carry state between the JAX reference and the port as numpy arrays.

The reference's MapState / FrameData / Object2DSlab / Keypoints fields
become the port's field for field, on the card unless the caller passes
``device="cpu"``. Descriptors are the only layout change: the reference
stores ``uint32[..., 8]``, the port ``int32[..., 8]`` with the same bits
(``view``, not a value cast), because torch's uint32 lacks bitwise and
shift ops on the CPU.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.features.extractor import Keypoints
from object_slam_tpu_torch.semantic.object2d import Object2DSlab, empty_slab
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
                         device=None) -> MapState:
    """Reference MapState fields (numpy, uint32 descriptors) -> MapState
    on ``device`` (None: the card)."""
    device = resolve_device(device)
    return MapState(**{f: _to_torch(f, arrays[f], device)
                       for f in MapState._fields})


def map_state_to_numpy(m: MapState) -> dict:
    """MapState -> numpy fields in the reference's layout."""
    return {f: _to_numpy(f, getattr(m, f)) for f in MapState._fields}


def keypoints_from_numpy(arrays: Mapping[str, np.ndarray],
                         device=None) -> Keypoints:
    device = resolve_device(device)
    return Keypoints(**{f: _to_torch(f, arrays[f], device)
                        for f in Keypoints._fields})


def slab_from_numpy(arrays: Mapping[str, np.ndarray],
                    device=None) -> Object2DSlab:
    """Reference Object2DSlab fields (numpy) -> Object2DSlab."""
    device = resolve_device(device)
    return Object2DSlab(**{f: _to_torch(f, arrays[f], device)
                           for f in Object2DSlab._fields})


def slab_to_numpy(slab: Object2DSlab) -> dict:
    return {f: _to_numpy(f, getattr(slab, f)) for f in Object2DSlab._fields}


def frame_from_numpy(arrays: Mapping[str, np.ndarray], cfg, device=None,
                     obj: Mapping[str, np.ndarray] = None) -> FrameData:
    """Reference FrameData fields except ``obj`` (numpy) -> FrameData. The
    detection slab comes from ``obj`` (Object2DSlab fields), or is the
    empty slab when ``obj`` is None."""
    device = resolve_device(device)
    fields = {f: _to_torch(f, arrays[f], device)
              for f in FrameData._fields if f != "obj"}
    if obj is None:
        slab = empty_slab(cfg.semantic.max_instances, cfg.camera.height,
                          cfg.camera.width, fields["uv"].shape[0],
                          device=device)
    else:
        slab = slab_from_numpy(obj, device=device)
    return FrameData(obj=slab, **fields)


def frame_to_numpy(fr: FrameData) -> dict:
    """FrameData -> numpy fields (the slab under "obj", a dict)."""
    out = {f: _to_numpy(f, getattr(fr, f))
           for f in FrameData._fields if f != "obj"}
    out["obj"] = slab_to_numpy(fr.obj)
    return out
