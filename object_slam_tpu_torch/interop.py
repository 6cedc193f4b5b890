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
from object_slam_tpu_torch.loop.vocabulary import Vocabulary
from object_slam_tpu_torch.semantic.object2d import Object2DSlab, empty_slab
from object_slam_tpu_torch.slam.frame import FrameData
from object_slam_tpu_torch.slam.map_state import MapState
from object_slam_tpu_torch.solvers.ba import BAProblem

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


def overlay_rows(base: Mapping[str, np.ndarray],
                 rows: Mapping[str, np.ndarray]) -> dict:
    """base's numpy fields with each field of rows laid over its leading
    rows; a scalar, or a field whose leading size is base's, replaces it.
    The inverse of trimming a map's trailing rows that equal those of
    base (the map as init_map leaves it), which keeps a reference map of
    65,536 points and 1,024 keyframes small on disk."""
    out = dict(base)
    for f, v in rows.items():
        if v.ndim == 0 or v.shape[0] == base[f].shape[0]:
            out[f] = v
        else:
            full = base[f].copy()
            full[:v.shape[0]] = v
            out[f] = full
    return out


def stage_maps(arrays: Mapping[str, np.ndarray], base, names) -> dict:
    """The maps of a recorded local-mapping pass (make_reference.py
    ``kitti_pass``): "in", the pass's input, as trimmed rows over base
    (overlay_rows); then per stage name in order, the rows it changed in
    the map before it: ``<name>.<field>@idx`` (row indices) and
    ``<name>.<field>@rows``, or ``<name>.<field>`` whole. Returns {name:
    numpy map}."""
    def under(prefix):
        return {k[len(prefix) + 1:]: arrays[k] for k in arrays.files
                if k.startswith(prefix + ".")}
    maps = {"in": overlay_rows(base, under("in"))}
    prev = maps["in"]
    for name in names:
        cur = dict(prev)
        for k, v in under(name).items():
            f, _, part = k.partition("@")
            if not part:
                cur[f] = v
            elif part == "idx":
                a = prev[f].copy()
                a[v] = under(name)[f + "@rows"]
                cur[f] = a
        maps[name] = prev = cur
    return maps


def ba_problem_from_numpy(arrays: Mapping[str, np.ndarray],
                          device=None) -> BAProblem:
    """Reference BAProblem fields (numpy) -> BAProblem on ``device``."""
    device = resolve_device(device)
    return BAProblem(**{f: _to_torch(f, arrays[f], device)
                        for f in BAProblem._fields})


def ba_problem_to_numpy(prob: BAProblem) -> dict:
    return {f: _to_numpy(f, getattr(prob, f)) for f in BAProblem._fields}


def stack_numpy(trees) -> dict:
    """Field dicts of one structure (a frame's nested "obj" dict included)
    stacked field by field along a new axis 0: the numpy form of a batch
    (parallel/batched_tracking.py); map_state_from_numpy and
    frame_from_numpy(..., obj=stacked["obj"]) take it as it is."""
    return {k: stack_numpy([t[k] for t in trees]) if isinstance(v, dict)
            else np.stack([np.asarray(t[k]) for t in trees])
            for k, v in trees[0].items()}


def unstack_numpy(tree) -> list:
    """The inverse of stack_numpy: a list of per-element field dicts."""
    parts = {k: unstack_numpy(v) if isinstance(v, dict) else list(v)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[b] for k, p in parts.items()} for b in range(n)]


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


def vocabulary_from_numpy(centers, idf) -> Vocabulary:
    """The reference Vocabulary's level tables (a list of [k^(l+1), 8]
    uint32 arrays) and idf -> the port's Vocabulary."""
    return Vocabulary([np.asarray(c, np.uint32) for c in centers],
                      np.asarray(idf, np.float32))


def loop_state_to_numpy(closer) -> dict:
    """A LoopCloser's host state (the reference's or the port's): the
    consistency groups as members (concatenated), their sizes and counts;
    last_loop_kf and the cooldown."""
    groups = closer.consistent_groups
    return {
        "group_members": np.asarray(
            [k for g, _ in groups for k in sorted(g)], np.int32),
        "group_sizes": np.asarray([len(g) for g, _ in groups], np.int32),
        "group_counts": np.asarray([c for _, c in groups], np.int32),
        "last_loop_kf": np.int32(closer.last_loop_kf),
        "cooldown": np.int32(closer._cooldown),
    }


def loop_state_from_numpy(closer, arrays: Mapping[str, np.ndarray]):
    """Set a LoopCloser's host state from loop_state_to_numpy's arrays."""
    members = np.asarray(arrays["group_members"]).tolist()
    groups, at = [], 0
    for size, cnt in zip(np.asarray(arrays["group_sizes"]).tolist(),
                         np.asarray(arrays["group_counts"]).tolist()):
        groups.append((set(members[at:at + size]), int(cnt)))
        at += size
    closer.consistent_groups = groups
    closer.last_loop_kf = int(arrays["last_loop_kf"])
    closer._cooldown = int(arrays["cooldown"])
    return closer
