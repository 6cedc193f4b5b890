"""Map checkpoint / resume.

Counterpart of object_slam_tpu/slam/checkpoint.py, in the same file
format, so a checkpoint passes between the packages in both directions:
one ``.npz`` with every MapState field under its own name in the
reference's layout (descriptors as ``uint32[..., 8]``, interop.py) and a
``_oslam_meta`` entry, the UTF-8 bytes of a JSON object with the field
list, ``version`` 1 and, from ``save_system``, the tracker's bookkeeping.

``load_map`` backfills two fields that older files lack: ``kf_tcp`` with
the identity (never culled), as the reference does, and ``kf_frame_id``
with -1 (unknown), where the reference raises KeyError.

``load_into_system`` restores what the reference restores: the map, the
state, the last keyframe, the keyframe gap, the frame counter and the
velocity. The last frame, the trajectory and the keyframe inlier anchor
are not in the file, so a fresh system that loads a checkpoint taken in
state OK has no last frame to track against; loading into the system
that wrote it resumes it.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.slam.map_state import MapState

_META = "_oslam_meta"


def save_map(path: str, m: MapState, extra: dict | None = None):
    """Write the map state (and optional metadata) to one .npz file."""
    arrays = interop.map_state_to_numpy(m)
    meta = dict(extra or {})
    meta["fields"] = list(MapState._fields)
    meta["version"] = 1
    arrays[_META] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_map(path: str, device=None):
    """(MapState on ``device``, metadata dict); device None is the card."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data[_META]).decode()) if _META in data else {}
    arrays = {}
    for f in MapState._fields:
        if f in data:
            arrays[f] = data[f]
        elif f == "kf_tcp":
            K = data["kf_pose"].shape[0]
            arrays[f] = np.broadcast_to(np.eye(4, dtype=np.float32),
                                        (K, 4, 4))
        elif f == "kf_frame_id":
            arrays[f] = np.full(data["kf_pose"].shape[0], -1, np.int32)
        else:
            raise KeyError(f"checkpoint missing field {f}")
    return interop.map_state_from_numpy(arrays, device=device), meta


def save_system(path: str, system):
    """Snapshot a SlamSystem: the map and the tracker's bookkeeping."""
    extra = {
        "state": system.state,
        "last_kf_id": system.last_kf_id,
        "frames_since_kf": system.frames_since_kf,
        "frame_id": system.frame_id,
        "velocity": system.velocity.cpu().numpy().tolist(),
        "n_trajectory": len(system.trajectory),
    }
    save_map(path, system.map, extra)


def load_into_system(path: str, system):
    """Set system's map and bookkeeping from a checkpoint; returns the
    metadata."""
    m, meta = load_map(path, device=system.device)
    system.map = m
    system.state = int(meta.get("state", 0))
    system.last_kf_id = int(meta.get("last_kf_id", -1))
    system.frames_since_kf = int(meta.get("frames_since_kf", 0))
    system.frame_id = int(meta.get("frame_id", 0))
    if "velocity" in meta:
        system.velocity = torch.tensor(meta["velocity"], dtype=torch.float32,
                                       device=system.device)
    return meta
