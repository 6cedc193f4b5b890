"""Host-side loader for offline YOLACT instance-segmentation results.

A numpy copy of object_slam_tpu/semantic/loader.py (format parity with
``Semantic::ReadSemanticTUMRGBD`` / ``ReadSemanticKittiStereo``,
Semantic.cc:14-100): per frame a directory ``<semantic_dir>/<frame>/``
holding ``<frame>.txt`` with lines ``label prob x y w h instance_id`` and a
binary mask PNG ``<instance_id>.png`` per instance. TUM keys frames by the
timestamp string (6 decimals), KITTI by a 6-digit counter. Label 63
(laptop) becomes 62 (tv) for TUM; rows are kept for ``prob >
min_confidence`` and the dataset's label whitelist.

Masks are decoded by datasets/png.py instead of PIL. As in the reference,
a mask file that cannot be opened drops its detection; a file that is not
a supported PNG raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from object_slam_tpu_torch.datasets.png import read_png


@dataclass
class Detection:
    label: int
    prob: float
    bbox: np.ndarray          # (x, y, w, h)
    mask: np.ndarray          # [H, W] bool


def _read_mask(path: str) -> Optional[np.ndarray]:
    try:
        m = read_png(path)
    except OSError:
        return None
    if m.ndim == 3:
        m = m[..., 0]
    return m == 255


def read_semantic_dir(semantic_dir: str, frame_key: str,
                      min_confidence: float, valid_labels,
                      remap_63_to_62: bool = True) -> List[Detection]:
    """Parse one frame's detections. frame_key is the per-dataset directory
    name (TUM: timestamp string; KITTI: zero-padded counter)."""
    frame_dir = os.path.join(semantic_dir, frame_key)
    txt = os.path.join(frame_dir, frame_key + ".txt")
    dets: List[Detection] = []
    if not os.path.isfile(txt):
        return dets
    valid = set(valid_labels)
    with open(txt) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 7:
                continue
            label = int(parts[0])
            if remap_63_to_62 and label == 63:
                label = 62
            prob = float(parts[1])
            if prob <= min_confidence:
                continue
            if label not in valid:
                continue
            x, y, w, h = (float(parts[2]), float(parts[3]),
                          float(parts[4]), float(parts[5]))
            inst = int(parts[6])
            mask = _read_mask(os.path.join(frame_dir, f"{inst}.png"))
            if mask is None:
                continue
            dets.append(Detection(label=label, prob=prob,
                                  bbox=np.array([x, y, w, h], np.float32),
                                  mask=mask))
    return dets


def tum_frame_key(timestamp: float) -> str:
    """std::to_string(double) renders 6 decimal places."""
    return f"{timestamp:.6f}"


def kitti_frame_key(index: int) -> str:
    return f"{index:06d}"


def detections_to_arrays(dets: List[Detection], max_instances: int,
                         height: int, width: int):
    """Pad detections into the static [I] slab arrays (numpy, host side)."""
    I = max_instances
    masks = np.zeros((I, height, width), bool)
    labels = np.full((I,), -1, np.int32)
    probs = np.zeros((I,), np.float32)
    bboxes = np.zeros((I, 4), np.float32)
    valid = np.zeros((I,), bool)
    for i, d in enumerate(dets[:I]):
        masks[i] = d.mask
        labels[i] = d.label
        probs[i] = d.prob
        bboxes[i] = d.bbox
        valid[i] = True
    return masks, labels, probs, bboxes, valid
