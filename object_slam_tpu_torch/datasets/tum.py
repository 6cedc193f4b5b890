"""TUM RGB-D dataset loader.

A numpy copy of object_slam_tpu/datasets/tum.py: ``associate.py``-style
rgb/depth pairing by timestamp (rgbd_tum.cc:33-76 reads the association),
the ground truth, and the per-frame YOLACT semantic directory
(Semantic.cc:57). Images are decoded by datasets/png.py; the frame arrays
stay in their compact transfer types (u8 rgb, raw u16 depth), which the
frame builder converts on the device. ``write_sequence`` writes such a
directory from rendered frames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from object_slam_tpu_torch.datasets.png import read_png, write_png
from object_slam_tpu_torch.eval.ate import associate_timestamps
from object_slam_tpu_torch.eval.trajectory_io import _rot_to_quat
from object_slam_tpu_torch.semantic import loader as sem_loader


@dataclass
class TumFrame:
    timestamp: float
    rgb_path: str
    depth_path: str


def read_file_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def load_sequence(seq_dir: str, max_dt: float = 0.02) -> List[TumFrame]:
    rgb = read_file_list(os.path.join(seq_dir, 'rgb.txt'))
    depth = read_file_list(os.path.join(seq_dir, 'depth.txt'))
    pairs = associate_timestamps([t for t, _ in rgb], [t for t, _ in depth],
                                 max_dt)
    return [TumFrame(timestamp=rgb[ia][0],
                     rgb_path=os.path.join(seq_dir, rgb[ia][1]),
                     depth_path=os.path.join(seq_dir, depth[ib][1]))
            for ia, ib in pairs]


def load_frame_raw(frame: TumFrame):
    """(rgb [H, W, 3] uint8, depth [H, W] uint16 raw) of one frame; a gray
    image becomes three equal channels."""
    return frame_arrays(read_png(frame.rgb_path), read_png(frame.depth_path),
                        frame.depth_path)


def load_frame_arrays(frame: TumFrame, depth_factor: float):
    """(gray [H, W] f32, depth [H, W] f32 metric, rgb [H, W, 3] f32), as
    the reference's loader returns them: a gray image becomes three equal
    channels, gray is rgb @ (0.299, 0.587, 0.114) in f32, depth the raw
    values over depth_factor."""
    rgb = read_png(frame.rgb_path).astype(np.float32)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, -1)
    gray = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    d = read_png(frame.depth_path).astype(np.float32) / depth_factor
    return gray, d, rgb


def frame_arrays(rgb: np.ndarray, depth: np.ndarray, depth_path: str = ""):
    """Decoded rgb and depth images (read_png's, or the native
    prefetcher's) -> load_frame_raw's (rgb [H, W, 3] u8, depth u16)."""
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, -1)
    if depth.dtype != np.uint16:
        raise ValueError(f"{depth_path}: depth must be 16-bit gray")
    return rgb[..., :3], depth


def load_groundtruth(seq_dir: str):
    """groundtruth.txt -> (timestamps [N], positions [N, 3], quats [N, 4])."""
    ts, pos, quat = [], [], []
    with open(os.path.join(seq_dir, 'groundtruth.txt')) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            pos.append(v[1:4])
            quat.append(v[4:8])
    return np.array(ts), np.array(pos), np.array(quat)


def load_semantics(semantic_dir: str, timestamp: float, cfg):
    dets = sem_loader.read_semantic_dir(
        semantic_dir, sem_loader.tum_frame_key(timestamp),
        cfg.semantic.min_confidence, cfg.semantic.valid_labels_tum)
    return sem_loader.detections_to_arrays(
        dets, cfg.semantic.max_instances, cfg.camera.height, cfg.camera.width)


def write_sequence(out: str, poses, renders, depth_map_factor: float,
                   t0: float = 1000.0):
    """A TUM-format sequence as scripts/make_synth_tum.py writes it: rgb/
    and depth/ PNGs (u8 rgb, raw u16 depth = metric x depth_map_factor),
    rgb.txt, depth.txt, groundtruth.txt (30 Hz from t0) and a
    YOLACT-format semantic/ folder (each valid detection's line and its
    0/255 mask). poses: world-to-camera [4, 4]; renders: per pose (depth
    [H, W] metric, rgb [H, W, 3], the frame's sem_arrays slab)."""
    for sub in ("rgb", "depth", "semantic"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, (T, (depth, rgb, sem)) in enumerate(zip(poses, renders)):
        key = f"{t0 + i / 30.0:.6f}"
        write_png(os.path.join(out, "rgb", key + ".png"),
                  np.clip(rgb, 0, 255).astype(np.uint8))
        write_png(os.path.join(out, "depth", key + ".png"),
                  np.clip(depth * depth_map_factor, 0,
                          65535).astype(np.uint16))
        rgb_lines.append(f"{key} rgb/{key}.png")
        depth_lines.append(f"{key} depth/{key}.png")
        Twc = np.linalg.inv(T)
        t, q = Twc[:3, 3], _rot_to_quat(Twc[:3, :3])
        gt_lines.append(f"{key} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        masks, labels, probs, bboxes, valid = sem
        fdir = os.path.join(out, "semantic", key)
        os.makedirs(fdir, exist_ok=True)
        with open(os.path.join(fdir, key + ".txt"), "w") as f:
            for j in np.flatnonzero(valid):
                x, y, w, h = bboxes[j]
                f.write(f"{labels[j]} {probs[j]:.3f} {int(x)} {int(y)} "
                        f"{int(w)} {int(h)} {j}\n")
                write_png(os.path.join(fdir, f"{j}.png"),
                          (np.asarray(masks[j]) * 255).astype(np.uint8))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out, name), "w") as f:
            f.write("# synthetic\n" + "\n".join(lines) + "\n")
