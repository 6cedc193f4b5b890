"""KITTI odometry stereo loader.

A numpy copy of object_slam_tpu/datasets/kitti.py (Examples/Stereo/
stereo_kitti.cc:28-60: image_0 / image_1 + times.txt; the semantic
directory keyed by the zero-padded frame counter, Semantic.cc:14-55; the
ground truth as 3x4 row-major camera-to-world rows). Images are decoded
by datasets/png.py, which needs no PIL. ``write_sequence`` writes such a
directory from rendered frames, as scripts/make_synth_kitti.py does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from object_slam_tpu_torch.datasets.png import read_png, write_png
from object_slam_tpu_torch.semantic import loader as sem_loader

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


@dataclass
class KittiFrame:
    index: int
    timestamp: float
    left_path: str
    right_path: str


def load_sequence(seq_dir: str) -> List[KittiFrame]:
    with open(os.path.join(seq_dir, 'times.txt')) as f:
        times = [float(x) for x in f.read().split()]
    frames = []
    for i, t in enumerate(times):
        name = f"{i:06d}.png"
        frames.append(KittiFrame(
            index=i, timestamp=t,
            left_path=os.path.join(seq_dir, 'image_0', name),
            right_path=os.path.join(seq_dir, 'image_1', name)))
    return frames


def load_frame_arrays(frame: KittiFrame):
    """(gray_l, gray_r, rgb) as f32, an RGB file reduced to its luma and
    rgb the left image three times (the reference's loader)."""
    gl = read_png(frame.left_path).astype(np.float32)
    gr = read_png(frame.right_path).astype(np.float32)
    if gl.ndim == 3:
        gl = gl[..., :3] @ _LUMA
        gr = gr[..., :3] @ _LUMA
    return gl, gr, np.stack([gl] * 3, -1)


def load_frame_raw(frame: KittiFrame):
    """(gray_l, gray_r) as u8, the compact form the frame builder takes
    (an RGB file's luma truncated to u8, as scripts/run_kitti.py does)."""
    return gray_pair(read_png(frame.left_path), read_png(frame.right_path))


def gray_pair(gl: np.ndarray, gr: np.ndarray):
    """Decoded left and right images (read_png's, or the native
    prefetcher's) -> load_frame_raw's u8 gray pair."""
    if gl.ndim == 3:
        gl = (gl[..., :3].astype(np.float32) @ _LUMA).astype(np.uint8)
        gr = (gr[..., :3].astype(np.float32) @ _LUMA).astype(np.uint8)
    return gl.astype(np.uint8), gr.astype(np.uint8)


def load_groundtruth(path: str):
    """KITTI gt: [N, 4, 4] camera-to-world."""
    out = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) != 12:
                continue
            T = np.eye(4)
            T[:3, :4] = np.array(v).reshape(3, 4)
            out.append(T)
    return np.stack(out)


def load_semantics(semantic_dir: str, index: int, cfg):
    dets = sem_loader.read_semantic_dir(
        semantic_dir, sem_loader.kitti_frame_key(index),
        cfg.semantic.min_confidence, cfg.semantic.valid_labels_kitti,
        remap_63_to_62=False)
    return sem_loader.detections_to_arrays(
        dets, cfg.semantic.max_instances, cfg.camera.height, cfg.camera.width)


def write_sequence(out: str, poses, frames):
    """A KITTI odometry sequence as scripts/make_synth_kitti.py writes it:
    image_0/ and image_1/ u8 PNGs, times.txt (10 Hz), gt.txt (3x4
    camera-to-world rows) and a YOLACT-format semantic/ folder keyed by
    the zero-padded frame counter (each valid detection's line and its
    0/255 mask). poses: world-to-camera [4, 4]; frames: per pose (gray_l
    u8, gray_r u8, the left view's sem_arrays slab)."""
    for sub in ("image_0", "image_1", "semantic"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    times, gt_lines = [], []
    for i, (T, (gl, gr, sem)) in enumerate(zip(poses, frames)):
        key = sem_loader.kitti_frame_key(i)
        write_png(os.path.join(out, "image_0", f"{i:06d}.png"), gl)
        write_png(os.path.join(out, "image_1", f"{i:06d}.png"), gr)
        times.append(f"{i / 10.0:.6e}")
        Twc = np.linalg.inv(T)
        gt_lines.append(" ".join(f"{x:.9e}" for x in Twc[:3].reshape(-1)))
        masks, labels, probs, bboxes, valid = sem
        fdir = os.path.join(out, "semantic", key)
        os.makedirs(fdir, exist_ok=True)
        with open(os.path.join(fdir, key + ".txt"), "w") as f:
            for j in np.flatnonzero(valid):
                x, y, w, h = bboxes[j]
                f.write(f"{labels[j]} {probs[j]:.3f} {x} {y} {w} {h} {j}\n")
                write_png(os.path.join(fdir, f"{j}.png"),
                          (np.asarray(masks[j]) * 255).astype(np.uint8))
    for name, lines in (("times.txt", times), ("gt.txt", gt_lines)):
        with open(os.path.join(out, name), "w") as f:
            f.write("\n".join(lines) + "\n")
