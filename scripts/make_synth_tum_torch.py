#!/usr/bin/env python
"""Write a TUM-RGB-D-format sequence (+ a YOLACT-format semantic folder)
from the port's synthetic ray-cast room, without PIL or JAX.

The port's counterpart of scripts/make_synth_tum.py, with its arguments
and its output: rgb/ and depth/ PNGs (u8 rgb, raw u16 depth), rgb.txt,
depth.txt, groundtruth.txt (30 Hz from t = 1000 s) and semantic/<key>/
(one line and one 0/255 mask PNG per detected box). The text files equal
the reference script's byte for byte and every PNG decodes to the same
array (the PNG bytes differ: the port's zlib writer,
object_slam_tpu_torch/datasets/png.py). The room is the reference's:
``SyntheticScene.make(cfg, seed, n_objects=3, plane_z=4.0)`` with boxes of
size 0.9 (bench.py's room at the default seed 3).

Usage:
  python scripts/make_synth_tum_torch.py --out DIR [--frames 60]
      [--step 0.01] [--traj orbit|loop] [--turns 1.0] [--seed 3]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def room(cfg, seed: int):
    """make_synth_tum.py's room: 3 boxes of size 0.9 on the z = 4 plane."""
    from object_slam_tpu_torch.datasets.synthetic import SyntheticScene
    scene = SyntheticScene.make(cfg, seed=seed, n_objects=3, plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene


def poses_for(frames: int, step: float, traj: str, turns: float):
    from object_slam_tpu_torch.datasets.synthetic import (loop_trajectory,
                                                          orbit_poses)
    if traj == "loop":
        return loop_trajectory(frames, sweep=2 * np.pi * turns)
    return orbit_poses(frames, step=step)


def write(out: str, frames: int = 60, step: float = 0.01,
          traj: str = "orbit", turns: float = 1.0, seed: int = 3):
    """Render and write the sequence; returns the number of frames."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    cfg = SlamConfig.tum_rgbd()
    scene = room(cfg, seed)
    poses = poses_for(frames, step, traj, turns)

    def renders():
        for T in poses:
            _, depth, rgb, sem = scene.render_rgbd(T)
            yield depth, rgb, scene.sem_arrays(sem,
                                               cfg.semantic.max_instances)
    tum.write_sequence(out, poses, renders(), cfg.camera.depth_map_factor)
    return len(poses)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--step", type=float, default=0.01)
    ap.add_argument("--traj", choices=["orbit", "loop"], default="orbit",
                    help="'loop' = closed in-room circuit that revisits "
                         "the start (loop-closure / long-sequence testing)")
    ap.add_argument("--turns", type=float, default=1.0,
                    help="loop sweep in full turns; >1 retraces the ring")
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    n = write(args.out, args.frames, args.step, args.traj, args.turns,
              args.seed)
    print(f"wrote {n} frames to {args.out} (semantic dir: "
          f"{os.path.join(args.out, 'semantic')})")


if __name__ == "__main__":
    main()
