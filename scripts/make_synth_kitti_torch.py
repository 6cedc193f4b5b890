#!/usr/bin/env python
"""Write a KITTI-odometry-format stereo sequence (+ a KITTI-keyed
YOLACT-format semantic folder with car masks) from the port's synthetic
street canyon, without PIL or JAX.

The port's counterpart of scripts/make_synth_kitti.py, with its arguments
and its output: image_0/ and image_1/ u8 PNGs, times.txt (10 Hz), gt.txt
(3x4 row-major camera-to-world rows) and semantic/<frame>/ (one line and
one 0/255 mask PNG per detected car, label 2). The text files equal the
reference script's byte for byte and every PNG decodes to the same array
(the PNG bytes differ: the port's zlib writer). A pool of spawned
processes renders the frames (datasets/synthetic.py::render_street), as
the reference's fork pool does.

Usage:
  python scripts/make_synth_kitti_torch.py --out DIR [--frames 150]
      [--speed 0.8] [--seed 5]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def write(out: str, frames: int = 150, speed: float = 0.8, seed: int = 5,
          workers=None):
    """Render and write the sequence; returns the render seconds."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.synthetic import render_street
    cfg = SlamConfig.kitti_stereo()
    poses, rendered, secs = render_street(cfg, frames, workers=workers,
                                          speed=speed, seed=seed)
    # the reference writes the renderer's integer boxes
    kitti.write_sequence(out, poses, [
        (gl, gr, sem[:3] + (sem[3].astype(int), sem[4]))
        for gl, gr, sem in rendered])
    return secs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--speed", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    secs = write(args.out, args.frames, args.speed, args.seed)
    print(f"wrote {args.frames} stereo frames to {args.out} (rendered in "
          f"{secs:.1f} s)")


if __name__ == "__main__":
    main()
