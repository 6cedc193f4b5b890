#!/usr/bin/env python
"""Train an ORB vocabulary on synthetic-scene descriptors with the PyTorch
port: the port's counterpart of scripts/train_vocab.py.

harvest() runs the port's ORB extractor on the card (one orb_describe
launch per render) over n_scenes synthetic rooms
(``SyntheticScene.make(cfg, seed=s, n_objects=2, plane_z=3.2 + 0.3 s)``)
seen from ``loop_trajectory(n_poses)``, at TUM VGA; training is the host
hierarchical k-medians of loop/vocabulary.py (``Vocabulary.train``, seed
0), and the tree is written in the DBoW2 text format
(``Vocabulary.load_dbow2_text`` reads it back).

Usage:
  python scripts/train_vocab_torch.py [--branching 10] [--depth 4]
      [--scenes 10] [--out PATH] [--device cuda|cpu]
(--out defaults to the port's object_slam_tpu_torch/loop/vocab_synth.txt)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "object_slam_tpu_torch", "loop", "vocab_synth.txt")


def harvest(n_scenes=10, n_poses=8, device=None, log=print):
    """The valid keypoints' descriptors of every render, [M, 8] uint32."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    from object_slam_tpu_torch.features.extractor import OrbExtractor

    cfg = SlamConfig.tum_rgbd()
    # the reference's pyramid order on any device (no tracking follows)
    ex = OrbExtractor(cfg, device=device, pyramid_order="xla")
    descs = []
    for seed in range(n_scenes):
        scene = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                                    plane_z=3.2 + 0.3 * seed)
        for T in loop_trajectory(n_poses):
            gray = scene.render_rgbd(T)[0]
            kp = ex(torch.from_numpy(np.asarray(gray, np.float32)).to(
                ex.device))
            v = kp.valid.cpu().numpy()
            descs.append(kp.desc.cpu().numpy().view(np.uint32)[v])
        log(f"scene {seed}: corpus {sum(d.shape[0] for d in descs)}")
    return np.concatenate(descs, 0)


def train(descs, branching=10, depth=4):
    from object_slam_tpu_torch.loop.vocabulary import Vocabulary
    return Vocabulary.train(descs, branching, depth, seed=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.ops import build
    device = resolve_device(args.device)
    if device.type == "cuda":
        build.load_all(["orb_describe"])
    t0 = time.perf_counter()
    descs = harvest(n_scenes=args.scenes, device=device)
    t1 = time.perf_counter()
    print(f"training k={args.branching} L={args.depth} on {descs.shape[0]} "
          f"(harvest {t1 - t0:.1f} s)", flush=True)
    voc = train(descs, args.branching, args.depth)
    voc.save_dbow2_text(args.out)
    print(f"saved {args.out} ({voc.n_words} words; training "
          f"{time.perf_counter() - t1:.1f} s)")


if __name__ == "__main__":
    main()
