#!/usr/bin/env python
"""Does the semantic pose refinement pay off under MASK NOISE? The PyTorch
port's counterpart of scripts/diag_semopt_ragged.py.

Exact renderer masks leave the mask-attraction constraints
(ObjectOptimizer.cc:624 M_joint / M_semantic) little to correct; real
YOLACT masks are ragged. This A/B runs the same sequence with
block-raggedized masks (datasets/synthetic.py::degrade_masks, the census
robustness model) through two arms:

  ragged_semopt_on   — the full pipeline on degraded masks
  ragged_semopt_off  — the object pipeline on, the refinement disabled

both through scripts/run_experiments_torch.py's run_tum_variant (sync
mapping, objects on), after a 12-frame prewarm of each configuration whose
systems are thrown away. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_semopt_ragged_torch.py --seq DIR [--out F.json]
       [--frames N] [--seed 11] [--shift 2] [--holes 0] [--device cuda|cpu]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

PREWARM_FRAMES = 12


def degrade(cfg, frames, seed=11, shift=2, holes=0.0):
    """Every frame's detections with their masks degraded by
    degrade_masks from RandomState(seed), in the reference's draw order:
    (frames, number of instance masks degraded)."""
    import torch
    from object_slam_tpu_torch.datasets.synthetic import degrade_masks
    from object_slam_tpu_torch.semantic.object2d import (pack_mask_bits,
                                                         unpack_mask_bits)
    rng = np.random.RandomState(seed)
    ragged = []
    n_deg = 0
    for rgb8, d16, sem in frames:
        if sem is None:
            ragged.append((rgb8, d16, None))
            continue
        packed, labels, probs, bboxes, valid = sem
        M = unpack_mask_bits(torch.from_numpy(np.asarray(packed)),
                             cfg.camera.width).numpy()
        Mn, Bn = degrade_masks(M, np.asarray(valid), rng,
                               shift=shift, hole_frac=holes)
        n_deg += int(np.asarray(valid).sum())
        ragged.append((rgb8, d16, (pack_mask_bits(Mn), labels, probs,
                                   np.asarray(Bn, np.float32), valid)))
    return ragged, n_deg


def semopt_off(cfg):
    return cfg.replace(objects=dataclasses.replace(cfg.objects,
                                                   semopt_enabled=False))


def run_arms(seq, cfg, ragged, metas, device=None,
             prewarm=PREWARM_FRAMES, systems=None):
    """The prewarm of both configurations on the first `prewarm` frames
    (untimed, thrown away), then the two arms over every frame: {arm:
    run_tum_variant's result}. systems: a list each arm's system is
    appended to."""
    from run_experiments_torch import run_tum_variant

    cfg_semoff = semopt_off(cfg)
    if prewarm:
        for vcfg in (cfg, cfg_semoff):
            run_tum_variant(seq, vcfg, ragged[:prewarm], metas[:prewarm],
                            device=device, enable_objects=True)
    out = {}
    for name, vcfg in [("ragged_semopt_on", cfg),
                       ("ragged_semopt_off", cfg_semoff)]:
        out[name] = run_tum_variant(seq, vcfg, ragged, metas, device=device,
                                    systems=systems, enable_objects=True,
                                    async_mapping=False)
        print(name, json.dumps(out[name])[:240], flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_tum200b")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--shift", type=int, default=2)
    ap.add_argument("--holes", type=float, default=0.0,
                    help="salt-hole fraction; default 0 — interior salt "
                         "annihilates the 20x20 erosion membership gate "
                         "(0 objects), which is not how YOLACT masks fail")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from object_slam_tpu_torch.config import SlamConfig
    from run_experiments_torch import load_tum_frames

    cfg = SlamConfig.tum_rgbd()
    metas, frames = load_tum_frames(args.seq, cfg, args.frames)
    ragged, n_deg = degrade(cfg, frames, args.seed, args.shift, args.holes)
    print(f"degraded {n_deg} instance masks over {len(frames)} frames",
          flush=True)
    out = run_arms(args.seq, cfg, ragged, metas, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
