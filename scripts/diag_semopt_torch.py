#!/usr/bin/env python
"""Does the semantically constrained pose optimization help? The PyTorch
port's counterpart of scripts/diag_semopt.py.

Runs the staged host path (tracking.fused=False, strict readback) with
objects on, so the pose BEFORE the semantic refinement (the plain
local-map optimum, SlamSystem._last_presem_Tcw) and AFTER it are both
visible, and compares each against the ground truth frame by frame; then
prints the reference's summary keys. Runs on the CUDA card unless given
--device cpu.

Usage:
  python scripts/diag_semopt_torch.py --seq DIR [--frames 200]
      [--device cuda|cpu]
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


def staged_cfg(cfg):
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, fused=False, pipelined_readback=False))


def summarize(deltas):
    """The reference's summary of (frame, error before, error after)."""
    d = np.asarray([(a, b) for _, a, b in deltas])
    if len(d) == 0:
        return {"n_semopt_frames": 0}
    diff_mm = (d[:, 1] - d[:, 0]) * 1000
    return {
        "n_semopt_frames": len(d),
        "mean_pre_mm": float(d[:, 0].mean() * 1000),
        "mean_post_mm": float(d[:, 1].mean() * 1000),
        "median_shift_mm": float(np.median(diff_mm)),
        "mean_shift_mm": float(diff_mm.mean()),
        "p90_shift_mm": float(np.percentile(diff_mm, 90)),
        "frames_worse": int((diff_mm > 0.1).sum()),
        "frames_better": int((diff_mm < -0.1).sum()),
        "worst_shift_mm": float(diff_mm.max()),
    }


def run_probe(cfg, metas, frames, gt_by_ts, device=None, log_every=25,
              systems=None):
    """The staged objects-on run over the decoded frames: (deltas [(frame,
    error before, error after) m], poses [(frame, Tcw before, Tcw after)],
    summary). gt_by_ts: the ground-truth centre by timestamp (4 places).
    systems: a list the system is appended to."""
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(staged_cfg(cfg), enable_objects=True,
                      async_mapping=False, device=device)
    deltas, poses = [], []
    for i, (rgb8, d16, sem) in enumerate(frames):
        f = sys_.track_rgbd(None, d16, rgb8, sem,
                            timestamp=metas[i].timestamp)
        gt_p = gt_by_ts.get(round(metas[i].timestamp, 4))
        pre = sys_._last_presem_Tcw
        if gt_p is None or pre is None:
            continue
        pre_np, post_np = pre.cpu().numpy(), f.Tcw.cpu().numpy()
        c_pre = np.linalg.inv(pre_np)[:3, 3]
        c_post = np.linalg.inv(post_np)[:3, 3]
        e_pre = float(np.linalg.norm(c_pre - gt_p))
        e_post = float(np.linalg.norm(c_post - gt_p))
        deltas.append((i, e_pre, e_post))
        poses.append((i, pre_np, post_np))
        if log_every and i % log_every == 0:
            print(f"f={i:3d} pre={e_pre*1000:7.2f}mm "
                  f"post={e_post*1000:7.2f}mm "
                  f"shift={(e_post-e_pre)*1000:+7.2f}mm", flush=True)
    if systems is not None:
        systems.append(sys_)
    return deltas, poses, summarize(deltas)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_tum200")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    from run_experiments_torch import load_tum_frames

    cfg = SlamConfig.tum_rgbd()
    metas, frames = load_tum_frames(args.seq, cfg, args.frames)
    ts_gt, pos_gt, quat_gt = tum.load_groundtruth(args.seq)
    gt_by_ts = {round(t, 4): p for t, p in zip(ts_gt, pos_gt)}
    _, _, out = run_probe(cfg, metas, frames, gt_by_ts, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
