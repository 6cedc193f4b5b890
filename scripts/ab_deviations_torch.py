#!/usr/bin/env python
"""A/B-measure the three mapping-policy deviations from ORB-SLAM2 on the
in-room loop circuit, with the PyTorch port (the counterpart of
scripts/ab_deviations.py; the same variants, configuration and output).

Three mapping-policy deviations are `cfg.mapping` flags:

  1. cull_recency_scope   — MapPointCulling only scrutinizes points during
                            their first ~3 KFs (LocalMapping.cc:171-206)
                            vs the test-forever variant.
  2. reelect_descriptors  — continuous min-median descriptor re-election
                            (MapPoint::ComputeDistinctiveDescriptors) vs
                            keeping the creation descriptor.
  3. kf_cull_scale_condition — KeyFrameCulling counts only same-or-finer-
                            scale observers (LocalMapping.cc:672-683) vs
                            scale-free counting.

Each variant runs the identical synthetic in-room loop circuit and prints
its tracked frames, Horn-aligned ATE, largest error, keyframes, points
and wall seconds. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/ab_deviations_torch.py [--frames 120] [--scale 2]
       [--variants base,recency_off,...] [--device cuda|cpu]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


VARIANTS = {
    # name -> dict of MappingConfig field overrides
    "base": {},
    "recency_off": {"cull_recency_scope": False},
    "no_reelect": {"reelect_descriptors": False},
    "scale_cond_on": {"kf_cull_scale_condition": True},
}


def build_cfg(scale: int):
    """TUM2-shaped camera downscaled by `scale` (1 = full VGA, 8 levels)."""
    from object_slam_tpu_torch.config import (SlamConfig, CameraConfig,
                                              OrbConfig, CapacityConfig)
    s = float(scale)
    cam = CameraConfig(
        width=int(640 // s), height=int(480 // s),
        fx=520.9 / s, fy=521.0 / s, cx=325.1 / s, cy=249.7 / s,
        dist=(0, 0, 0, 0, 0), bf=40.0 / s, th_depth=40.0,
        depth_map_factor=1.0)
    n_feat = max(300, int(1000 // s))
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=n_feat, n_levels=8 if scale == 1 else 4),
        caps=CapacityConfig(n_kp=int(np.ceil(n_feat / 128) * 128),
                            max_points=32768 // (scale if scale <= 2 else 2),
                            max_keyframes=256))


def circuit(cfg, seed: int, frames: int, turns: float):
    """The in-room circuit: the room of `seed` with three boxes of 0.9 and
    loop_trajectory over `frames` frames and `turns` turns."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    scene = SyntheticScene.make(cfg, seed=seed, n_objects=3, plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene, loop_trajectory(frames, sweep=2 * np.pi * turns)


def variant_cfg(cfg, name: str):
    from object_slam_tpu_torch.config import MappingConfig
    return cfg.replace(mapping=dataclasses.replace(MappingConfig(),
                                                   **VARIANTS[name]))


def run_variant(cfg, scene, poses, device=None, frames=None, systems=None):
    """One variant over the circuit: the reference's result keys. frames:
    the rendered (gray, depth, rgb) of each pose, else rendered here.
    systems: a list the system is appended to (callers read its
    trajectory)."""
    from object_slam_tpu_torch.eval.ate import align_horn_svd
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, enable_objects=False, enable_mapping=True,
                      device=device)
    est, gt, oks = [], [], []
    t0 = time.time()
    for i, T in enumerate(poses):
        if frames is not None:
            gray, depth, rgb = frames[i]
        else:
            gray, depth, rgb, _ = scene.render_rgbd(T)
        f = sys_.track_rgbd(gray, depth, rgb, None,
                            timestamp=float(i) / 30.0)
        est.append(np.linalg.inv(f.Tcw.cpu().numpy())[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
        oks.append(bool(f.pose_ok))
    wall = time.time() - t0
    est, gt = np.array(est), np.array(gt)
    ok = np.array(oks)
    if ok.sum() >= 3:
        _, _, err = align_horn_svd(est[ok].T, gt[ok].T)
        ate_mm = float(np.sqrt((err ** 2).mean()) * 1e3)
        max_mm = float(err.max() * 1e3)
    else:
        ate_mm = max_mm = float("nan")
    res = {
        "tracked": int(ok.sum()), "frames": len(poses),
        "ate_rmse_mm": ate_mm, "max_err_mm": max_mm,
        "n_keyframes": int(sys_.n_keyframes),
        "n_points": int(sys_.n_points),
        "wall_s": round(wall, 1),
    }
    if systems is not None:
        systems.append(sys_)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--scale", type=int, default=2,
                    help="camera downscale factor (1 = VGA)")
    ap.add_argument("--turns", type=float, default=1.15)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.scale)
    scene, poses = circuit(cfg, args.seed, args.frames, args.turns)

    results = {}
    for name in args.variants.split(","):
        over = VARIANTS[name]
        print(f"[{name}] {over or 'defaults'} ...", flush=True)
        results[name] = run_variant(variant_cfg(cfg, name), scene, poses,
                                    device=args.device)
        print(f"[{name}] {json.dumps(results[name])}", flush=True)

    print("\n=== A/B summary ===")
    print(f"{'variant':<16}{'tracked':>9}{'ATE mm':>9}{'max mm':>9}"
          f"{'KFs':>6}{'pts':>8}{'wall s':>8}")
    for name, r in results.items():
        print(f"{name:<16}{r['tracked']:>6}/{r['frames']:<3}"
              f"{r['ate_rmse_mm']:>8.1f}{r['max_err_mm']:>9.1f}"
              f"{r['n_keyframes']:>6}{r['n_points']:>8}{r['wall_s']:>8.1f}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
