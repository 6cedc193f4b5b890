#!/usr/bin/env python
"""Isolated convergence probe for pose_optimize with the PyTorch port (the
counterpart of scripts/diag_poseopt.py): correct correspondences from a
planar scene, the initialization perturbed by growing amounts.

500 points on a slab 3.5-4.5 m in front of the camera (RandomState(0)),
stereo observations with 0.3 px noise per pyramid level, and 18 initial
poses (6 translation offsets x 3 yaw offsets, drawn from the same
stream). Prints the valid count, then one line per initialization with
the final translation error and the inlier count. Runs on the CUDA card
unless given --device cpu.

Usage: python scripts/diag_poseopt_torch.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

OFFSETS_M = (0.005, 0.01, 0.03, 0.1, 0.3, 1.0)
YAWS_DEG = (0.0, 0.5, 2.0)


def scene(cfg, uv_noise_seed=None):
    """The probe's observations (numpy) and its RandomState, positioned
    where the initializations are drawn: (uv f32, ur f32, pw f32,
    inv_sigma2 f32, valid, rng). uv_noise_seed moves every pixel
    coordinate one float32 ulp up, down or not (RandomState(seed)), the
    reference's noise runs."""
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    K = Intrinsics.from_config(cfg.camera)
    rng = np.random.RandomState(0)
    N = 500
    # plane at z=4 in front of the camera, some boxes nearer
    pw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3.5, 4.5, N)], -1).astype(np.float32)
    pc = pw
    u = K.fx * pc[:, 0] / pc[:, 2] + K.cx
    v = K.fy * pc[:, 1] / pc[:, 2] + K.cy
    ur = u - K.bf / pc[:, 2]
    uv = np.stack([u, v], -1)
    # 0.3px measurement noise, levels 0..7 geometric
    levels = np.minimum((rng.geometric(0.45, N) - 1), 7)
    sf = 1.2 ** levels
    uv = (uv + rng.randn(N, 2) * 0.3 * sf[:, None]).astype(np.float32)
    if uv_noise_seed is not None:
        step = np.random.RandomState(uv_noise_seed).randint(-1, 2, uv.shape)
        uv = np.where(step > 0, np.nextafter(uv, np.float32(np.inf)),
                      np.where(step < 0, np.nextafter(uv, np.float32(-np.inf)),
                               uv))
    inv_sigma2 = (1.0 / (sf * sf)).astype(np.float32)
    inb = (u >= 0) & (u < K.width) & (v >= 0) & (v < K.height)
    return uv, ur.astype(np.float32), pw, inv_sigma2, inb, rng


def run(cfg=None, device=None, uv_noise_seed=None, log=print):
    """The 18 initializations through pose_optimize: {"n_valid", "rows":
    [{"dt_mm", "dr_deg", "err_mm", "n_inl"}]}."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.solvers import pose_opt as po

    dev = resolve_device(device)
    cfg = cfg or SlamConfig.tum_rgbd()
    K = Intrinsics.from_config(cfg.camera)
    uv, ur, pw, inv_sigma2, inb, rng = scene(cfg, uv_noise_seed)
    T_gt = np.eye(4, dtype=np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    obs = po.PoseObs(uv=t(uv), ur=t(ur), pw=t(pw), inv_sigma2=t(inv_sigma2),
                     valid=t(inb))
    log(f"N valid = {inb.sum()}")
    rows = []
    for dt in OFFSETS_M:
        for dr_deg in YAWS_DEG:
            T0 = np.eye(4, dtype=np.float32)
            d = rng.randn(3)
            T0[:3, 3] = dt * d / np.linalg.norm(d)
            th = np.deg2rad(dr_deg)
            c, s = np.cos(th), np.sin(th)
            T0[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                  np.float32)
            Tcw, _, n_inl = po.pose_optimize(K, t(T0), obs)
            err = np.linalg.norm(Tcw.cpu().numpy()[:3, 3]
                                 - T_gt[:3, 3]) * 1000
            rows.append({"dt_mm": dt * 1000, "dr_deg": dr_deg,
                         "err_mm": float(err), "n_inl": int(n_inl)})
            log(f"init dt={dt * 1000:6.1f}mm dr={dr_deg:3.1f}deg -> "
                f"err={err:8.2f}mm n_inl={int(n_inl):4d}")
    return {"n_valid": int(inb.sum()), "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
