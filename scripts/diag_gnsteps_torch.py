#!/usr/bin/env python
"""Step-by-step LM trace on a dumped frame with the PyTorch port (the
counterpart of scripts/diag_gnsteps.py): the error after each iteration.

Takes a dump of scripts/diag_retention_torch.py (or of the reference's
diag_retention.py), the frame's local-map matches, and runs pose_opt's LM
step from the predicted pose in 4 rounds of 10 iterations, re-gating the
edges by chi2 (5.991 mono, 7.815 stereo) between rounds; prints the first
three and the last iteration of each round (error, step, active edges)
and the active count after each regate. Runs on the CUDA card unless
given --device cpu.

Usage: python scripts/diag_gnsteps_torch.py DUMP.npz [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from diag_replay_torch import (CHI2_MONO, CHI2_STEREO,  # noqa: E402
                               level_weights, load_dump, pose_obs)


def run(dump, cfg=None, device=None, log=print):
    """{"start_err_mm", "steps": [{"round", "it", "err_mm", "step_mm",
    "active"}] (all 40), "regates": [4 active counts]}."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.solvers import pose_opt as po

    dev = resolve_device(device)
    cfg = cfg or SlamConfig.tum_rgbd()
    K = Intrinsics.from_config(cfg.camera)
    d = load_dump(dump)
    T_gt = d["T_gt"]
    obs, _, _ = pose_obs(d, d["kp_pt_local"], level_weights(cfg), dev)
    T = torch.from_numpy(np.asarray(d["T_pred"], np.float32)).to(dev)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    active = obs.valid
    start = float(np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3])
                  * 1000)
    log(f"start err={start:.1f}mm")
    steps, regates = [], []
    for rnd in range(4):
        for it in range(10):
            T2, lam, _ = po._lm_step(K, T, lam, obs, active, CHI2_MONO,
                                     CHI2_STEREO)
            step = np.linalg.norm(T2.cpu().numpy()[:3, 3]
                                  - T.cpu().numpy()[:3, 3])
            T = T2
            err = np.linalg.norm(T.cpu().numpy()[:3, 3] - T_gt[:3, 3]) * 1000
            s = {"round": rnd, "it": it, "err_mm": float(err),
                 "step_mm": float(step * 1000),
                 "active": int(torch.sum(active))}
            steps.append(s)
            if it < 3 or it == 9:
                log(f"r{rnd} it{it}: err={err:8.2f}mm "
                    f"|dt|={step * 1000:7.2f}mm active={s['active']:4d}")
        r, _, stereo, z = po.reproj_residual_jac(K, T, obs)
        chi2 = po.edge_chi2(r, obs.inv_sigma2, stereo)
        gate = torch.where(stereo, torch.full_like(chi2, CHI2_STEREO),
                           torch.full_like(chi2, CHI2_MONO))
        active = obs.valid & (chi2 <= gate) & (z > 0)
        regates.append(int(torch.sum(active)))
        log(f"after regate: active={regates[-1]}")
    return {"start_err_mm": start, "steps": steps, "regates": regates}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dump", help="a frame dump (OSLAM_DUMP's fNNN.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.dump, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
