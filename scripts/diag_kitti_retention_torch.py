#!/usr/bin/env python
"""Close-point retention attribution on the synthetic KITTI drive with the
PyTorch port (the counterpart of scripts/diag_kitti_retention.py).

For each consecutive frame pair (t, t+1) under GROUND-TRUTH motion:
take frame t's close keypoints (stereo depth < th_depth * baseline),
project them into t+1 with the ground-truth poses, and classify each as

  detected   - a t+1 keypoint exists within the level-scaled match
               radius of the projection
  lvl_ok     - ...whose pyramid level is within the motion-model
               search's level window of the frame-t level
  desc_ok    - ...whose descriptor is within TH_HIGH (100) of frame t's
  retained   - all three (what the motion-model search can recover)

Only FrameBuilder.build_stereo runs. The projections are computed on the
host as the reference computes them; the [N, N] window, level and
Hamming tests run on the device (features/matching.py::hamming_matrix,
where the reference builds an [N, N, 256] bit cube on the host), with the
same counts. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_kitti_retention_torch.py --seq DIR
       [--frames 40] [--start 0] [--radius-th 15] [--level-window 1]
       [--forward-onesided] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

TH_HIGH = 100


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_kitti")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--radius-th", type=float, default=15.0,
                    help="motion-model base radius (radius_th)")
    ap.add_argument("--level-window", type=int, default=1)
    ap.add_argument("--forward-onesided", action="store_true",
                    help="score the one-sided forward window "
                         "(kp_level >= last_level - 1) instead")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def load_pair(seq, fr, cfg):
    """(gray_l u8, gray_r u8, detections) of a KITTI frame, as the
    reference's probes load them (u8 images, the semantic folder)."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.png import read_png
    gl = read_png(fr.left_path).astype(np.uint8)
    gr = read_png(fr.right_path).astype(np.uint8)
    sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index, cfg)
    return gl, gr, sa


def run(cfg, args, device=None, log=print):
    """The attribution over args' frames: {"frames": [{"f", "close",
    "det", "lvl", "desc", "ret"}], "totals": {...}, "jumps": {level jump
    of the nearest hit: count}}."""
    import torch
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.features.matching import hamming_matrix
    from object_slam_tpu_torch.slam.frame import FrameBuilder

    fb = FrameBuilder(cfg, device=device)
    dev = fb.device
    frames = kitti.load_sequence(args.seq)
    gt = kitti.load_groundtruth(os.path.join(args.seq, "gt.txt"))
    K = fb.K
    sf = _np(fb.scale_factors)
    fx = [np.float32(v) for v in (K.fx, K.fy, K.cx, K.cy)]
    close_z = cfg.camera.th_depth * cfg.camera.baseline

    def build(i):
        fr = frames[i]
        gl, gr, sa = load_pair(args.seq, fr, cfg)
        return fb.build_stereo(gl, gr, None, sa, fr.timestamp)

    tot = dict(n=0, detected=0, lvl_ok=0, desc_ok=0, retained=0,
               det_in_img=0)
    lvl_jumps, per = [], []
    prev = build(args.start)
    for i in range(args.start + 1, args.start + args.frames):
        cur = build(i)
        p_uv = _np(prev.uv)
        p_lvl = _np(prev.level)
        p_d = _np(prev.depth)
        p_ok = _np(prev.valid) & (p_d > 0) & (p_d < close_z)

        # ground-truth transport t -> t+1 (gt.txt poses are cam-to-world);
        # the intrinsics are float32 scalars, so the projections round to
        # float32 at each step, as the reference's do
        Tw_prev = gt[i - 1]
        Tcw_cur = np.linalg.inv(gt[i])
        z = np.maximum(p_d, 1e-6)
        pc = np.stack([(p_uv[:, 0] - fx[2]) / fx[0] * z,
                       (p_uv[:, 1] - fx[3]) / fx[1] * z, z], -1)
        pw = pc @ Tw_prev[:3, :3].T + Tw_prev[:3, 3]
        pc2 = pw @ Tcw_cur[:3, :3].T + Tcw_cur[:3, 3]
        z2 = pc2[:, 2]
        zc = np.maximum(z2, 1e-6).astype(np.float32)
        u2 = fx[0] * pc2[:, 0].astype(np.float32) / zc + fx[2]
        v2 = fx[1] * pc2[:, 1].astype(np.float32) / zc + fx[3]
        in_img = ((z2 > 0.1) & (u2 >= 0) & (u2 < cfg.camera.width)
                  & (v2 >= 0) & (v2 < cfg.camera.height))
        rows = p_ok & in_img
        radius = args.radius_th * sf[np.clip(p_lvl, 0, len(sf) - 1)]

        # the [N, N] tests on the device, in the reference's float32
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        c_uv = cur.uv
        du = (t(u2)[:, None] - c_uv[None, :, 0]).abs()
        dv = (t(v2)[:, None] - c_uv[None, :, 1]).abs()
        rad = t(radius)[:, None]
        win = (du < rad) & (dv < rad) & cur.valid[None, :]
        p_l = prev.level.to(torch.int64)[:, None]
        c_l = cur.level.to(torch.int64)[None, :]
        if args.forward_onesided:
            lvl_win = c_l >= (p_l - 1)
        else:
            lvl_win = (c_l - p_l).abs() <= args.level_window
        desc_win = hamming_matrix(prev.desc, cur.desc) <= TH_HIGH
        rows_t = t(rows)
        detected = win.any(1)
        stage = {"detected": detected,
                 "lvl_ok": (win & lvl_win).any(1),
                 "desc_ok": (win & desc_win).any(1),
                 "retained": (win & lvl_win & desc_win).any(1)}
        n = {k: int((v & rows_t).sum()) for k, v in stage.items()}
        # level jump of the NEAREST window hit
        hit = rows_t & detected
        d2 = torch.where(win, du * du + dv * dv,
                         torch.full_like(du, float("inf")))
        nearest = torch.argmin(d2[hit], dim=1)
        lvl_jumps.extend((cur.level.to(torch.int64)[nearest]
                          - prev.level.to(torch.int64)[hit]).tolist())
        tot["n"] += int(rows.sum())
        tot["det_in_img"] += int(rows.sum())
        for k in stage:
            tot[k] += n[k]
        per.append({"f": i, "close": int(rows.sum()), "det": n["detected"],
                    "lvl": n["lvl_ok"], "desc": n["desc_ok"],
                    "ret": n["retained"]})
        log(f"f={i:3d} close={int(rows.sum()):4d} "
            f"det={n['detected']:4d} lvl={n['lvl_ok']:4d} "
            f"desc={n['desc_ok']:4d} ret={n['retained']:4d}")
        prev = cur

    n_all = max(tot["n"], 1)
    log(f"\nclose rows: {tot['n']}")
    for k in ("detected", "lvl_ok", "desc_ok", "retained"):
        log(f"  {k:9s}: {tot[k]:6d}  ({100.0 * tot[k] / n_all:5.1f}%)")
    jumps = {}
    if lvl_jumps:
        vals, cnts = np.unique(lvl_jumps, return_counts=True)
        jumps = {int(v): int(c) for v, c in zip(vals, cnts)}
        log(f"  level jump of nearest hit: {jumps}")
    return {"frames": per, "totals": tot, "jumps": jumps}


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
