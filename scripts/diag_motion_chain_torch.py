#!/usr/bin/env python
"""Motion-model search loss-chain attribution on the KITTI drive with the
PyTorch port (the counterpart of scripts/diag_motion_chain.py).

diag_kitti_retention_torch.py bounds what detection allows (ground-truth
transport); diag_local_recovery_torch.py attributes the local-map search.
This probe runs the real system and, per frame, replays the MOTION search
(slam/tracking.py::track_motion_model, ORBmatcher::SearchByProjection
frame to frame, ORBmatcher.cc:1328-1470) stage by stage on the actual
inputs (the last frame's bindings, the velocity-predicted pose),
restricted to CLOSE rows:

  bound      - last-frame close keypoints bound to a map point
  window     - a current keypoint inside the predicted search window
               (radius_th * sf[last_level])
  ur_ok      - ...passing the stereo right-u gate
  level      - ...passing the forward-motion one-sided level window
  desc       - ...with descriptor <= TH_HIGH (a matchable candidate)
  matched    - survived the nn ratio, rotation histogram and duplicates
  inlier     - survived the pose optimization's chi2 regate

and the same with the rotation check off (last_angle=None), with the
rotation-killed recoveries that were correct against the ground truth.
The stage masks ([N, N] window, right-u, level and Hamming tests) run on
the device in the reference's float32; the search runs twice on the same
inputs. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_motion_chain_torch.py --seq DIR [--frames 30]
       [--start 0] [--out F.json] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from diag_kitti_retention_torch import TH_HIGH, _np, load_pair  # noqa: E402

TOTAL_KEYS = ["bound", "window", "ur_ok", "level", "desc", "matched",
              "matched_norot", "inlier", "inlier_norot", "killed_total",
              "killed_correct"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_kitti")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def stage_masks(K, cfg, sf, last, cur, pw, T_pred, dev):
    """The host chain's stages as the reference computes them (float32
    projections), the [N, N] tests on the device: (in_img [N] bool numpy,
    [window, ur_ok, level, desc] per-row hits as numpy bools)."""
    import torch
    from object_slam_tpu_torch.features.matching import hamming_matrix
    fx, fy, cx, cy, bf = (np.float32(v) for v in (K.fx, K.fy, K.cx, K.cy,
                                                  K.bf))
    pc = pw @ T_pred[:3, :3].T + T_pred[:3, 3]
    z = pc[:, 2]
    zc = np.maximum(z, 1e-6).astype(np.float32)
    u = fx * pc[:, 0].astype(np.float32) / zc + cx
    v = fy * pc[:, 1].astype(np.float32) / zc + cy
    ur_pred = u - bf / zc
    in_img = (z > 0) & (u >= 0) & (u < cfg.camera.width) & \
        (v >= 0) & (v < cfg.camera.height)
    l_lvl = _np(last.level)
    radius = cfg.tracking.motion_model_radius * sf[
        np.clip(l_lvl, 0, len(sf) - 1)]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rad = t(radius)[:, None]
    du = (t(u)[:, None] - cur.uv[None, :, 0]).abs()
    dv = (t(v)[:, None] - cur.uv[None, :, 1]).abs()
    win = (du < rad) & (dv < rad) & cur.valid[None, :]
    ur_ok = (cur.ur[None, :] < 0) | (
        (t(ur_pred)[:, None] - cur.ur[None, :]).abs() < rad)
    # forward one-sided level window (_motion_level_bounds' forward case)
    lvl_win = cur.level.to(torch.int64)[None, :] >= (
        last.level.to(torch.int64)[:, None] - 1)
    desc_hit = hamming_matrix(last.desc, cur.desc) <= TH_HIGH
    w = win
    hits = [w.any(1)]
    for mask in (ur_ok, lvl_win, desc_hit):
        w = w & mask
        hits.append(w.any(1))
    return in_img, [h.cpu().numpy() for h in hits]


def run(cfg, args, device=None, log=print, on_system=None):
    """The chain over args' frames: {"totals": {...}, "per_frame": [...]}
    (--out writes the totals, as the reference does). on_system(sys_) may
    wrap the system before the first frame."""
    import torch
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, device=device)
    if on_system is not None:
        on_system(sys_)
    dev = sys_.device
    frames = kitti.load_sequence(args.seq)
    gt = kitti.load_groundtruth(os.path.join(args.seq, "gt.txt"))
    close_z = cfg.camera.th_depth * cfg.camera.baseline
    sf = _np(sys_.scale_factors)
    K = sys_.K
    fx, fy, cx, cy = (np.float32(v) for v in (K.fx, K.fy, K.cx, K.cy))

    def motion(m, cur, last, T_pred, T_last, last_angle):
        return trk.track_motion_model(
            K, m, cur, last.uv, last.kp_pt, last.level, last.valid, T_pred,
            sys_.scale_factors, sys_.inv_sigma2,
            radius_th=cfg.tracking.motion_model_radius, T_last=T_last,
            last_angle=last_angle)

    tot = {k: 0 for k in TOTAL_KEYS}
    per = []
    for i in range(args.start, args.start + args.frames):
        fr = frames[i]
        gl, gr, sa = load_pair(args.seq, fr, cfg)
        last_snapshot = sys_.last_frame
        last_Tcw = (_np(last_snapshot.Tcw)
                    if last_snapshot is not None else None)
        vel = _np(sys_.velocity) if sys_.velocity is not None \
            else np.eye(4)
        sys_.track_stereo(gl, gr, None, sa, fr.timestamp)

        if last_snapshot is None or i < args.start + 2:
            continue

        m = sys_.map
        last = last_snapshot
        cur = sys_.last_frame
        T_pred = vel @ last_Tcw

        # the host stage chain, its [N, N] tests on the device
        P = m.pt_xyz.shape[0]
        l_pt = _np(last.kp_pt)
        l_d = _np(last.depth)
        pt_valid = _np(m.pt_valid)
        close = _np(last.valid) & (l_d > 0) & (l_d < close_z)
        bound = close & (l_pt >= 0) & pt_valid[np.clip(l_pt, 0, P - 1)]
        pw_all = _np(m.pt_xyz)
        pw = pw_all[np.clip(l_pt, 0, P - 1)]
        in_img, (stage_w, stage_u, stage_l, stage_d) = stage_masks(
            K, cfg, sf, last, cur, pw, T_pred, dev)
        rows = bound & in_img

        # the real motion search + pose optimization on the same inputs
        Tp = torch.from_numpy(np.ascontiguousarray(T_pred)).to(dev)
        Tl = torch.from_numpy(np.ascontiguousarray(last_Tcw)).to(dev)
        res = motion(m, cur, last, Tp, Tl, last.angle)
        res_norot = motion(m, cur, last, Tp, Tl, None)
        mt = _np(res.kp_pt_all)
        inl = _np(res.kp_pt)
        mt_nr = _np(res_norot.kp_pt_all)
        inl_nr = _np(res_norot.kp_pt)
        sets = []
        for idx in (mt, mt_nr, inl, inl_nr):
            s = np.zeros((P,), bool)
            s[np.clip(idx, 0, P - 1)] |= (idx >= 0)
            sets.append(s)
        matched_set, matched_nr_set, inlier_set, inlier_nr_set = sets
        lptc = np.clip(l_pt, 0, P - 1)

        # ground-truth correctness of the rotation-killed recoveries: the
        # no-rotation match binds keypoint j to map point p, correct if
        # p's projection with the true pose lands within 3 px of j
        killed_correct = killed_total = 0
        gtTcw = np.linalg.inv(gt[i])
        kp_of_pt = np.full((P,), -1, np.int64)
        kp_of_pt[np.clip(mt_nr, 0, P - 1)] = np.where(
            mt_nr >= 0, np.arange(len(mt_nr)), -1)
        c_uv = _np(cur.uv)
        for pslot in np.where(matched_nr_set & ~matched_set)[0]:
            r_last = np.where((lptc == pslot) & rows)[0]
            if len(r_last) == 0:
                continue
            j = kp_of_pt[pslot]
            if j < 0:
                continue
            pcg = pw_all[pslot] @ gtTcw[:3, :3].T + gtTcw[:3, 3]
            if pcg[2] <= 0:
                continue
            zg = np.float32(pcg[2])
            ug = fx * np.float32(pcg[0]) / zg + cx
            vg = fy * np.float32(pcg[1]) / zg + cy
            killed_total += 1
            if (ug - c_uv[j, 0]) ** 2 + (vg - c_uv[j, 1]) ** 2 < 9.0:
                killed_correct += 1

        row_stats = dict(
            f=i, bound=int(rows.sum()),
            window=int((stage_w & rows).sum()),
            ur_ok=int((stage_u & rows).sum()),
            level=int((stage_l & rows).sum()),
            desc=int((stage_d & rows).sum()),
            matched=int((matched_set[lptc] & rows).sum()),
            matched_norot=int((matched_nr_set[lptc] & rows).sum()),
            inlier=int((inlier_set[lptc] & rows).sum()),
            inlier_norot=int((inlier_nr_set[lptc] & rows).sum()),
            killed_total=killed_total,
            killed_correct=killed_correct)
        for k in tot:
            tot[k] += row_stats[k]
        per.append(row_stats)
        log(f"f={i} " + " ".join(f"{k}={val}" for k, val in
                                 row_stats.items() if k != "f"))

    log("\ntotals:")
    base = max(tot["bound"], 1)
    for k, val in tot.items():
        log(f"  {k:8s}: {val:7d}  ({100.0 * val / base:5.1f}% of bound)")
    sys_.shutdown()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tot, f, indent=1)
    return {"totals": tot, "per_frame": per}


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
