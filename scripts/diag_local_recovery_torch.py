#!/usr/bin/env python
"""Close map-point recovery attribution inside the real tracker, with the
PyTorch port (the counterpart of scripts/diag_local_recovery.py).

Runs SlamSystem(SlamConfig.kitti_stereo()) on the KITTI drive and, after
every frame, classifies every CLOSE map point (z < th_depth * baseline in
the current camera) by the first gate of the local-map search
(slam/tracking.py::track_local_map, Tracking.cc:1408-1456
SearchLocalPoints) that blocks it:

  matched      - a keypoint is bound to it (counts toward close_trk)
  no_local     - not in the local point set (the covisibility vote and cap)
  frustum      - distance outside [0.8 min, 1.2 max] or view cos <= 0.5
  no_kp_radius - no free keypoint within the (2.5|4.0) * sf[pred] window
  level        - keypoint in the window but outside the pred +-1 levels
  desc         - keypoint in window and levels but descriptor > TH_HIGH
  lost         - a matchable candidate existed and still no binding

The gates are evaluated on the host over the map's point fields, as the
reference evaluates them. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_local_recovery_torch.py --seq DIR
       [--frames 40] [--start 0] [--out F.json] [--device cuda|cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from diag_kitti_retention_torch import _np, load_pair  # noqa: E402

TOTAL_KEYS = ["close_vis", "matched", "no_local", "frustum", "no_kp_radius",
              "level", "desc", "lost", "level_would_pass_w2",
              "radius_would_pass_2x"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_kitti")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def local_set(cfg, m, matched_set, P, pt_valid):
    """The local point set as select_local_points votes and caps it: the
    16 keyframes that see most matched points, their points, and the
    recent-first cap."""
    kf_kp_pt = _np(m.kf_kp_pt)
    kf_kp_valid = _np(m.kf_kp_valid)
    kf_valid = _np(m.kf_valid)
    obs_ok = (kf_kp_pt >= 0) & kf_kp_valid & kf_valid[:, None]
    votes = (matched_set[np.clip(kf_kp_pt, 0, P - 1)] & obs_ok).sum(1)
    order = np.argsort(-votes)[:16]
    order = order[votes[order] > 0]
    local_mask = np.zeros((P,), bool)
    for kf in order:
        sel = kf_kp_pt[kf]
        okk = (sel >= 0) & kf_kp_valid[kf]
        local_mask[np.clip(sel, 0, P - 1)] |= okk
    local_mask &= pt_valid
    # compaction cap: recent-first then observation count
    cap = cfg.caps.local_search_pts
    if local_mask.sum() > cap:
        recent = _np(m.pt_first_kf) >= int(m.n_kf) - 3
        score = np.where(recent, 1e6, 0) + _np(m.pt_n_obs)
        score = np.where(local_mask, score, -1)
        keep = np.argsort(-score)[:cap]
        lm2 = np.zeros((P,), bool)
        lm2[keep] = score[keep] >= 0
        local_mask = lm2
    return local_mask


def run(cfg, args, device=None, log=print, on_system=None):
    """The attribution over args' frames: {"totals": {...}, "per_frame":
    [...]} (the --out file's keys). on_system(sys_) may wrap the system
    before the first frame."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, device=device)
    if on_system is not None:
        on_system(sys_)
    frames = kitti.load_sequence(args.seq)
    close_z = cfg.camera.th_depth * cfg.camera.baseline
    cam = cfg.camera
    sf = _np(sys_.scale_factors)
    log_scale = float(sys_.log_scale)
    n_levels = len(sf)
    tot = {k: 0 for k in TOTAL_KEYS}
    per_frame = []
    for i in range(args.start, args.start + args.frames):
        fr = frames[i]
        gl, gr, sa = load_pair(args.seq, fr, cfg)
        sys_.track_stereo(gl, gr, None, sa, fr.timestamp)
        if sys_.last_frame is None or i < args.start + 2:
            continue

        m = sys_.map
        frame = sys_.last_frame
        Tcw = _np(frame.Tcw)
        pt_valid = _np(m.pt_valid)
        pw = _np(m.pt_xyz)
        normal = _np(m.pt_normal)
        mind = _np(m.pt_min_dist)
        maxd = _np(m.pt_max_dist)
        desc = _np(m.pt_desc)
        P = pw.shape[0]

        pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        close = pt_valid & (z > 0.1) & (z < close_z)
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        close_vis = close & in_img
        n_close_vis = int(close_vis.sum())
        if n_close_vis == 0:
            continue

        kp_pt = _np(frame.kp_pt)
        matched_set = np.zeros((P,), bool)
        matched_set[np.clip(kp_pt, 0, P - 1)] |= (kp_pt >= 0)
        matched = close_vis & matched_set
        local_mask = local_set(cfg, m, matched_set, P, pt_valid)

        # frustum (distance + view cos)
        cc = -Tcw[:3, :3].T @ Tcw[:3, 3]
        po = pw - cc
        dist = np.linalg.norm(po, axis=1)
        vcos = (po * normal).sum(1) / np.maximum(dist, 1e-6)
        frustum_ok = ((dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
                      & (vcos > 0.5))

        # keypoint window
        kp_uv = _np(frame.uv)
        kp_lvl = _np(frame.level)
        kp_desc = _np(frame.desc)
        kp_free = _np(frame.valid) & (kp_pt < 0)
        lvl = np.clip(np.ceil(np.log(np.maximum(
            maxd / np.maximum(dist, 1e-6), 1e-6)) / log_scale
        ).astype(np.int32), 0, n_levels - 1)
        r0 = np.where(vcos > 0.998, 2.5, 4.0)
        radius = r0 * sf[lvl] * (7.0 / 7.0)

        rows = np.where(close_vis & ~matched)[0]
        cnt = dict(no_local=0, frustum=0, no_kp_radius=0, level=0,
                   desc=0, lost=0, level_would_pass_w2=0,
                   radius_would_pass_2x=0)
        pb = np.unpackbits(np.ascontiguousarray(desc[rows]).view(np.uint8),
                           axis=-1) if len(rows) else None
        cb = np.unpackbits(np.ascontiguousarray(kp_desc).view(np.uint8),
                           axis=-1)
        for k, p in enumerate(rows):
            if not local_mask[p]:
                cnt["no_local"] += 1
                continue
            if not frustum_ok[p]:
                cnt["frustum"] += 1
                continue
            du = np.abs(u[p] - kp_uv[:, 0])
            dv = np.abs(v[p] - kp_uv[:, 1])
            win = (du < radius[p]) & (dv < radius[p]) & kp_free
            if not win.any():
                if ((du < 2 * radius[p]) & (dv < 2 * radius[p])
                        & kp_free).any():
                    cnt["radius_would_pass_2x"] += 1
                cnt["no_kp_radius"] += 1
                continue
            lvl_ok = np.abs(kp_lvl - lvl[p]) <= 1
            if not (win & lvl_ok).any():
                if (win & (np.abs(kp_lvl - lvl[p]) <= 2)).any():
                    cnt["level_would_pass_w2"] += 1
                cnt["level"] += 1
                continue
            ham = (pb[k][None, :] != cb[win & lvl_ok]).sum(-1)
            if ham.min() > 100:
                cnt["desc"] += 1
                continue
            cnt["lost"] += 1

        tot["close_vis"] += n_close_vis
        tot["matched"] += int(matched.sum())
        for k in cnt:
            tot[k] += cnt[k]
        per_frame.append(dict(f=i, close_vis=n_close_vis,
                              matched=int(matched.sum()), **cnt))
        log(f"f={i} vis={n_close_vis} matched={int(matched.sum())} "
            + " ".join(f"{k}={v}" for k, v in cnt.items()))

    log(f"\ntotals over {len(per_frame)} frames:")
    for k, v in tot.items():
        pct = 100.0 * v / max(tot["close_vis"], 1)
        log(f"  {k:12s}: {v:7d}  ({pct:5.1f}%)")
    sys_.shutdown()
    out = {"totals": tot, "per_frame": per_frame}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
