#!/usr/bin/env python
"""Per-frame tracking retention diagnostic on the synthetic VGA scene with
the PyTorch port (the counterpart of scripts/diag_retention.py).

Renders an orbit (rotation + translation) sequence of the room scene
(seed 3, two boxes, back wall at 4 m) at TUM VGA and prints, per frame,
whether it was tracked, the pose error against the ground truth and the
camera-centre error in the ground-truth camera's axes (x right, y down,
z forward); from the second frame on, for the motion-model and the
local-map results of SlamSystem.debug_last, the matched count, the share
of matches more than 3 px from their map point's ground-truth projection,
and that result's error; then the matched map points' distance from the
ground-truth back-projection of their keypoints (map3d), and the count
of map points beyond 20 m. With OSLAM_DUMP=DIR, every frame whose error
passes 20 mm is written to DIR/fNNN.npz (the keys of the reference
script's dump, which scripts/diag_replay_torch.py and
diag_gnsteps_torch.py read, as the reference's replays do). Runs on the
CUDA card unless given --device cpu.

Usage: python scripts/diag_retention_torch.py [--frames 30] [--step 0.03]
       [--radius 0.4] [--objects] [--loc-only] [--no-ba]
       [--traj orbit|loop] [--traj-frames N] [--flat] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

DUMP_ERR_M = 0.02
WRONG_PX = 3.0
FAR_M = 20.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--step", type=float, default=0.03)
    ap.add_argument("--radius", type=float, default=0.4)
    ap.add_argument("--objects", action="store_true")
    ap.add_argument("--loc-only", action="store_true",
                    help="freeze the map after initialization")
    ap.add_argument("--no-ba", action="store_true",
                    help="skip local BA in mapping")
    ap.add_argument("--traj", choices=["orbit", "loop"], default="orbit")
    ap.add_argument("--traj-frames", type=int, default=0,
                    help="full trajectory length (pan rate); default = "
                         "--frames")
    ap.add_argument("--flat", action="store_true",
                    help="old degenerate single-plane scene (room=False)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def dump_arrays(frame, dbg, m, T_gt, T_pred):
    """The dump of one frame: the reference script's npz keys."""
    return dict(uv=_np(frame.uv), ur=_np(frame.ur), level=_np(frame.level),
                valid=_np(frame.valid), depth=_np(frame.depth),
                kp_pt_motion=_np(dbg["tr_motion"].kp_pt_all),
                kp_pt_local=_np(dbg["tr_local"].kp_pt_all),
                T_pred=_np(T_pred), Tcw_motion=_np(dbg["tr_motion"].Tcw),
                Tcw_local=_np(dbg["tr_local"].Tcw), pt_xyz=_np(m.pt_xyz),
                pt_valid=_np(m.pt_valid), T_gt=np.asarray(T_gt))


def write_dump(out_dir, i, frame, dbg, m, T_gt, T_pred):
    """DIR/fNNN.npz for frame i (dump_arrays). T_pred: debug_last's where
    the staged path set it, else the prediction the fused program made
    (velocity times the last pose, taken before the frame)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"f{i:03d}.npz")
    np.savez(path, **dump_arrays(frame, dbg, m, T_gt, T_pred))
    return path


def match_stats(cfg, tr, pt_xyz, frame_uv, T):
    """A tracking result's matches against the ground truth T: (count,
    % more than 3 px from their map point's projection, pose error mm)."""
    kp_pt = _np(tr.kp_pt)
    sel = kp_pt >= 0
    if sel.sum() == 0:
        return {"n": 0, "wrong": None, "err_mm": None}
    pw = pt_xyz[kp_pt[sel]]
    pc = (T[:3, :3] @ pw.T).T + T[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    u = cfg.camera.fx * pc[:, 0] / z + cfg.camera.cx
    v = cfg.camera.fy * pc[:, 1] / z + cfg.camera.cy
    kp_uv = frame_uv[sel]
    d = np.hypot(u - kp_uv[:, 0], v - kp_uv[:, 1])
    terr = np.linalg.norm(_np(tr.Tcw)[:3, 3] - T[:3, 3]) * 1000
    return {"n": int(sel.sum()), "wrong": float((d > WRONG_PX).mean() * 100),
            "err_mm": float(terr)}


def map_bias(cfg, dbg, frame, pt_xyz, pt_valid, T):
    """The local result's matched map points against the ground-truth
    back-projection of their keypoints through the rendered depth:
    ({"med_mm", "p90_mm"} or None, points beyond 20 m)."""
    kp_pt = _np(dbg["tr_local"].kp_pt)
    fd = _np(frame.depth)
    sel = (kp_pt >= 0) & (fd > 0)
    if sel.sum() == 0:
        return None, 0
    uvn = _np(frame.uv)[sel]
    z = fd[sel]
    pc_gt = np.stack([(uvn[:, 0] - cfg.camera.cx) / cfg.camera.fx * z,
                      (uvn[:, 1] - cfg.camera.cy) / cfg.camera.fy * z,
                      z], -1)
    Twc = np.linalg.inv(T)
    pw_gt = pc_gt @ Twc[:3, :3].T + Twc[:3, 3]
    e3d = np.linalg.norm(pt_xyz[kp_pt[sel]] - pw_gt, axis=1)
    far = pt_valid & (np.linalg.norm(pt_xyz, axis=1) > FAR_M)
    return ({"med_mm": float(np.median(e3d) * 1000),
             "p90_mm": float(np.percentile(e3d, 90) * 1000)},
            int(far.sum()))


def run(cfg, args, device=None, log=print, on_system=None, dump_dir=None):
    """The probe over args' trajectory: {"frames": [per-frame record],
    "summary": {...}, "dumps": [paths]}. on_system(sys_) may wrap the
    system before the first frame; dump_dir defaults to $OSLAM_DUMP."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses,
                                                          loop_trajectory)
    from object_slam_tpu_torch.slam import local_mapping as lm
    from object_slam_tpu_torch.slam.system import SlamSystem

    dump_dir = dump_dir if dump_dir is not None else os.environ.get(
        "OSLAM_DUMP")
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=4.0,
                                room=not args.flat)
    if args.traj == "loop":
        poses = loop_trajectory(args.traj_frames or args.frames)
        poses = poses[:args.frames]
    else:
        poses = orbit_poses(args.frames, radius=args.radius, step=args.step)
    sys_ = SlamSystem(cfg, enable_objects=args.objects, device=device)
    if on_system is not None:
        on_system(sys_)
    run_local_ba = lm.run_local_ba
    if args.no_ba:
        # the mapping pass looks run_local_ba up at call time
        lm.run_local_ba = lambda **kw: kw["m"]
    errs, recs, dumps = [], [], []
    try:
        for i, T in enumerate(poses):
            gray, depth, rgb, _ = scene.render_rgbd(T)
            if args.loc_only and sys_.state == 1:
                sys_.enable_mapping = False
            T_fused = (sys_.velocity @ sys_.last_frame.Tcw
                       if dump_dir and sys_.last_frame is not None else None)
            frame = sys_.track_rgbd(gray, depth, rgb, timestamp=i / 30.0)
            Tcw = _np(frame.Tcw)
            err = np.linalg.norm(Tcw[:3, 3] - T[:3, 3])
            dR = Tcw[:3, :3] @ T[:3, :3].T
            rot_deg = np.degrees(np.arccos(
                np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            C_est = -Tcw[:3, :3].T @ Tcw[:3, 3]
            C_gt = -T[:3, :3].T @ T[:3, 3]
            dC = T[:3, :3] @ (C_est - C_gt)
            errs.append(err)
            tr = sys_.trajectory[-1]
            rec = {"f": i, "tracked": int(tr.tracked), "err_mm": err * 1000,
                   "rot_deg": float(rot_deg), "dC_mm": (dC * 1000).tolist(),
                   "motion": None, "local": None, "map3d": None, "far": 0,
                   "dumped": False}
            extra = ""
            dbg = sys_.debug_last
            if dbg is not None and i > 0:
                # read before the printed line's n_keyframes folds in the
                # lagged readback
                pt_xyz, pt_valid = _np(sys_.map.pt_xyz), _np(sys_.map.pt_valid)
                frame_uv = _np(frame.uv)
                for tag in ("tr_motion", "tr_local"):
                    st = rec[tag[3:]] = match_stats(cfg, dbg[tag], pt_xyz,
                                                    frame_uv, T)
                    if st["n"] == 0:
                        extra += f" {tag}: 0 matches"
                        continue
                    extra += (f" | {tag[3:]}: n={st['n']:4d} "
                              f"wrong={st['wrong']:4.1f}% "
                              f"err={st['err_mm']:7.1f}mm")
                rec["map3d"], rec["far"] = map_bias(cfg, dbg, frame, pt_xyz,
                                                    pt_valid, T)
                if rec["map3d"] is not None:
                    extra += (f" | map3d med={rec['map3d']['med_mm']:6.1f}mm "
                              f"p90={rec['map3d']['p90_mm']:6.1f}mm")
                    if rec["far"]:
                        extra += f" | FAR_PTS={rec['far']}"
                if err > DUMP_ERR_M:
                    rec["dumped"] = True
                    if dump_dir:
                        dumps.append(write_dump(
                            dump_dir, i, frame, dbg, sys_.map, T,
                            dbg["T_pred"] if "T_pred" in dbg else T_fused))
                sys_.debug_last = None
            rec["state"] = int(sys_.state)
            rec["kfs"] = int(sys_.n_keyframes)
            rec["pts"] = int(sys_.n_points)
            recs.append(rec)
            log(f"f={i:3d} tracked={rec['tracked']} "
                f"state={rec['state']} err={err * 1000:7.1f}mm "
                f"rot={rot_deg:5.2f}deg dC=({dC[0] * 1000:6.1f},"
                f"{dC[1] * 1000:6.1f},{dC[2] * 1000:6.1f})mm "
                f"kfs={rec['kfs']} pts={rec['pts']}{extra}")
    finally:
        lm.run_local_ba = run_local_ba
    errs = np.asarray(errs)
    n_ok = sum(1 for r in sys_.trajectory if r.tracked)
    summary = {"tracked": n_ok, "frames": len(poses),
               "ate_raw_mm": float(np.sqrt(np.mean(errs ** 2)) * 1000),
               "max_mm": float(errs.max() * 1000)}
    log(f"\ntracked {n_ok}/{len(poses)} frames; "
        f"ATE(raw) {summary['ate_raw_mm']:.1f}mm; "
        f"max {summary['max_mm']:.1f}mm")
    return {"frames": recs, "summary": summary, "dumps": dumps}


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.tum_rgbd(), args, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
