#!/usr/bin/env python
"""Diagnose loop-closure quality on the in-room circuit with the PyTorch
port (the counterpart of scripts/diag_loop.py): track the sequence with
the loop module on, record the keyframe errors before and after each
closure, and dump the Sim3 each closure applied against the ground-truth
relative pose.

For each closure it prints the Sim3's error against the ground truth,
the drift the closure is meant to fix (the estimated relative pose of the
two keyframes against the ground truth), the gate's event, and every
valid keyframe's centre error before and after; then the online ATE and
the ATE of final_trajectory(). --no-loop runs the identical sequence with
the loop module off, the A/B control. Runs on the CUDA card unless given
--device cpu.

Usage: python scripts/diag_loop_torch.py [--frames 120] [--scale 2]
       [--no-loop] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


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


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _angle_deg(R):
    return float(np.degrees(np.arccos(
        np.clip((np.trace(R) - 1) / 2, -1, 1))))


def kf_pose_errors(m, kf_frame, poses, tag, log=print):
    """Per-keyframe translation error against the ground truth (mm), for
    the valid keyframes of kf_frame (keyframe -> frame)."""
    errs = {}
    kv = _np(m.kf_valid)
    kp = _np(m.kf_pose)
    for k, fi in kf_frame.items():
        if k < len(kv) and kv[k]:
            errs[k] = float(np.linalg.norm(
                np.linalg.inv(kp[k])[:3, 3]
                - np.linalg.inv(poses[fi])[:3, 3]) * 1e3)
    mean = np.mean(list(errs.values())) if errs else float("nan")
    log(f"KF-ERR[{tag}] mean {mean:.1f} mm : "
        + str({k: round(v, 1) for k, v in sorted(errs.items())}))
    return errs


class ClosureProbe:
    """Wraps a LoopCloser's _correct_loop: each call appends an event with
    the Sim3's and the drift's errors against the ground truth (poses:
    each frame's ground-truth Tcw) and the outcome, and keeps the
    keyframe errors before and after (kf_errors). kf_frame maps keyframes
    to the frames they were made on (the tracking loop fills it);
    current_frame[0] is the frame being tracked."""

    def __init__(self, lc, poses, kf_frame=None, log=print):
        self.lc, self.poses, self.log = lc, poses, log
        self.kf_frame = {} if kf_frame is None else kf_frame
        self.current_frame = [0]
        self.events, self.kf_errors = [], []
        self._orig = lc._correct_loop
        lc._correct_loop = self._correct

    def _correct(self, m, q, l, T12, s12):
        kf_frame, poses = self.kf_frame, self.poses
        q_fi = kf_frame.get(int(q), self.current_frame[0])
        kf_frame[int(q)] = q_fi
        Tq = _np(m.kf_pose[q])
        Tl = _np(m.kf_pose[l])
        gt_q, gt_l = poses[q_fi], poses[kf_frame[int(l)]]
        ev = {"q": int(q), "l": int(l), "s12": float(s12)}
        T12_gt = gt_q @ np.linalg.inv(gt_l)
        dT = _np(T12) @ np.linalg.inv(T12_gt)
        ev["sim3_trans_err_mm"] = float(np.linalg.norm(dT[:3, 3]) * 1e3)
        ev["sim3_rot_err_deg"] = _angle_deg(dT[:3, :3])
        # the drift the closure is supposed to fix: the current estimated
        # relative pose against the ground truth
        T12_est = Tq @ np.linalg.inv(Tl)
        dD = T12_est @ np.linalg.inv(T12_gt)
        ev["drift_trans_mm"] = float(np.linalg.norm(dD[:3, 3]) * 1e3)
        ev["drift_rot_deg"] = _angle_deg(dD[:3, :3])
        self.events.append(ev)
        self.log("CLOSURE " + json.dumps(ev))
        before = kf_pose_errors(m, kf_frame, poses, "before", self.log)
        m2, accepted = self._orig(m, q, l, T12, s12)
        ev["accepted"] = bool(accepted)
        if self.lc.events:
            self.log("GATE " + json.dumps(self.lc.events[-1]))
        after = kf_pose_errors(m2, kf_frame, poses,
                               "after" if accepted else "after(REJECTED)",
                               self.log)
        self.kf_errors.append((before, after))
        return m2, accepted


def run(cfg, scene, poses, loop=True, device=None, log=print):
    """The circuit through track_rgbd (objects off) with the probe on the
    closer: (the online summary, the final-trajectory ATE, the probe)."""
    from object_slam_tpu_torch.eval.ate import align_horn_svd
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=loop,
                      device=device)
    lc = sys_.loop_closer
    probe = ClosureProbe(lc, poses, log=log) if lc is not None else None
    kf_frame = probe.kf_frame if probe is not None else {}
    est, gt, oks = [], [], []
    for i, T in enumerate(poses):
        if probe is not None:
            probe.current_frame[0] = i
        gray, depth, rgb, _ = scene.render_rgbd(T)
        f = sys_.track_rgbd(gray, depth, rgb, None,
                            timestamp=float(i) / 30.0)
        if sys_.last_kf_id >= 0 and sys_.last_kf_id not in kf_frame:
            kf_frame[sys_.last_kf_id] = i
        est.append(np.linalg.inv(f.Tcw.cpu().numpy())[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
        oks.append(bool(f.pose_ok))

    est, gt, ok = np.array(est), np.array(gt), np.array(oks)
    _, _, err = align_horn_svd(est[ok].T, gt[ok].T)
    online = {
        "tracked": int(ok.sum()), "frames": len(poses),
        "online_ate_mm": float(np.sqrt((err ** 2).mean()) * 1e3),
        "loops_closed": lc.n_loops_closed if lc is not None else 0,
        "loops_rejected": lc.n_loops_rejected if lc is not None else 0,
    }
    log(json.dumps(online))

    # the final (retro-corrected) trajectory, as run_tum_torch.py saves it
    traj = sys_.final_trajectory()
    fin = np.array([np.linalg.inv(T)[:3, 3] for _, T, okk in traj if okk])
    gtf = gt[[i for i, (_, _, okk) in enumerate(traj) if okk]]
    _, _, err2 = align_horn_svd(fin.T, gtf.T)
    final = {"final_traj_ate_mm": float(np.sqrt((err2 ** 2).mean()) * 1e3)}
    log(json.dumps(final))
    return online, final, probe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--turns", type=float, default=1.15)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--no-loop", action="store_true",
                    help="identical run with the loop module off — the "
                         "A/B control for the closure's ATE effect")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    cfg = build_cfg(args.scale)
    scene = SyntheticScene.make(cfg, seed=args.seed, n_objects=3,
                                plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = loop_trajectory(args.frames, sweep=2 * np.pi * args.turns)
    log = lambda s: print(s, flush=True)  # noqa: E731
    return run(cfg, scene, poses, loop=not args.no_loop, device=args.device,
               log=log)


if __name__ == "__main__":
    main()
