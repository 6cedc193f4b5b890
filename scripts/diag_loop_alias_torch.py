#!/usr/bin/env python
"""Perceptually-aliased corridor — the loop gate's NEGATIVE test circuit,
run with the PyTorch port (the counterpart of scripts/diag_loop_alias.py).

A straight corridor whose wall / floor textures and furniture repeat with
period P (the synthetic scene's texture sampling is periodic by
construction). Frames one period apart are near pixel-identical, so BoW
detection + Sim3 RANSAC produce a confident false closure claiming "you
are where you were a period ago": a correction of ~P that the drift
budget must veto.

Expected event mix (loop/loop_closing.py::LoopCloser._correct_loop):
  - early candidates (few keyframes in the graph): the scaled budget is
    large relative to the predicted bend -> the full speculative
    correction runs and the post-gates (bend budget / reprojection
    quality) must reject;
  - late candidates (n_edges >> 12x chain length): the cheap pre-gate
    fires and skips propagate + fuse + pose graph + GBA entirely.
Each event's wall_ms checks the pre-gate's cost claim (a rejected
candidate costs < 10% of a full attempt).

Also runs the POSITIVE 120-frame circuit (diag_loop_torch.py's scene),
first and twice, so the record carries an accepted closure's warm wall
cost for the ratios. Output: one JSON (--out). Runs on the CUDA card
unless given --device cpu.

Usage: python scripts/diag_loop_alias_torch.py [--frames 240] [--out f.json]
       [--scale 2] [--device cuda|cpu]
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


def build_alias_scene(cfg, period=3.2, n_periods=16, seed=7):
    """Corridor along +z: side walls / floor / ceiling textured with
    tiles whose world-space period divides `period` (uv_scale=80,
    256 texels -> 3.2 units), furniture repeated every period. The numpy
    draws come in the reference's order."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          _smooth_texture)

    rng = np.random.RandomState(seed)
    length = period * n_periods
    tex_side = _smooth_texture(rng, 256)
    tex_floor = _smooth_texture(rng, 256)
    tex_ceil = _smooth_texture(rng, 256)
    tex_end = _smooth_texture(rng, 1024)
    surfaces = [
        dict(axis=0, offset=-2.2, tex=tex_side, uax=2, vax=1),
        dict(axis=0, offset=2.2, tex=tex_side, uax=2, vax=1),
        dict(axis=1, offset=1.0, tex=tex_floor, uax=0, vax=2),
        dict(axis=1, offset=-1.4, tex=tex_ceil, uax=0, vax=2),
        dict(axis=2, offset=length + 4.0, tex=tex_end, uax=0, vax=1),
        dict(axis=2, offset=-4.0, tex=tex_end, uax=0, vax=1),
    ]
    base_cell = []
    for _ in range(4):
        size = rng.uniform(0.3, 0.6)
        base_cell.append(dict(
            center=np.array([rng.uniform(-1.8, -0.9) if rng.rand() < 0.5
                             else rng.uniform(0.9, 1.8),
                             1.0 - size / 2,
                             rng.uniform(0.2, period - 0.2)]),
            size=size, tex=_smooth_texture(rng, 64)))
    structures = []
    for k in range(n_periods):
        for b in base_cell:
            structures.append(dict(
                center=b["center"] + np.array([0.0, 0.0, k * period]),
                size=b["size"], tex=b["tex"]))

    cam = cfg.camera
    h, w = cam.height, cam.width
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                     np.ones_like(xs, np.float64)], -1)
    return SyntheticScene(
        h=h, w=w, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        bf=cam.bf, rng=rng, tex=tex_end, plane_z=length + 4.0,
        boxes=[], rays=rays, surfaces=surfaces, structures=structures,
        bounds_lo=np.array([-2.2, -1.4, -4.0], np.float32),
        bounds_hi=np.array([2.2, 1.0, length + 4.0], np.float32))


def straight_path(n, step=0.2, bob=0.15):
    """Camera-to-world poses walking +z with a slight lateral sinusoid
    (pure straight motion leaves x parallax-starved)."""
    Ts = []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = [bob * np.sin(i * 0.15), 0.0, i * step]
        Ts.append(T)
    return Ts


def alias_summary(sys_, poses_wc, frames):
    """run_alias's record of a finished corridor system (poses_wc: the
    camera-to-world ground truth)."""
    lc = sys_.loop_closer
    errs = []
    for rec, Twc in zip(sys_.trajectory, poses_wc):
        if rec.tracked:
            C = -np.asarray(rec.Tcw)[:3, :3].T @ np.asarray(rec.Tcw)[:3, 3]
            errs.append(np.linalg.norm(C - Twc[:3, 3]))
    return dict(
        frames=frames,
        tracked=sum(1 for r in sys_.trajectory if r.tracked),
        keyframes=sys_.n_keyframes,
        ate_rmse_mm=float(np.sqrt(np.mean(np.square(errs))) * 1e3)
        if errs else -1.0,
        loops_closed=lc.n_loops_closed,
        loops_rejected=lc.n_loops_rejected,
        events=lc.events)


def render_frame(scene, cfg, Twc):
    """The corridor's frame at a camera-to-world pose, as run_alias
    tracks it: (gray, depth, rgb, sem_arrays)."""
    gray, depth, rgb, sem = scene.render_rgbd(np.linalg.inv(Twc))
    return gray, depth, rgb, scene.sem_arrays(sem,
                                              cfg.semantic.max_instances)


def run_alias(args, device=None, systems=None, frames=None):
    """The corridor's run: run_alias's record (alias_summary). frames:
    the frames render_frame gives at straight_path's poses, rendered
    beforehand (rendered here otherwise). systems: a list the system is
    appended to."""
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = build_cfg(args.scale)
    poses = straight_path(args.frames, step=args.step)
    if frames is None:
        scene = build_alias_scene(cfg, period=args.period,
                                  n_periods=args.periods, seed=args.seed)
        frames = (render_frame(scene, cfg, Twc) for Twc in poses)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device=device)
    for i, (gray, depth, rgb, sem) in enumerate(frames):
        sys_.track_rgbd(gray, depth, rgb, sem, timestamp=i / 30.0)
    sys_.flush_mapping()
    if systems is not None:
        systems.append(sys_)
    return alias_summary(sys_, poses, args.frames)


def run_positive(args, device=None):
    """The accepted-closure control: the positive circuit."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = build_cfg(args.scale)
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3, plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = loop_trajectory(120, sweep=2 * np.pi * 1.15)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device=device)
    lc = sys_.loop_closer
    for i, T in enumerate(poses):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb,
                        scene.sem_arrays(sem, cfg.semantic.max_instances),
                        timestamp=i / 30.0)
    sys_.flush_mapping()
    return dict(loops_closed=lc.n_loops_closed,
                loops_rejected=lc.n_loops_rejected,
                events=lc.events)


def cost_ratios(alias_events, accepted_wall_ms):
    """The mean wall ms of the corridor's pre-gated and post-gated
    rejections over that of the accepted closures: the reference's
    cost_ratio_* keys (absent without an accepted closure or without
    such a rejection)."""
    pre = [e for e in alias_events if e.get("pre_gated")]
    post = [e for e in alias_events
            if not e.get("accepted") and not e.get("pre_gated")]
    out = {}
    if accepted_wall_ms and pre:
        out["cost_ratio_pregated_vs_accepted"] = round(
            np.mean([e["wall_ms"] for e in pre])
            / np.mean(accepted_wall_ms), 3)
    if accepted_wall_ms and post:
        out["cost_ratio_postgated_vs_accepted"] = round(
            np.mean([e["wall_ms"] for e in post])
            / np.mean(accepted_wall_ms), 3)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--periods", type=int, default=16)
    ap.add_argument("--period", type=float, default=3.2)
    ap.add_argument("--step", type=float, default=0.2)
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    # positive circuit FIRST and TWICE: the first pass warms the whole
    # correction path (propagate / fuse / pose graph / GBA / quality); the
    # second gives a warm accepted-closure wall cost for the ratio
    run_positive(args, args.device)
    pos = run_positive(args, args.device)
    print("positive circuit (warm):", json.dumps(
        {k: v for k, v in pos.items() if k != "events"}), flush=True)
    for e in pos["events"]:
        print("  event:", json.dumps(e), flush=True)

    alias = run_alias(args, args.device)
    print("alias corridor:", json.dumps(
        {k: v for k, v in alias.items() if k != "events"}), flush=True)
    for e in alias["events"]:
        print("  event:", json.dumps(e), flush=True)

    acc = [e["wall_ms"] for e in pos["events"] if e.get("accepted")]
    out = dict(alias=alias, positive=pos)
    out.update(cost_ratios(alias["events"], acc))
    print(json.dumps({k: v for k, v in out.items()
                      if k.startswith("cost_ratio")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
