#!/usr/bin/env python
"""One-process experiment battery for the PyTorch port.

The port's counterpart of scripts/run_experiments.py, with its variants,
its prewarm and its JSON keys. On an RGB-D sequence from
scripts/make_synth_tum_torch.py (or make_synth_tum.py):
  t200_a, t200_b     the determinism pair (identical inputs, sync)
  t200_noobj_sync    objects off (the objects A/B)
  t200_semopt_off    the object pipeline without the semantic pose
                     refinement (cfg.objects.semopt_enabled=False)
  t200_async         async mapping
  t200_loop          loop closing on
and on a KITTI sequence from scripts/make_synth_kitti_torch.py:
  kitti, kitti_async stereo end-to-end ATE / RPE and the object census,
                     inline and async mapping.

The TUM frames are decoded up front by the port's PNG reader and fed as
u8 rgb + raw u16 depth with bit-packed masks; every TUM program set is
warmed by a throwaway 12-frame run first. run_kitti warms a scratch
system on the first frames, then decodes one frame ahead through the
native prefetcher (object_slam_tpu_torch/native), as the reference's
run_kitti does through its own. Everything runs on the card unless
``--device cpu`` is given.

Usage:
  python scripts/run_experiments_torch.py --tum DIR [--kitti DIR]
      [--out experiments.json] [--max-frames N] [--skip a,b]
      [--device cuda|cpu]
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

PREWARM_FRAMES = 12


def tum_variants(cfg):
    """The reference's TUM variant list: (name, config, SlamSystem
    options)."""
    cfg_semoff = semopt_off(cfg)
    return [
        # determinism pair (identical inputs, sync, objects on)
        ("t200_a", cfg, dict(enable_objects=True, async_mapping=False)),
        ("t200_b", cfg, dict(enable_objects=True, async_mapping=False)),
        # the objects A/B (sync both sides)
        ("t200_noobj_sync", cfg,
         dict(enable_objects=False, async_mapping=False)),
        # the object pipeline without the semantic pose refinement
        ("t200_semopt_off", cfg_semoff,
         dict(enable_objects=True, async_mapping=False)),
        # the async-mapping A/B side
        ("t200_async", cfg, dict(enable_objects=True, async_mapping=True)),
        # loop closing on
        ("t200_loop", cfg,
         dict(enable_objects=True, async_mapping=False, enable_loop=True)),
    ]


def semopt_off(cfg):
    return cfg.replace(objects=dataclasses.replace(cfg.objects,
                                                   semopt_enabled=False))


def run_tum_variant(tum_dir, cfg, frames, metas, device=None, systems=None,
                    **sys_kw):
    """One variant over the decoded frames (load_tum_frames); the
    reference's result keys. ``systems``: a list the system is appended to
    (callers read its trajectory)."""
    from object_slam_tpu_torch.datasets import tum
    from object_slam_tpu_torch.eval import ate as ate_mod
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, device=device, **sys_kw)
    t0 = time.perf_counter()
    times = []
    for i, (rgb8, d16, sem) in enumerate(frames):
        tf0 = time.perf_counter()
        sys_.track_rgbd(None, d16, rgb8, sem, timestamp=metas[i].timestamp)
        times.append(time.perf_counter() - tf0)
    total = time.perf_counter() - t0

    traj = sys_.final_trajectory()
    result = {
        "frames": len(frames),
        "fps": len(frames) / total,
        "median_track_ms": float(np.median(times) * 1e3),
        "keyframes": sys_.n_keyframes,
        "points": sys_.n_points,
        "tracked": sum(1 for _, _, ok in traj if ok),
    }
    if sys_.objects is not None:
        result["objects"] = int(sys_.map.obj_valid.sum())
        result["semantic_constraints"] = int(
            sys_.objects.semantic_constraints)
    if sys_.loop_closer is not None:
        result["loops_closed"] = sys_.loop_closer.n_loops_closed
        result["loops_rejected"] = sys_.loop_closer.n_loops_rejected
        result["loop_events"] = sys_.loop_closer.events
    gt_file = os.path.join(tum_dir, "groundtruth.txt")
    if os.path.isfile(gt_file):
        ts_gt, pos_gt, _ = tum.load_groundtruth(tum_dir)
        est = [(t, np.linalg.inv(T)[:3, 3]) for t, T, ok in traj if ok]
        pairs = ate_mod.associate_timestamps([t for t, _ in est], ts_gt)
        if len(pairs) > 10:
            e = np.array([est[a][1] for a, b in pairs])
            g = np.array([pos_gt[b] for a, b in pairs])
            result["ate_rmse"] = ate_mod.ate_rmse(e, g)
    sys_.shutdown()
    if systems is not None:
        systems.append(sys_)
    return result


def load_tum_frames(tum_dir, cfg, max_frames=0):
    """Decode the whole sequence up front (u8 rgb, raw u16 depth, the
    detections with bit-packed masks, or None)."""
    from object_slam_tpu_torch.datasets import tum
    from object_slam_tpu_torch.semantic import loader as sem_loader
    from object_slam_tpu_torch.semantic.object2d import pack_mask_bits

    metas = tum.load_sequence(tum_dir)
    if max_frames:
        metas = metas[:max_frames]
    sem_dir = os.path.join(tum_dir, "semantic")
    frames = []
    for fr in metas:
        rgb, d16 = tum.load_frame_raw(fr)
        sem = None
        if os.path.isdir(sem_dir):
            dets = sem_loader.read_semantic_dir(
                sem_dir, sem_loader.tum_frame_key(fr.timestamp),
                cfg.semantic.min_confidence, cfg.semantic.valid_labels_tum)
            if dets:
                sa = sem_loader.detections_to_arrays(
                    dets, cfg.semantic.max_instances, cfg.camera.height,
                    cfg.camera.width)
                sem = (pack_mask_bits(sa[0]),) + tuple(sa[1:])
        frames.append((rgb.astype(np.uint8), d16, sem))
    return metas, frames


def run_kitti(kitti_dir, max_frames=0, async_mapping=False, device=None,
              prewarm=PREWARM_FRAMES, systems=None):
    """The stereo drive (SlamConfig.kitti_stereo(), objects on, rgb=None)
    after a scratch system's prewarm on the first ``prewarm`` frames; the
    reference's result keys."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.eval import ate as ate_mod
    from object_slam_tpu_torch.native.loader import FramePrefetcher
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = SlamConfig.kitti_stereo()
    frames = kitti.load_sequence(kitti_dir)
    if max_frames:
        frames = frames[:max_frames]
    gt = kitti.load_groundtruth(os.path.join(kitti_dir, "gt.txt"))
    sem_dir = os.path.join(kitti_dir, "semantic")

    # untimed prewarm on a scratch system (the allocator's caches, the
    # kernels' first launches)
    scratch = SlamSystem(cfg, enable_objects=True,
                         async_mapping=async_mapping, device=device)
    for fr in frames[:prewarm]:
        gl, gr = kitti.load_frame_raw(fr)
        scratch.track_stereo(gl, gr, None,
                             kitti.load_semantics(sem_dir, fr.index, cfg),
                             timestamp=fr.timestamp)
    scratch.shutdown()
    del scratch

    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=async_mapping,
                      device=device)
    # decode one frame ahead through the prefetcher
    pf = FramePrefetcher(n_workers=4, capacity=6)
    for i, fr in enumerate(frames):
        pf.submit(2 * i, fr.left_path)
        pf.submit(2 * i + 1, fr.right_path)

    def fetch(i):
        gl, gr = kitti.gray_pair(pf.get(2 * i)[0], pf.get(2 * i + 1)[0])
        return gl, gr, kitti.load_semantics(sem_dir, frames[i].index, cfg)

    t0 = time.perf_counter()
    times = []
    nxt = fetch(0)
    for i, fr in enumerate(frames):
        gl, gr, sa = nxt
        if i + 1 < len(frames):
            nxt = fetch(i + 1)
        tf0 = time.perf_counter()
        sys_.track_stereo(gl, gr, None, sa, timestamp=fr.timestamp)
        times.append(time.perf_counter() - tf0)
        if i % 50 == 0:
            print(f"kitti f={i}", flush=True)
    total = time.perf_counter() - t0
    pf.close()

    traj = sys_.final_trajectory()
    est = np.array([np.linalg.inv(T)[:3, 3] for _, T, _ in traj])
    n = min(len(est), len(gt))
    result = {
        "frames": len(frames),
        "fps": len(frames) / total,
        "median_track_ms": float(np.median(times) * 1e3),
        "keyframes": sys_.n_keyframes,
        "points": sys_.n_points,
        "objects": int(sys_.map.obj_valid.sum()),
        "semantic_constraints": int(sys_.objects.semantic_constraints),
        "ate_rmse": ate_mod.ate_rmse(est[:n], gt[:n, :3, 3]),
    }
    tracked_mask = np.array([ok for _, _, ok in traj])[:n]
    rpe = ate_mod.rpe(
        np.array([np.linalg.inv(T) for _, T, _ in traj])[:n], gt[:n],
        tracked=tracked_mask)
    result.update({"rpe_" + k: v for k, v in rpe.items()})
    result["tracked"] = int(tracked_mask.sum())
    sys_.shutdown()
    if systems is not None:
        systems.append(sys_)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tum", default=None)
    ap.add_argument("--kitti", default=None)
    ap.add_argument("--out", default="experiments.json")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--skip", default="",
                    help="comma list of variants to skip")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    skip = set(args.skip.split(","))

    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.ops import build
    device = resolve_device(args.device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        build.load_all(["orb_describe"])
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    cfg = SlamConfig.tum_rgbd()
    out = {}

    if args.tum and os.path.isdir(args.tum):
        metas, frames = load_tum_frames(args.tum, cfg, args.max_frames)
        print(f"tum: {len(frames)} frames loaded", flush=True)
        # untimed prewarm per distinct program set: a throwaway run
        for wcfg, wkw in [(cfg, dict(enable_objects=True)),
                          (cfg, dict(enable_objects=False)),
                          (semopt_off(cfg), dict(enable_objects=True)),
                          (cfg, dict(enable_objects=True,
                                     enable_loop=True))]:
            run_tum_variant(args.tum, wcfg, frames[:PREWARM_FRAMES],
                            metas[:PREWARM_FRAMES], device=device, **wkw)
        print("tum: prewarm done", flush=True)
        for name, vcfg, kw in tum_variants(cfg):
            if name in skip:
                continue
            t0 = time.perf_counter()
            out[name] = run_tum_variant(args.tum, vcfg, frames, metas,
                                        device=device, **kw)
            print(name, json.dumps(out[name])[:300],
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)

    for name, async_mapping in (("kitti", False), ("kitti_async", True)):
        if args.kitti and os.path.isdir(args.kitti) and name not in skip:
            out[name] = run_kitti(args.kitti, args.max_frames,
                                  async_mapping=async_mapping, device=device)
            print(name, json.dumps(out[name])[:300], flush=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
