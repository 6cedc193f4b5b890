#!/usr/bin/env python
"""KITTI stereo odometry driver for the PyTorch port.

The port's counterpart of scripts/run_kitti.py: run the stereo pipeline
(``SlamConfig.kitti_stereo()``) over a KITTI odometry sequence with
car-class masks, save CameraTrajectory.txt (KITTI rows),
KeyFrameTrajectory.txt (TUM rows) and ObjectInfo.txt, and print one JSON
summary: ms per frame, keyframes, points, objects, semantic constraints,
and with ``--gt`` the ATE and RPE.

Async mapping is the default, as in run_kitti.py (``--sync-mapping`` runs
each keyframe's mapping pass inline). Frames are decoded off the tracking
thread by the native prefetcher (object_slam_tpu_torch/native: both
images of every frame submitted up front under ids 2i and 2i + 1, each
taken once, 4 worker threads, 6 decoded images ahead), as run_kitti.py
does; the arrays equal the port's PNG reader's (datasets/png.py). They
are fed as u8 gray pairs with ``rgb=None``. ``--viz-dir`` writes the map viewer
page (map.html) there. The CUDA kernels are built before the timed loop; torch
compiles nothing else, so there is no scratch-system prewarm, and the two
faults of run_kitti.py's prewarm (a scratch system built without the run's
flags, and prewarm iterations not clamped to the sequence) have nothing
to carry over.

Usage:
  python scripts/run_kitti_torch.py --seq DIR [--gt FILE]
      [--semantic-dir DIR] [--out OUT_DIR] [--max-frames N]
      [--sync-mapping] [--loop [--vocab VOCAB.txt]] [--viz-dir DIR]
      [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--semantic-dir", default=None)
    ap.add_argument("--out", default="ExpResults")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--sync-mapping", action="store_true",
                    help="run each keyframe's mapping pass inline instead "
                         "of on the mapping thread")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing and the BoW relocalization")
    ap.add_argument("--vocab", default=None,
                    help="a DBoW2 text vocabulary (ORBvoc.txt format) for "
                         "--loop; default: the package's vocab_synth.txt")
    ap.add_argument("--viz-dir", default=None,
                    help="write the interactive map viewer page to this "
                         "directory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.eval import ate as ate_mod
    from object_slam_tpu_torch.eval import trajectory_io
    from object_slam_tpu_torch.ops import build
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = SlamConfig.kitti_stereo()
    frames = kitti.load_sequence(args.seq)
    if args.max_frames:
        frames = frames[:args.max_frames]
    print(f"{len(frames)} frames")

    sys_ = SlamSystem(cfg, enable_objects=args.semantic_dir is not None,
                      async_mapping=not args.sync_mapping,
                      enable_loop=args.loop, vocab_path=args.vocab,
                      device=args.device)
    if sys_.device.type == "cuda":
        t0 = time.perf_counter()
        build.load_all(["orb_describe"])
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    from object_slam_tpu_torch.native.loader import FramePrefetcher
    pf = FramePrefetcher(n_workers=4, capacity=6)
    for i, fr in enumerate(frames):
        pf.submit(2 * i, fr.left_path)
        pf.submit(2 * i + 1, fr.right_path)

    t0 = time.perf_counter()
    times, loop_times = [], []
    for i, fr in enumerate(frames):
        ti0 = time.perf_counter()
        gl, gr = kitti.gray_pair(pf.get(2 * i)[0], pf.get(2 * i + 1)[0])
        sem_arrays = None
        if args.semantic_dir:
            sem_arrays = kitti.load_semantics(args.semantic_dir, fr.index,
                                              cfg)
        tf0 = time.perf_counter()
        sys_.track_stereo(gl, gr, None, sem_arrays, timestamp=fr.timestamp)
        times.append(time.perf_counter() - tf0)
        loop_times.append(time.perf_counter() - ti0)
        if i % 50 == 0:
            print(f"frame {i}/{len(frames)} kfs={sys_.n_keyframes}",
                  flush=True)
    sys_.flush_mapping()
    total = time.perf_counter() - t0
    pf.close()
    if args.viz_dir:
        from object_slam_tpu_torch.viz.map_viewer import export_map_html
        print("map viewer:", export_map_html(
            sys_.map, trajectory=sys_.trajectory,
            path=os.path.join(args.viz_dir, "map.html")))

    os.makedirs(args.out, exist_ok=True)
    traj = sys_.final_trajectory()
    m = sys_.map
    trajectory_io.save_trajectory_kitti(
        os.path.join(args.out, "CameraTrajectory.txt"), traj)
    trajectory_io.save_keyframe_trajectory_tum(
        os.path.join(args.out, "KeyFrameTrajectory.txt"),
        m.kf_timestamp.cpu().numpy(), m.kf_pose.cpu().numpy(),
        m.kf_valid.cpu().numpy())
    if sys_.objects is not None:
        trajectory_io.save_object_info(
            os.path.join(args.out, "ObjectInfo.txt"),
            m.obj_label.cpu().numpy(), m.obj_valid.cpu().numpy(),
            sys_.objects.semantic_constraints)

    tt = np.asarray(times)
    result = {
        "frames": len(frames),
        "fps": len(frames) / total,
        "median_track_ms": float(np.median(tt) * 1e3),
        "mean_track_ms": float(np.mean(tt) * 1e3),
        "median_overhead_ms": float(np.median(np.asarray(loop_times) - tt)
                                    * 1e3),
        "async_mapping": not args.sync_mapping,
        "tracked": int(sum(1 for _, _, ok in traj if ok)),
        "keyframes": sys_.n_keyframes,
        "keyframes_valid": int(m.kf_valid.sum()),
        "points": sys_.n_points,
        "mapping": dict(sys_.mapping_stats),
    }
    if sys_.objects is not None:
        result["objects"] = int(m.obj_valid.sum())
        result["semantic_constraints"] = int(
            sys_.objects.semantic_constraints)
    if args.gt and os.path.isfile(args.gt):
        gt = kitti.load_groundtruth(args.gt)
        est = np.array([np.linalg.inv(T)[:3, 3] for _, T, _ in traj])
        n = min(len(est), len(gt))
        result["ate_rmse"] = ate_mod.ate_rmse(est[:n], gt[:n, :3, 3])
        tracked_mask = np.array([ok for _, _, ok in traj])[:n]
        rpe = ate_mod.rpe(
            np.array([np.linalg.inv(T) for _, T, _ in traj])[:n], gt[:n],
            tracked=tracked_mask)
        result.update({"rpe_" + k: v for k, v in rpe.items()})
    sys_.shutdown()
    if sys_.loop_closer is not None:
        result["loops_closed"] = sys_.loop_closer.n_loops_closed
        result["loops_rejected"] = sys_.loop_closer.n_loops_rejected
        result["loop_events"] = sys_.loop_closer.events
        # keyframes with a BoW row (every keyframe gets one)
        result["bow_rows"] = int(((m.kf_bow != 0).any(dim=1)
                                  & m.kf_valid).sum())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
