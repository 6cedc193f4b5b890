#!/usr/bin/env python
"""TUM RGB-D driver for the PyTorch port.

The port's counterpart of scripts/run_tum.py: run the system over an
associated TUM sequence with offline YOLACT masks, save
CameraTrajectory.txt / KeyFrameTrajectory.txt / ObjectInfo.txt, and print
the same JSON summary (fps, per-frame track times, keyframes, points, and
the ATE against groundtruth.txt when the sequence has one).

Frames are decoded off the tracking thread by the native prefetcher
(object_slam_tpu_torch/native: every frame submitted up front, 4 worker
threads, 8 decoded frames ahead), as run_tum.py does; the arrays equal
the port's PNG reader's (datasets/png.py). They are fed as u8 rgb + raw
u16 depth; the frame builder converts on the device.

``--viz-dir`` writes an overlay PNG per frame, the scrubber page
(index.html) and the map viewer page (map.html) there; as in run_tum.py
it forces the strict readback, so that each overlay shows its own frame's
tracking result.

Usage:
  python scripts/run_tum_torch.py --seq DIR [--semantic-dir DIR]
      [--out OUT_DIR] [--max-frames N] [--no-objects] [--metrics PATH]
      [--loop [--vocab VOCAB.txt]] [--viz-dir DIR] [--device cuda|cpu]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--semantic-dir", default=None)
    ap.add_argument("--out", default="ExpResults")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-objects", action="store_true")
    ap.add_argument("--metrics", default=None,
                    help="write per-frame JSONL metrics to this path "
                         "(utils/metrics.MetricsStream)")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing and the BoW relocalization")
    ap.add_argument("--vocab", default=None,
                    help="a DBoW2 text vocabulary (ORBvoc.txt format) for "
                         "--loop; default: the package's vocab_synth.txt")
    ap.add_argument("--viz-dir", default=None,
                    help="write per-frame overlay PNGs, the scrubber page "
                         "and the map viewer page to this directory "
                         "(forces the strict readback)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    from object_slam_tpu_torch.eval import ate as ate_mod
    from object_slam_tpu_torch.eval import trajectory_io
    from object_slam_tpu_torch.semantic import loader as sem_loader
    from object_slam_tpu_torch.slam.system import STATE_NAMES, SlamSystem

    cfg = SlamConfig.tum_rgbd()
    frames = tum.load_sequence(args.seq)
    if args.max_frames:
        frames = frames[:args.max_frames]
    print(f"{len(frames)} frames")

    metrics = None
    if args.metrics:
        from object_slam_tpu_torch.utils.metrics import MetricsStream
        metrics = MetricsStream(args.metrics)
    scrub = None
    if args.viz_dir:
        # the scrubber reads each frame's state and pose at once; with the
        # one-frame-lagged readback they would belong to the frame before
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pipelined_readback=False))
        from object_slam_tpu_torch.viz.scrubber import Scrubber
        scrub = Scrubber(args.viz_dir, fps=cfg.camera.fps)
    sys_ = SlamSystem(cfg, enable_objects=not args.no_objects,
                      enable_loop=args.loop, vocab_path=args.vocab,
                      device=args.device, metrics=metrics)

    from object_slam_tpu_torch.native.loader import FramePrefetcher
    pf = FramePrefetcher(n_workers=4, capacity=8)
    for i, fr in enumerate(frames):
        pf.submit(i, fr.rgb_path, fr.depth_path)

    t0 = time.perf_counter()
    times, loop_times = [], []
    for i, fr in enumerate(frames):
        ti0 = time.perf_counter()
        rgb, depth, _ = pf.get(i)
        rgb, depth16 = tum.frame_arrays(rgb, depth, fr.depth_path)
        sem_arrays = None
        if args.semantic_dir:
            dets = sem_loader.read_semantic_dir(
                args.semantic_dir, sem_loader.tum_frame_key(fr.timestamp),
                cfg.semantic.min_confidence, cfg.semantic.valid_labels_tum)
            if dets:
                sem_arrays = sem_loader.detections_to_arrays(
                    dets, cfg.semantic.max_instances, cfg.camera.height,
                    cfg.camera.width)
        tf0 = time.perf_counter()
        f = sys_.track_rgbd(None, depth16, rgb, sem_arrays,
                            timestamp=fr.timestamp)
        times.append(time.perf_counter() - tf0)
        if scrub is not None:
            scrub.add_frame(rgb, f, state=STATE_NAMES[sys_.state],
                            n_inliers=int(sys_._last_n_inliers),
                            kfs=sys_.n_keyframes, ref_kf=sys_.last_kf_id)
        loop_times.append(time.perf_counter() - ti0)
        if i % 50 == 0:
            print(f"frame {i}/{len(frames)} kfs={sys_.n_keyframes} "
                  f"pts={sys_.n_points}")
    sys_.flush_mapping()
    total = time.perf_counter() - t0
    pf.close()
    if metrics is not None:
        metrics.close()
    if scrub is not None:
        from object_slam_tpu_torch.viz.map_viewer import export_map_html
        print("scrubber:", scrub.write())
        print("map viewer:", export_map_html(
            sys_.map, trajectory=sys_.trajectory,
            path=os.path.join(args.viz_dir, "map.html")))

    os.makedirs(args.out, exist_ok=True)
    traj = sys_.final_trajectory()
    m = sys_.map
    trajectory_io.save_trajectory_tum(
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

    lt = np.asarray(loop_times)
    tt = np.asarray(times)
    result = {
        "frames": len(frames),
        "fps": len(frames) / total,
        "median_track_ms": float(np.median(tt) * 1e3),
        "median_overhead_ms": float(np.median(lt - tt) * 1e3),
        "p90_frame_ms": float(np.percentile(lt, 90) * 1e3),
        "max_frame_ms": float(np.max(lt) * 1e3),
        "keyframes": sys_.n_keyframes,
        "points": sys_.n_points,
    }
    gt_file = os.path.join(args.seq, "groundtruth.txt")
    if os.path.isfile(gt_file):
        ts_gt, pos_gt, _ = tum.load_groundtruth(args.seq)
        est = [(t, np.linalg.inv(T)[:3, 3]) for t, T, ok in traj if ok]
        pairs = ate_mod.associate_timestamps([t for t, _ in est], ts_gt)
        if len(pairs) > 10:
            e = np.array([est[a][1] for a, b in pairs])
            g = np.array([pos_gt[b] for a, b in pairs])
            result["ate_rmse"] = ate_mod.ate_rmse(e, g)
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
