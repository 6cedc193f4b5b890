#!/usr/bin/env python
"""EuRoC MAV stereo / monocular driver for the PyTorch port.

The port's counterpart of scripts/run_euroc.py (Examples/Stereo/
stereo_euroc.cc, Examples/Monocular/mono_euroc.cc): enumerate the cam0 /
cam1 images from a timestamps file or the mav0 csv, rectify them with the
LEFT./RIGHT. blocks of the settings YAML, run
``SlamConfig.euroc_stereo()`` with the camera block derived from that YAML
(objects off, as the reference driver runs it and as System.cc:334-338
requires for mono), save CameraTrajectory.txt (TUM rows) and print the
reference driver's JSON summary: frames, frames per second, keyframes,
points, and with the ground-truth csv (more than 10 matched stamps) the
ATE.

As in the reference, the ATE aligns by a rigid transform only, which
means nothing for a monocular trajectory: its scale is free. Frames are
decoded off the tracking thread by the native prefetcher
(object_slam_tpu_torch/native: the left image under id 2i, the right under
2i + 1 unless mono, 4 worker threads, 6 decoded images ahead), as
run_euroc.py does; the arrays equal the port's PNG reader's
(datasets/png.py). The CUDA kernels are built before the timed loop.

Usage:
  python scripts/run_euroc_torch.py --mav MAV0_DIR --calib SETTINGS.yaml
      [--mono] [--loop] [--times FILE] [--max-frames N] [--gt auto|FILE]
      [--out OUT_DIR] [--device cuda|cpu]
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
    ap.add_argument("--mav", required=True, help="path to mav0/")
    ap.add_argument("--calib", required=True, help="settings YAML with "
                    "LEFT./RIGHT. rectification blocks")
    ap.add_argument("--times", default=None,
                    help="optional timestamps file (default: cam0 csv)")
    ap.add_argument("--out", default="ExpResults")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--gt", default="auto",
                    help="'auto' = mav0/state_groundtruth_estimate0/data.csv")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import euroc
    from object_slam_tpu_torch.eval import ate as ate_mod
    from object_slam_tpu_torch.eval import trajectory_io
    from object_slam_tpu_torch.ops import build
    from object_slam_tpu_torch.slam.system import SlamSystem

    calib = euroc.EurocCalib.from_yaml(args.calib)
    cfg = SlamConfig.euroc_stereo().replace(
        camera=euroc.euroc_camera_config(calib),
        sensor="mono" if args.mono else "stereo")
    if args.times:
        frames = euroc.load_sequence(
            os.path.join(args.mav, "cam0", "data"),
            os.path.join(args.mav, "cam1", "data"), args.times)
    else:
        frames = euroc.load_sequence_mav(args.mav)
    if args.max_frames:
        frames = frames[:args.max_frames]

    rect = euroc.Rectifier(calib)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=args.loop,
                      device=args.device)
    if sys_.device.type == "cuda":
        t0 = time.perf_counter()
        build.load_all(["orb_describe"])
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    from object_slam_tpu_torch.native.loader import FramePrefetcher
    pf = FramePrefetcher(n_workers=4, capacity=6)
    for i, fr in enumerate(frames):
        pf.submit(2 * i, fr.left_path)
        if not args.mono:
            pf.submit(2 * i + 1, fr.right_path)

    t0 = time.perf_counter()
    for i, fr in enumerate(frames):
        gl = euroc.to_gray(pf.get(2 * i)[0])
        if args.mono:
            gl = euroc.remap_bilinear(gl, rect.lx, rect.ly)
            sys_.track_mono(gl, timestamp=fr.timestamp)
        else:
            gl, gr = rect(gl, euroc.to_gray(pf.get(2 * i + 1)[0]))
            # rgb None: the left image three times, made on the device
            sys_.track_stereo(gl, gr, None, None, timestamp=fr.timestamp)
        if i % 100 == 0:
            print(f"frame {i}/{len(frames)} kfs={sys_.n_keyframes}",
                  flush=True)
    total = time.perf_counter() - t0
    pf.close()

    os.makedirs(args.out, exist_ok=True)
    traj = sys_.final_trajectory()
    trajectory_io.save_trajectory_tum(
        os.path.join(args.out, "CameraTrajectory.txt"), traj)

    result = {"frames": len(frames), "fps": len(frames) / total,
              "keyframes": sys_.n_keyframes, "points": sys_.n_points}
    gt_path = (os.path.join(args.mav, "state_groundtruth_estimate0",
                            "data.csv") if args.gt == "auto" else args.gt)
    if gt_path and os.path.isfile(gt_path):
        gt_ts, gt_pos, _ = euroc.load_groundtruth_csv(gt_path)
        est_ts = np.array([t for t, _, _ in traj])
        est = np.array([np.linalg.inv(T)[:3, 3] for _, T, _ in traj])
        pairs = ate_mod.associate_timestamps(est_ts, gt_ts, max_dt=0.02)
        if len(pairs) > 10:
            ia = [a for a, _ in pairs]
            ib = [b for _, b in pairs]
            result["ate_rmse"] = ate_mod.ate_rmse(est[ia], gt_pos[ib])
    sys_.shutdown()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
