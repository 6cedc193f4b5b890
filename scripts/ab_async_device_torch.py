#!/usr/bin/env python
"""Second-device async-mapping A/B with the PyTorch port (the counterpart
of scripts/ab_async_device.py; the same circuit, runs and keys).

The reference overlaps mapping with tracking on a second CPU thread
(System.cc:95, LocalMapping.cc:48). The port's ``SlamSystem(async_mapping
=True)`` runs each keyframe's mapping pass on a snapshot of the map in a
worker thread: on a second card when there is one (``cuda:1``; the
snapshot is copied there and the result back), else on a side stream of
the tracker's card, or in a thread on the CPU. The result merges at the
next keyframe (merge lag bounded to one keyframe by the insert-time
barrier).

This script records, on the same synthetic circuit (320x240 at --scale
2, 500 features, three objects, objects on):
  sync        -- mapping inline on the tracker's device
  async_dev1  -- mapping dispatched to the async mapper

for each: wall fps, per-frame median, ATE, keyframes, tracked frames,
frames with a pass in flight and the merge lag. ``mapping_device`` reads
``dev1`` only when the pass ran on another device; ``mapping_placement``
says where it ran ("cuda:0 side stream", "cuda:1" or "cpu thread").
``n_devices`` is the card count. Runs on the CUDA card unless given
--device cpu.

Usage: python scripts/ab_async_device_torch.py --frames 120
       [--device cuda|cpu] [--out F.json]
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

ARMS = (("sync", False), ("async_dev1", True))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--turns", type=float, default=1.15)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="write the JSON record")
    return ap.parse_args(argv)


def inputs(cfg, args, n=None):
    """The circuit of args (the room of args.seed with three objects,
    loop_trajectory over args.frames frames and args.turns turns), cut to
    its first n frames, rendered: (poses, rendered, sems)."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    scene = SyntheticScene.make(cfg, seed=args.seed, n_objects=3,
                                plane_z=4.0)
    poses = loop_trajectory(args.frames,
                            sweep=2 * np.pi * args.turns)[:n]
    rendered = [scene.render_rgbd(T) for T in poses]
    sems = [scene.sem_arrays(s, cfg.semantic.max_instances)
            for (_, _, _, s) in rendered]
    return poses, rendered, sems


@contextlib.contextmanager
def pinned_ready():
    """_AsyncMapping.ready reads "a pass is pending", as the reference's
    record pins it (its ready() follows the device's timing)."""
    from object_slam_tpu_torch.slam.system import _AsyncMapping
    ready = _AsyncMapping.ready
    _AsyncMapping.ready = lambda self: self.pending is not None
    try:
        yield
    finally:
        _AsyncMapping.ready = ready


def second_device(sys_):
    """An on_system hook: the async mapper's second-device branch with the
    tracker's own device as its device (the snapshot and the result
    copied, on one card or on the CPU)."""
    from object_slam_tpu_torch.slam.system import _AsyncMapping
    if sys_._async is not None:
        sys_._async = _AsyncMapping(sys_._mapping_pass, sys_.device,
                                    device=sys_.device)


def run_arm(cfg, poses, rendered, sems, async_mapping, device=None,
            on_system=None):
    """One arm over the rendered circuit (on_system(sys_): a hook before
    the first frame). Returns (the reference's dict with
    mapping_placement, detail): detail holds what the run is held by:
    "tracked" and "rec_tcw" per frame, "inserts" (the frames a keyframe
    was inserted on), "lag" per frame (-1 with no pass in flight),
    "n_points", "dispatches", "fast_dispatches" and "merges"."""
    from object_slam_tpu_torch.device import indexed
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=async_mapping,
                      device=device)
    if on_system is not None:
        on_system(sys_)
    inserts = []
    insert_impl = sys_._insert_impl

    def insert(m, frame, Tcw, kp_pt, close_mask, frame_id):
        inserts.append(int(frame_id))
        return insert_impl(m, frame, Tcw, kp_pt, close_mask, frame_id)
    sys_._insert_impl = insert
    try:
        # frames-since-dispatch, one sample per frame with a pass in flight
        lags, lag_at = [], []
        dispatch_frame, last_pending_kf = -1, -1
        t0 = time.perf_counter()
        times = []
        for i, (gray, depth, rgb, _) in enumerate(rendered):
            tf0 = time.perf_counter()
            sys_.track_rgbd(gray, depth, rgb, sems[i], timestamp=i / 30.0)
            times.append(time.perf_counter() - tf0)
            lag = -1
            if sys_._async is not None and sys_._async.pending is not None:
                if sys_._async.pending_kf != last_pending_kf:
                    dispatch_frame, last_pending_kf = (
                        i, sys_._async.pending_kf)
                lag = i - dispatch_frame
                lags.append(lag)
            lag_at.append(lag)
        total = time.perf_counter() - t0
        sys_.flush_mapping()
        errs = [np.linalg.norm(rec.Tcw[:3, 3] - T[:3, 3])
                for rec, T in zip(sys_.trajectory, poses) if rec.tracked]
        am = sys_._async
        stats = sys_.mapping_stats
        res = {
            "async": async_mapping,
            "mapping_device": ("dev1" if am is not None
                               and am.device is not None
                               and am.device != am.home else "dev0"),
            "mapping_placement": (am.placement if am is not None
                                  else f"{indexed(sys_.device)} inline"),
            "fps": len(poses) / total,
            "median_frame_ms": float(np.median(times) * 1e3),
            "ate_rmse_mm": float(np.sqrt(np.mean(np.square(errs))) * 1e3),
            "keyframes": sys_.n_keyframes,
            "tracked": sum(1 for r in sys_.trajectory if r.tracked),
            "frames_with_pending_pass": len(lags),
            "merge_lag_frames_max": int(max(lags)) if lags else 0,
            "merge_lag_frames_median": (float(np.median(lags)) if lags
                                        else 0.0),
        }
        detail = {
            "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
            "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
                np.float32),
            "inserts": inserts,
            "lag": np.asarray(lag_at, np.int32),
            "n_points": int(sys_.map.pt_valid.sum()),
            "dispatches": stats["passes"] if am is not None else 0,
            "fast_dispatches": stats["abbreviated"] if am is not None else 0,
            "merges": (stats["barrier_merges"] + stats["ready_merges"]
                       + stats["flush_merges"]),
        }
    finally:
        sys_.shutdown()
    return res, detail


def n_devices(device) -> int:
    """The card count (1 for a run on the CPU)."""
    import torch
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def run(cfg, args, n=None, rendered=None, on_system=None, log=print):
    """Both arms, sync first, over the first n frames of args' circuit
    (rendered: inputs(cfg, args, n), else rendered here; on_system: as
    run_arm's, for both arms). Returns ({"n_devices", "sync",
    "async_dev1"}, {arm: run_arm's detail})."""
    poses, frames, sems = rendered or inputs(cfg, args, n)
    out = {"n_devices": n_devices(args.device)}
    details = {}
    for name, flag in ARMS:
        out[name], details[name] = run_arm(cfg, poses, frames, sems, flag,
                                           args.device, on_system)
        log(name + " " + json.dumps(out[name]))
    return out, details


def main(argv=None):
    from ab_deviations_torch import build_cfg
    args = parse_args(argv)
    out, _ = run(build_cfg(args.scale), args,
                 log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
