#!/usr/bin/env python
"""Where the objects-on full-pipeline frame time goes, with the PyTorch
port (the counterpart of scripts/diag_fullpipe.py): bench.py's room
(SlamConfig.tum_rgbd(), seed 3, three boxes of 0.9, orbit_poses(frames,
step=0.01)) as u16 depth, u8 rgb and the detection slab, each frame built
by FrameBuilder.build_rgbd (gray from the rgb) and then tracked, the two
timed apart with the stage profiler on. Prints the semantic arrays'
bytes per frame beside the depth's and the rgb's, the median build and
track ms after frame 4, and the profiler's report. Runs on the CUDA card
unless given --device cpu.

Usage: python scripts/diag_fullpipe_torch.py [--frames 16]
       [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

WARMUP = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def to_inputs(cfg, depth, rgb, sem_arrays):
    """A rendered frame as the script feeds it: (u16 depth in the
    camera's depth units, u8 rgb, the detection slab)."""
    d16 = np.clip(np.asarray(depth) * cfg.camera.depth_map_factor, 0,
                  65535).astype(np.uint16)
    rgb8 = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    return d16, rgb8, sem_arrays


def render_frames(cfg, n_frames):
    """bench.py's room on orbit_poses(n_frames, step=0.01), rendered here
    in turn: [(d16, rgb8, sem_arrays)]."""
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    out = []
    for T in orbit_poses(n_frames, step=0.01):
        _, depth, rgb, sem = scene.render_rgbd(T)
        out.append(to_inputs(cfg, depth, rgb, scene.sem_arrays(
            sem, cfg.semantic.max_instances)))
    return out


def frame_bytes(d16, rgb8, sem_arrays):
    """The bytes one frame sends to the card: (semantic arrays, depth,
    rgb)."""
    return (sum(np.asarray(a).nbytes for a in sem_arrays), d16.nbytes,
            rgb8.nbytes)


def run(cfg, n_frames=16, device=None, frames=None, log=print):
    """Build and track n_frames (frames: [(d16, rgb8, sem_arrays)], else
    rendered by render_frames), each build and track timed with the card
    synchronized. Returns {"bytes": (sem, depth, rgb), "build_ms",
    "track_ms": per frame, "build_median_ms", "track_median_ms" (after
    WARMUP frames), "report", "spans": {name: calls}, and after the last
    frame's lagged readback is resolved: "Tcw" [n, 4, 4], "tracked" [n],
    "kf_frames"}."""
    import torch
    from object_slam_tpu_torch.slam.system import SlamSystem

    if frames is None:
        frames = render_frames(cfg, n_frames)
    frames = frames[:n_frames]
    sem_b, depth_b, rgb_b = frame_bytes(*frames[0])
    log(f"sem arrays per frame: {sem_b / 1e6:.2f} MB "
        f"(+{depth_b / 1e6:.2f} MB depth, {rgb_b / 1e6:.2f} MB rgb)")

    sys_ = SlamSystem(cfg, enable_objects=True, device=device)
    sys_.profiler.enabled = True

    def sync():
        if sys_.device.type == "cuda":
            torch.cuda.synchronize(sys_.device)

    build_t, track_t = [], []
    try:
        for i, (d16, rgb8, sa) in enumerate(frames):
            t0 = time.perf_counter()
            f = sys_.builder.build_rgbd(None, d16, rgb8, sa, i / 30.0)
            sync()
            t1 = time.perf_counter()
            sys_._host_ts = i / 30.0
            sys_._track(f)
            sync()
            t2 = time.perf_counter()
            build_t.append(t1 - t0)
            track_t.append(t2 - t1)
        build_t, track_t = np.asarray(build_t), np.asarray(track_t)
        build_med = float(np.median(build_t[WARMUP:]) * 1e3)
        track_med = float(np.median(track_t[WARMUP:]) * 1e3)
        log(f"build: median {build_med:.1f} ms  "
            f"track: median {track_med:.1f} ms")
        report = sys_.profiler.report()
        log(report)
        spans = {k: v["n"] for k, v in sys_.profiler.stats().items()}
        sys_._resolve_fused_pending()
        m = sys_.map
        kf_valid = m.kf_valid.cpu().numpy()
        kf_frames = sorted(int(x) for x in
                           m.kf_frame_id.cpu().numpy()[kf_valid])
        return {"bytes": (sem_b, depth_b, rgb_b),
                "build_ms": build_t * 1e3, "track_ms": track_t * 1e3,
                "build_median_ms": build_med, "track_median_ms": track_med,
                "report": report, "spans": spans,
                "Tcw": np.stack([r.Tcw for r in sys_.trajectory]),
                "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
                "kf_frames": kf_frames}
    finally:
        sys_.shutdown()


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.tum_rgbd(), args.frames, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
