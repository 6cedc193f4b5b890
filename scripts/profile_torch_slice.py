"""Profile the PyTorch port's RGB-D or stereo path on one CUDA card.

    python scripts/profile_torch_slice.py [--frames 24] [--window 8]
                                          [--objects-off]
                                          [--blob {host,device}] [--strict]
    python scripts/profile_torch_slice.py --sensor stereo [--async-mapping]
                                          [--frames 24] [--window 8]
    python scripts/profile_torch_slice.py --loop

Runs SlamSystem.track_rgbd (TUM VGA, strict readback) on frames rendered
like chip_smoke.py, objects on with the frames' detections (or objects
off with ``--objects-off``), then traces the last ``--window`` frames
with torch.profiler. ``--blob`` runs bench.py's protocol instead: the
default configuration (pipelined readback), the frames packed by
pack_frame_blob into track_rgbd_blob, the numpy blob per frame (``host``,
one pinned non-blocking copy each) or every blob staged on the card first
(``device``); the trace window then ends with flush_mapping.
``--strict`` keeps the strict readback in blob mode, for a comparison on
the same frames. ``--sensor stereo`` runs SlamSystem.track_stereo with
SlamConfig.kitti_stereo() (full width, objects on, the default pipelined
path, rgb=None) over chip_smoke.py's rendered KITTI drive, with inline
mapping or, with ``--async-mapping``, the mapping thread on its side
stream; the busy share is the union of every stream's kernels, the mapping
thread's included.

Prints one JSON object: host ms per frame, the
device's busy share of that wall time (union of kernel intervals), kernel
launches per frame, CUDA synchronizations per frame, the device time of
the port's own kernels, the kernels and host ops that take the most time,
and, for each object stage (the Object2D build, association, the
semantic optimizer, the object update), its launches, sync-like calls and
device time per frame and its top ops by device time.

``--loop`` profiles loop closing at TUM-VGA width instead, on the closure
of chip_smoke.py's loop pass (tests/torch_fixtures/loop_pass_tum_vga.npz,
the JAX Sim3 draws replayed): one on_keyframe that detects without
closing (the consistency groups emptied first), then the one that closes
the loop, each after a warm-up call; for each it prints the host ms, the
kernel launches and sync-like calls, and for every stage range
(loop.detect, loop.sim3, loop.propagate, loop.fuse, loop.pose_graph,
loop.gba, loop.quality) the same plus its device time and top ops.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# the port's hand-written kernels, by a part of their CUDA names
PORT_KERNELS = ("orb_describe_kernel", "patch_extract_kernel")
# the object stages: the port's own profiler ranges of these names
# (SlamSystem._span, and FrameBuilder around the Object2D build)
STAGES = ("object2d", "object_assoc", "semopt", "object_update")
# the system's profiler ranges whose host time is reported per frame
SPANS = ("frame_build", "match_stereo", "object2d", "track_fused",
         "resolve", "insert_keyframe", "local_mapping", "mapping_dispatch",
         "mapping_merge", "local_mapping_async", "object_assoc", "semopt",
         "object_update")
# host calls that wait for the device or copy through it
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync", "cudaEventSynchronize")


def busy_ms(events):
    """Length of the union of [start, end) device intervals, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def stage_ops(events, stage, w):
    """Device time (ms / frame), kernel launches and sync-like calls (per
    frame) of the ops inside every range named ``stage``, by op, largest
    first."""
    ops = defaultdict(lambda: [0.0, 0])
    syncs = [e for e in events if e.name in SYNC_CALLS]
    n_ranges = n_sync = 0
    for e in events:
        # each range appears twice: on the host (with its ops) and as a
        # device-side annotation
        if e.name != stage or e.device_type != DeviceType.CPU:
            continue
        n_ranges += 1
        r = e.time_range
        n_sync += sum(1 for c in syncs if c.thread == e.thread
                      and r.start <= c.time_range.start < r.end)
        todo = list(e.cpu_children)
        while todo:
            op = todo.pop()
            todo.extend(op.cpu_children)
            if op.kernels:
                ops[op.name][0] += sum(k.duration for k in op.kernels) / 1e3
                ops[op.name][1] += len(op.kernels)
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {"calls_per_frame": n_ranges / w,
            "device_ms_per_frame": sum(v[0] for v in ops.values()) / w,
            "launches_per_frame": sum(v[1] for v in ops.values()) / w,
            "sync_like_calls_per_frame": n_sync / w,
            "top_ops": [(k, round(v[0] / w, 4), round(v[1] / w, 2))
                        for k, v in top[:8]]}


def span_host_ms(events, w):
    """Host ms per frame and calls per frame of each range in SPANS (the
    host-side events; the mapping thread's too where the profiler records
    that thread)."""
    out = {}
    for name in SPANS:
        ev = [e for e in events if e.name == name
              and e.device_type == DeviceType.CPU]
        if ev:
            out[name] = (round(sum(e.time_range.end - e.time_range.start
                                   for e in ev) / 1e3 / w, 4),
                         round(len(ev) / w, 3))
    return out


LOOP_RANGES = ("loop.detect", "loop.sim3", "loop.propagate", "loop.fuse",
               "loop.pose_graph", "loop.gba", "loop.quality")


def profile_loop(card):
    """on_keyframe without and with the accepted closure, profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import LOOP_PASS_REF, LOOP_STAGES
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.loop.loop_closing import LoopCloser
    from object_slam_tpu_torch.slam.map_state import init_map

    fx = np.load(LOOP_PASS_REF)
    cfg = SlamConfig.tum_rgbd()
    q = int(fx["q"])
    state_in = {k[len("state_in."):]: fx[k] for k in fx.files
                if k.startswith("state_in.")}

    def closer():
        lc = LoopCloser(cfg, Intrinsics.from_config(cfg.camera),
                        device="cuda")
        interop.loop_state_from_numpy(lc, state_in)
        sets = [torch.from_numpy(x).cuda() for x in fx["sim3_sets"]]
        lc._minimal_sets = lambda valid, n_trials=256: sets.pop(0)
        return lc
    base = interop.map_state_to_numpy(init_map(
        cfg.caps, cfg.objects.history_capacity,
        n_bow_words=closer().vocab.n_words, device="cpu"))
    m_in = interop.map_state_from_numpy(
        interop.stage_maps(fx, base, LOOP_STAGES)["in"], device="cuda")
    out = {"card": card, "q": q}
    for name, groups in (("detect_only", False), ("closure", True)):
        for warm in (True, False):
            lc = closer()
            if not groups:
                lc.consistent_groups = []
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, closed = lc.on_keyframe(m_in, q)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        stages = {r: stage_ops(events, r, 1) for r in LOOP_RANGES}
        for r, v in stages.items():
            ev = [e for e in events if e.name == r
                  and e.device_type == DeviceType.CPU]
            v["host_ms"] = round(sum(e.time_range.end - e.time_range.start
                                     for e in ev) / 1e3, 3)
        out[name] = {
            "closed": bool(closed), "host_ms": wall_ms,
            "device_busy_ms": busy_ms(dev),
            "kernel_launches": len(dev),
            "sync_like_calls": sum(1 for e in events
                                   if e.name in SYNC_CALLS),
            "stages": {r: v for r, v in stages.items()
                       if v["calls_per_frame"]}}
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--objects-off", action="store_true")
    ap.add_argument("--blob", choices=("host", "device"), default=None)
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--sensor", choices=("rgbd", "stereo"), default="rgbd")
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--loop", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import card_line, render, to_blob, tum_cfg
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.slam.system import SlamSystem

    objects = not args.objects_off
    card = card_line()
    if args.loop:
        return profile_loop(card)
    if args.sensor == "stereo":
        from object_slam_tpu_torch.datasets.synthetic import render_street
        cfg = SlamConfig.kitti_stereo()
        _, kframes, _ = render_street(cfg, args.frames)
        sys_ = SlamSystem(cfg, enable_objects=objects,
                          async_mapping=args.async_mapping, device="cuda")

        def step(i):
            gl, gr, sa = kframes[i]
            sys_.track_stereo(gl, gr, None, sa if objects else None,
                              timestamp=i / 10.0)
    else:
        cfg = tum_cfg()
        poses, frames, sems = render(cfg, args.frames)
        if args.blob and not args.strict:
            cfg = SlamConfig.tum_rgbd()
        sys_ = SlamSystem(cfg, enable_objects=objects, device="cuda")

    if args.sensor == "rgbd" and args.blob:
        blobs = [to_blob(sys_.builder, cfg, d, rgb,
                         sems[i] if objects else None)
                 for i, (_, d, rgb) in enumerate(frames)]
        if args.blob == "device":
            blobs = [(torch.tensor(b, device="cuda"), iv) for b, iv in blobs]

        def step(i):
            sys_.track_rgbd_blob(*blobs[i], timestamp=i / 30.0)
    elif args.sensor == "rgbd":
        def step(i):
            sys_.track_rgbd(*frames[i], sems[i] if objects else None,
                            timestamp=i / 30.0)

    n_warm = args.frames - args.window
    for i in range(n_warm):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, args.frames):
            step(i)
        sys_.flush_mapping()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    # device work only: the stage ranges' device-side annotations span the
    # gaps between their kernels and would count as busy time
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation
           and e.time_range.end > e.time_range.start]
    n_sync = sum(1 for e in events if e.name in SYNC_CALLS)
    ka = prof.key_averages()
    spans = {e.name for e in events if e.is_user_annotation}
    top_dev = sorted((k for k in ka if k.key not in spans),
                     key=lambda k: -k.device_time_total)[:12]
    top_cpu = sorted(ka, key=lambda k: -k.self_cpu_time_total)[:12]
    port = [k for k in ka if any(n in k.key for n in PORT_KERNELS)]
    w = args.window
    out = {
        "card": card, "sensor": args.sensor, "objects": objects,
        "async_mapping": args.async_mapping, "blob": args.blob,
        "pipelined_readback": cfg.tracking.pipelined_readback,
        "frames_traced": w,
        "keyframes_in_window": int(torch.sum(
            sys_.map.kf_valid & (sys_.map.kf_frame_id >= n_warm))),
        "host_ms_per_frame": wall_ms / w,
        "device_busy_ms_per_frame": busy_ms(dev) / w,
        "device_busy_share": busy_ms(dev) / wall_ms,
        "kernel_launches_per_frame": len(dev) / w,
        "sync_like_calls_per_frame": n_sync / w,
        "top_device": [(k.key, round(k.device_time_total / 1e3 / w, 4),
                        k.count // w) for k in top_dev],
        "port_kernels": [(k.key, round(k.device_time_total / 1e3 / w, 4),
                          k.count // w) for k in port],
        "top_host_self": [(k.key, round(k.self_cpu_time_total / 1e3 / w, 4),
                           k.count // w) for k in top_cpu],
        "span_host_ms_and_calls_per_frame": span_host_ms(events, w),
        "mapping": dict(sys_.mapping_stats),
    }
    if objects:
        out["object_stages"] = {s: stage_ops(events, s, w) for s in STAGES}
    if args.sensor == "stereo":
        out["match_stereo"] = stage_ops(events, "match_stereo", w)
    sys_.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
