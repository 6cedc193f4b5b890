"""Profile the PyTorch port's RGB-D main path on one CUDA card.

    python scripts/profile_torch_slice.py [--frames 24] [--window 8]
                                          [--objects-off]

Runs SlamSystem.track_rgbd (TUM VGA, strict readback) on frames rendered
like chip_smoke.py, objects on with the frames' detections (or objects
off with ``--objects-off``), then traces the last ``--window`` frames
with torch.profiler. Prints one JSON object: host ms per frame, the
device's busy share of that wall time (union of kernel intervals), kernel
launches per frame, CUDA synchronizations per frame, the device time of
the port's own kernels, the kernels and host ops that take the most time,
and, for each object stage (the Object2D build, association, the
semantic optimizer, the object update), its launches, sync-like calls and
device time per frame and its top ops by device time. Needs a card.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--objects-off", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import card_line, render, tum_cfg
    from object_slam_tpu_torch.slam.system import SlamSystem

    objects = not args.objects_off
    card = card_line()
    cfg = tum_cfg()
    poses, frames, sems = render(cfg, args.frames)
    sys_ = SlamSystem(cfg, enable_objects=objects, device="cuda")

    def step(i):
        sys_.track_rgbd(*frames[i], sems[i] if objects else None,
                        timestamp=i / 30.0)

    n_warm = args.frames - args.window
    for i in range(n_warm):
        step(i)
    torch.cuda.synchronize()
    kf_before = sys_.n_keyframes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, args.frames):
            step(i)
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
        "card": card, "objects": objects, "frames_traced": w,
        "keyframes_in_window": sys_.n_keyframes - kf_before,
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
    }
    if objects:
        out["object_stages"] = {s: stage_ops(events, s, w) for s in STAGES}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
