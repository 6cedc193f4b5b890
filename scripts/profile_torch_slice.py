"""Profile the PyTorch port's RGB-D slice on one CUDA card.

    python scripts/profile_torch_slice.py [--frames 24] [--window 8]

Runs SlamSystem.track_rgbd (TUM VGA, objects off, strict readback) on
frames rendered like chip_smoke.py, then traces the last ``--window``
frames with torch.profiler. Prints one JSON object: host ms per frame, the
device's busy share of that wall time (union of kernel intervals), kernel
launches per frame, CUDA synchronizations per frame, the device time of
the port's own kernels, and the kernels and host ops that take the most
time. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


# the port's hand-written kernels, by a part of their CUDA names
PORT_KERNELS = ("orb_describe_kernel", "patch_extract_kernel")


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--window", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import card_line, render, tum_cfg
    from object_slam_tpu_torch.slam.system import SlamSystem

    card = card_line()
    cfg = tum_cfg()
    poses, frames = render(cfg, args.frames)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cuda")
    n_warm = args.frames - args.window
    for i in range(n_warm):
        sys_.track_rgbd(*frames[i], None, timestamp=i / 30.0)
    torch.cuda.synchronize()
    kf_before = sys_.n_keyframes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, args.frames):
            sys_.track_rgbd(*frames[i], None, timestamp=i / 30.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and e.time_range.end > e.time_range.start]
    n_sync = sum(1 for e in events if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaMemcpyAsync", "cudaEventSynchronize"))
    ka = prof.key_averages()
    top_dev = sorted(ka, key=lambda k: -k.device_time_total)[:12]
    top_cpu = sorted(ka, key=lambda k: -k.self_cpu_time_total)[:12]
    port = [k for k in ka if any(n in k.key for n in PORT_KERNELS)]
    w = args.window
    out = {
        "card": card, "frames_traced": w,
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
