"""Tracing / profiling instrumentation.

Counterpart of object_slam_tpu/utils/profiling.py: a per-stage span
recorder (host timers around device stages) and a device trace context.
On the card a span synchronizes the device before it reads the clock at
each end, so it times the device work of its stage, not the enqueue; a
disabled profiler records nothing and synchronizes nothing.

Usage:
    prof = StageProfiler(device="cuda")
    with prof.span("track.motion_model"):
        res = stage(...)
    print(prof.report())

    with cuda_trace("/path/trace"):   # a torch.profiler trace
        run_frames()
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class StageProfiler:
    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        dev = torch.device(device) if device is not None else None
        self._sync = dev is not None and dev.type == "cuda"
        self._device = dev
        self.samples: Dict[str, List[float]] = defaultdict(list)

    def _fence(self):
        if self._sync:
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._fence()
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self):
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v) * 1e3
            out[k] = {
                "n": len(v),
                "mean_ms": float(a.mean()),
                "median_ms": float(np.median(a)),
                "p90_ms": float(np.percentile(a, 90)),
                "total_ms": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.stats().items(),
                      key=lambda kv: -kv[1]["total_ms"])
        lines = [f"{'stage':<28}{'n':>6}{'median':>10}{'p90':>10}{'total':>12}"]
        for k, s in rows:
            lines.append(f"{k:<28}{s['n']:>6}{s['median_ms']:>9.2f}ms"
                         f"{s['p90_ms']:>9.2f}ms{s['total_ms']:>10.1f}ms")
        return "\n".join(lines)

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.stats(), f, indent=2)

    def reset(self):
        self.samples.clear()


@contextlib.contextmanager
def cuda_trace(logdir: str):
    """A torch.profiler trace of the CPU and the card over the block,
    written to logdir/trace.json (Chrome's chrome://tracing or Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
