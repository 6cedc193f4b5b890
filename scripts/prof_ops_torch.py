#!/usr/bin/env python
"""Print the top device ops (by total device time) of a torch.profiler
trace directory, the counterpart of scripts/prof_ops.py.

Reads the newest ``*.pt.trace.json`` that
``torch.profiler.tensorboard_trace_handler`` wrote under the directory
and sums, for each CUDA kernel (events of category "kernel"), its
durations and its launches. A trace of a CPU run has no kernel events:
its CPU ops (category "cpu_op") are ranked instead.

Usage:
  python scripts/prof_ops_torch.py build/trace_stage [top_n]
"""
import collections
import glob
import json
import os
import sys

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "build", "trace_stage")


def newest_trace(trace_dir):
    """The newest trace file under trace_dir (exits when there is none)."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not files:
        raise SystemExit(f"no *.pt.trace.json under {trace_dir}")
    return max(files, key=lambda f: (os.path.getmtime(f), f))


def load_events(path):
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def top_ops(trace_dir, top_n=30):
    """[(ms, count, name)] of the newest trace's CUDA kernels (its CPU ops
    when it has none), most device time first; top_n None: every op."""
    events = [e for e in load_events(newest_trace(trace_dir))
              if e.get("ph") == "X"]
    cat = ("kernel" if any(e.get("cat") == "kernel" for e in events)
           else "cpu_op")
    tot = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        if e.get("cat") != cat:
            continue
        tot[e["name"]] += float(e.get("dur", 0.0)) / 1e3   # us -> ms
        cnt[e["name"]] += 1
    return [(t, cnt[name], name) for name, t in tot.most_common(top_n)]


def print_rows(rows, log=print):
    for t, c, name in rows:
        log(f"{t:9.2f}ms x{c:7d}  {name[:110]}")


if __name__ == "__main__":
    d = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    print_rows(top_ops(d, n))
