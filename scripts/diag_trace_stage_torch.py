#!/usr/bin/env python
"""Capture an op-level device profile of one pipeline stage (fused
tracking / mapping / frame build) on the live KITTI state with the
PyTorch port, and print its top device ops (the counterpart of
scripts/diag_trace_stage.py).

SlamConfig.kitti_stereo(), objects on, inline mapping, the first
--frames frames of a KITTI directory through track_stereo
(diag_kitti_stages_torch.drive), then the mapping flushed. The stage's
call takes the reference's arguments (diag_kitti_stages_torch.
stage_calls: SlamSystem._fused_impl, _mapping_pass, builder.build_stereo
on the last pair); it runs once to warm up, then once under
torch.profiler, whose trace goes to --trace-dir
(tensorboard_trace_handler), and prof_ops_torch.top_ops prints its top
CUDA kernels (its CPU ops on the CPU). Runs on the CUDA card unless
given --device cpu.

Usage:
  python scripts/diag_trace_stage_torch.py --stage fused --seq DIR
  python scripts/diag_trace_stage_torch.py --stage mapping --seq DIR
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import prof_ops_torch  # noqa: E402

# --stage -> diag_kitti_stages_torch.stage_calls' name
STAGE_CALLS = {"fused": "fused", "mapping": "mapping",
               "build": "build_stereo"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_kitti4")
    ap.add_argument("--stage", default="fused", choices=list(STAGE_CALLS))
    ap.add_argument("--trace-dir", default=prof_ops_torch.DEFAULT_DIR)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def flushed(state):
    """A diag_kitti_stages_torch.drive state with the mapping flushed, as
    the reference flushes before it traces: its map, last frame and
    keyframe the flushed system's."""
    sys_ = state["sys"]
    sys_.flush_mapping()
    return dict(state, map=sys_.map, last=sys_.last_frame,
                kf_id=max(sys_.last_kf_id, 0))


def drive_state(cfg, seq, frames, device=None):
    """diag_kitti_stages_torch.drive over the first frames of seq, then
    flushed."""
    import diag_kitti_stages_torch as stages
    state = stages.drive(cfg, seq, device, frames)
    try:
        return flushed(state)
    except BaseException:
        state["sys"].shutdown()
        raise


def trace_stage(state, stage, trace_dir):
    """One warm call of the stage, then one call under torch.profiler into
    trace_dir: the traced call's wall ms (synchronized)."""
    import torch
    import diag_kitti_stages_torch as stages
    sys_ = state["sys"]
    fn = stages.stage_calls(sys_, state["map"], state["frame"],
                            state["last"], state["kf_id"],
                            state["pair"])[STAGE_CALLS[stage]]
    cuda = sys_.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(sys_.device)

    fn()
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                trace_dir)):
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms


def run(cfg, args, state=None, log=print):
    """Trace args.stage (state: drive_state's, else driven here and shut
    down after) and print the top args.top rows. Returns {"rows":
    prof_ops_torch.top_ops' rows, "wall_ms": the traced call's}."""
    own = state is None
    if own:
        state = drive_state(cfg, args.seq, args.frames, args.device)
    try:
        wall_ms = trace_stage(state, args.stage, args.trace_dir)
    finally:
        if own:
            state["sys"].shutdown()
    rows = prof_ops_torch.top_ops(args.trace_dir, args.top)
    prof_ops_torch.print_rows(rows, log)
    return {"rows": rows, "wall_ms": wall_ms}


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
