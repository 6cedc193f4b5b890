#!/usr/bin/env python
"""Distributed-BA scaling benchmark with the PyTorch port (the counterpart
of scripts/bench_ba_scaling.py; the same problem, iterations and lines).

Measures global-BA iteration throughput of the sharded Schur solver
(parallel/sharded_ba.py) over 1, 2, 4 and 8 ranks, cut to what the device
allows. The problem is the reference's: RandomState(0), 64 keyframes,
8192 points, each keyframe observing pts // 4 random points (131,072
observations), SlamConfig()'s camera, observations valid where the depth
exceeds 0.1. The reference shards the segment-sum form over the
observations; the port deals whole keyframe blocks to the ranks (each
keeps the blocked [Kk, block_n] layout and its own per-point table), with
block_n = pts // 4, the problem's own blocks.

  --device cuda    NCCL, one rank per card, world sizes up to the card
                   count; world size 1 runs in this process (elsewhere
                   every world size is spawned)
  --device cuda:0  gloo ranks that share card 0 (their efficiency
                   measures contention on one card, and the line says so)
  --cpu-mesh N     gloo ranks on the CPU, world sizes up to N (the
                   reference's virtual CPU mesh)

Each world size runs one warm-up and then --reps timed runs of --iters
iterations. Prints one JSON line per world size: devices, ba_iters_per_s,
scaling_efficiency (against the first world size run, 1 by default), obs,
kf, pts, backend and ranks_per_card.

Usage: python scripts/bench_ba_scaling_torch.py [--device cuda|cuda:0]
       [--cpu-mesh N] [--kf 64] [--pts 8192] [--iters 10] [--reps 5]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

SIZES = (1, 2, 4, 8)
TIMEOUT_S = 1800.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kf", type=int, default=64)
    ap.add_argument("--pts", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="gloo ranks on the CPU, up to this many")
    ap.add_argument("--device", default=None,
                    help="cuda (NCCL, one rank per card; the default) or "
                         "cuda:0 (gloo ranks on card 0)")
    return ap.parse_args(argv)


def problem(n_kf, n_pt):
    """The reference's problem as numpy arrays of BAProblem's fields
    (interop.ba_problem_from_numpy's form), built on the CPU: (K,
    arrays)."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.geometry import se3
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    K = Intrinsics.from_config(SlamConfig().camera)
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-3, 3, (n_pt, 3)).astype(np.float32)
                           + np.array([0, 0, 6], np.float32))
    poses = torch.stack([se3.exp(torch.from_numpy(
        rng.normal(0, 0.1, 6).astype(np.float32))) for _ in range(n_kf)])
    obs_kf = np.repeat(np.arange(n_kf), n_pt // 4)
    obs_pt = rng.randint(0, n_pt, obs_kf.shape[0])
    ok, op = torch.from_numpy(obs_kf), torch.from_numpy(obs_pt)
    pc = (torch.einsum('oij,oj->oi', poses[ok, :3, :3], pts[op])
          + poses[ok, :3, 3])
    z = torch.clamp(pc[:, 2], min=1e-3)
    uv = torch.stack([K.fx * pc[:, 0] / z + K.cx,
                      K.fy * pc[:, 1] / z + K.cy], -1)
    kf_fixed = np.zeros(n_kf, bool)
    kf_fixed[0] = True
    arrays = {
        "kf_pose": poses.numpy(), "kf_fixed": kf_fixed,
        "kf_valid": np.ones(n_kf, bool),
        "pt_xyz": (pts + 0.01).numpy(), "pt_valid": np.ones(n_pt, bool),
        "obs_kf": obs_kf.astype(np.int32), "obs_pt": obs_pt.astype(np.int32),
        "obs_uv": uv.numpy(), "obs_ur": (uv[:, 0] - K.bf / z).numpy(),
        "obs_inv_sigma2": np.ones(obs_kf.shape[0], np.float32),
        "obs_valid": (z > 0.1).numpy()}
    return K, arrays


def plan(args):
    """(device, backend, world sizes, ranks per card) of args."""
    import torch
    if args.cpu_mesh:
        return "cpu", "gloo", [s for s in SIZES if s <= args.cpu_mesh], None
    device = args.device or "cuda"
    if torch.device(device).type != "cuda":
        raise ValueError(f"--device {device}: only cuda or cuda:<index>; "
                         f"pass --cpu-mesh N to run the ranks on the CPU")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu-mesh N "
                           "to run the ranks on the CPU")
    if torch.device(device).index is None:
        n = torch.cuda.device_count()
        return device, "nccl", [s for s in SIZES if s <= n], 1
    return device, "gloo", list(SIZES), "world"


def _in_process(K, arrays, device, backend, block_n, iters, reps):
    """World size 1 in this process (a group of one): the result and ms of
    each of 1 + reps runs."""
    import torch
    import torch.distributed as dist
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.device import indexed
    from object_slam_tpu_torch.parallel import distributed, sharded_ba
    dev = indexed(device)
    with tempfile.TemporaryDirectory() as d:
        distributed.maybe_initialize_distributed(
            "file://" + os.path.join(d, "store"), 1, 0, device=dev,
            backend=backend)
        try:
            prob = interop.ba_problem_from_numpy(arrays, device=dev)
            ms = []
            for _ in range(1 + reps):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                kf_pose, pt_xyz = sharded_ba.run_sharded_global_ba(
                    K, prob, iters, block_n=block_n)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            dist.destroy_process_group()
    return [{"kf_pose": kf_pose.cpu().numpy(),
             "pt_xyz": pt_xyz.cpu().numpy(), "ms": np.asarray(ms)}]


def run(args, sizes=None, setup=None, log=print):
    """Every world size of plan(args) (or of sizes), each one warm-up and
    args.reps timed runs. setup(rank, world): a module-level function
    each spawned rank runs first (a planted fault). Returns (the JSON
    lines, {world size: per rank {"kf_pose", "pt_xyz", "ms"}})."""
    from object_slam_tpu_torch.parallel import sharded_ba
    device, backend, default_sizes, per_card = plan(args)
    K, arrays = problem(args.kf, args.pts)
    block_n = args.pts // 4
    lines, results = [], {}
    base = None                     # (world size, rate) of the first run
    for nd in (sizes or default_sizes):
        if nd == 1 and backend == "nccl" and setup is None:
            outs = _in_process(K, arrays, device, backend, block_n,
                               args.iters, args.reps)
        else:
            outs = sharded_ba.spawn_sharded_global_ba(
                K, arrays, nd, block_n=block_n, n_iters=args.iters,
                device=device, backend=backend, reps=1 + args.reps,
                timeout_s=TIMEOUT_S, setup=setup)
        results[nd] = outs
        dt = float(np.mean(outs[0]["ms"][1:])) / 1e3
        rate = args.iters / dt
        base = base or (nd, rate)
        line = {"devices": nd, "ba_iters_per_s": round(rate, 2),
                "scaling_efficiency": round(
                    rate * base[0] / (base[1] * nd), 3),
                "obs": int(arrays["obs_kf"].shape[0]), "kf": args.kf,
                "pts": args.pts, "backend": backend,
                "ranks_per_card": nd if per_card == "world" else per_card}
        if per_card == "world":
            line["note"] = ("the ranks share one card: the efficiency "
                            "measures contention")
        lines.append(line)
        log(json.dumps(line))
    return lines, results


def main(argv=None):
    args = parse_args(argv)
    lines, _ = run(args, log=lambda s: print(s, flush=True))
    return lines


if __name__ == "__main__":
    main()
