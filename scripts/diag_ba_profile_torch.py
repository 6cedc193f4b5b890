#!/usr/bin/env python
"""Where local-BA time goes at KITTI caps, with the PyTorch port (the
counterpart of scripts/diag_ba_profile.py): ba_iterate over LM iteration
counts, CG iteration counts and the reduction structure (the scatter form,
index_add_ over the observations' keyframes and points, against the
blocked per-keyframe sums and the per-point slot table), on the
reference's synthetic problem with realistic shapes (Wtot=40 window
keyframes x N=2048 observations each, Lp=8192 points; RandomState(0), the
same host loop and dedupe). One line per variant: ms per call over 3
calls after one warm call. --print-launches adds the kernel launches of
one call, and its memory copies and sets apart (torch.profiler), on a
line of its own. Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_ba_profile_torch.py [--wtot 40] [--n 2048]
       [--lp 8192] [--print-launches] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

# (name, blocked (block_n N, else None: the scatter form), the slot table
# (else None: the scatter form), LM iterations, CG iterations): the
# reference's seven, in its order
VARIANTS = (
    ("scatter  n_iters=5  cg=24", False, False, 5, 24),
    ("blocked  n_iters=5  cg=24", True, False, 5, 24),
    ("blk+slot n_iters=1  cg=24", True, True, 1, 24),
    ("blk+slot n_iters=5  cg=0 ", True, True, 5, 0),
    ("blk+slot n_iters=5  cg=8 ", True, True, 5, 8),
    ("blk+slot n_iters=5  cg=24", True, True, 5, 24),
    ("blk+slot n_iters=15 cg=24", True, True, 15, 24),
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--wtot", type=int, default=40)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--lp", type=int, default=8192)
    ap.add_argument("--print-launches", action="store_true",
                    help="also print the kernel launches (and the copies "
                         "and sets) of one call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def build_problem(K, Wtot: int, N: int, Lp: int):
    """The reference's problem as numpy arrays (ba_problem_from_numpy's
    keys) and its [Lp, Wtot] slot table: a camera ring over a point
    cloud, each of Wtot keyframes observing N random points with 0.5 px
    noise, the points moved by 5 cm; an observation repeating a (point,
    keyframe) pair is dropped, as the real builder dedupes."""
    O = Wtot * N
    rng = np.random.RandomState(0)
    pts = rng.uniform([-20, -5, 5], [20, 5, 60], (Lp, 3)).astype(np.float32)
    poses = []
    for i in range(Wtot):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, 0, -0.5 * i]
        poses.append(T)
    poses = np.stack(poses)
    fx, fy, cx, cy, bf = (float(K.fx), float(K.fy), float(K.cx),
                          float(K.cy), float(K.bf))
    obs_pt = rng.randint(0, Lp, (O,)).astype(np.int32)
    obs_kf = np.repeat(np.arange(Wtot), N).astype(np.int32)
    pw = pts[obs_pt]
    pc = (poses[obs_kf, :3, :3] @ pw[..., None])[..., 0] + poses[obs_kf, :3, 3]
    z = np.maximum(pc[:, 2], 0.1)
    uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    ur = uv[:, 0] - bf / z
    valid = (pc[:, 2] > 0.5) & (np.abs(uv[:, 0] - cx) < cx) \
        & (np.abs(uv[:, 1] - cy) < cy)
    valid = np.asarray(valid)
    slot = np.full((Lp, Wtot), -1, np.int64)
    for o in range(O):
        if not valid[o]:
            continue
        p, w = obs_pt[o], obs_kf[o]
        if slot[p, w] < 0:
            slot[p, w] = o
        else:
            valid[o] = False
    kf_fixed = np.zeros((Wtot,), bool)
    kf_fixed[0] = True
    arrays = {
        "kf_pose": poses, "kf_fixed": kf_fixed,
        "kf_valid": np.ones((Wtot,), bool),
        "pt_xyz": pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
        "pt_valid": np.ones((Lp,), bool),
        "obs_kf": obs_kf, "obs_pt": obs_pt,
        "obs_uv": uv.astype(np.float32),
        "obs_ur": np.where(valid, ur, -1.0).astype(np.float32),
        "obs_inv_sigma2": np.ones((O,), np.float32),
        "obs_valid": valid}
    return arrays, slot.astype(np.int32)


# the names the profiler gives the card's copies and sets (not kernels)
COPY_EVENTS = ("Memcpy", "Memset")


def cuda_launches(fn):
    """One call of fn on the card (torch.profiler): (its kernel launches,
    its memory copies and sets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.is_user_annotation]
    copies = sum(1 for n in names if n.startswith(COPY_EVENTS))
    return len(names) - copies, copies


def run(cfg, wtot=40, n=2048, lp=8192, device=None, reps=3, variants=None,
        launches=False, log=print):
    """Every variant (or those named in variants): its ms per call over
    reps calls after one warm call (reps 0: the one call timed), its last
    call's (kf_pose, pt_xyz) and
    final robust cost, and (launches=True, on the card) the kernel
    launches and the memory copies and sets of one call. Returns
    {"problem": (arrays, slot), name: {"ms", "kf_pose", "pt_xyz", "cost",
    "launches", "copies"}}."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.solvers.ba import _robust_cost, ba_iterate

    dev = resolve_device(device)
    K = Intrinsics.from_config(cfg.camera)
    arrays, slot_np = build_problem(K, wtot, n, lp)
    prob = interop.ba_problem_from_numpy(arrays, device=dev)
    slot = torch.from_numpy(slot_np.astype(np.int64)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"problem": (arrays, slot_np)}
    for name, blocked, with_slot, it, cg in VARIANTS:
        if variants is not None and name not in variants:
            continue
        def fn(it=it, cg=cg, bn=n if blocked else None,
               sl=slot if with_slot else None):
            return ba_iterate(K, prob, it, cg_iters=cg, block_n=bn,
                              pt_obs_slot=sl)
        t0 = time.perf_counter()
        res = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        if reps:
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn()
            sync()
            ms = (time.perf_counter() - t0) / reps * 1e3
        kf_pose, pt_xyz = res
        cost = float(_robust_cost(K, prob, kf_pose, pt_xyz, 5.991, 7.815,
                                  block_n=None))
        n_launch, n_copy = (cuda_launches(fn)
                            if launches and dev.type == "cuda"
                            else (None, None))
        out[name] = {"ms": ms, "kf_pose": kf_pose, "pt_xyz": pt_xyz,
                     "cost": cost, "launches": n_launch, "copies": n_copy}
        log(f"{name:44s} {ms:9.1f} ms")
        if n_launch is not None:
            log(f"{name:44s} {n_launch:9d} kernel launches per call "
                f"({n_copy} copies and sets)")
    return out


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args.wtot, args.n, args.lp,
               device=args.device, launches=args.print_launches,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
