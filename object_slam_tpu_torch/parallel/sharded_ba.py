"""Multi-process bundle adjustment: observation-sharded Schur BA.

Counterpart of object_slam_tpu/parallel/sharded_ba.py. Poses and points
are replicated; the observation slab is split over the ranks of a
torch.distributed group at keyframe-block boundaries, so each rank keeps
the blocked [Kk, block_n] layout for its own keyframes and builds its own
per-point observation table (a departure from the reference, which
shards only the segment-sum form). The keyframes are dealt to the ranks
in the order of their live observation counts (shard_keyframes): a map
fills its keyframe slots from the front, and contiguous ranges would
leave the last ranks nothing to do. Every reduction of solvers/ba.py's
``ba_iterate`` goes through ``ObsShard``: the per-keyframe sums (a
keyframe's observations all lie on one rank, so these are exact), the
per-point sums and the cost, packed into one all-reduce where they are
computed together. The dense per-point 3x3 inverses and the CG over the
reduced camera system run replicated on every rank.

One rank gives the single-process result bit for bit. More ranks sum the
per-point partial sums and the cost in another order.

On a host with several cards, one rank per card under torchrun:

    torchrun --nproc_per_node 4 -m object_slam_tpu_torch.parallel.sharded_ba \
        [--problem PROB.npz --block-n 1024] [--iters 10]

(PROB.npz: interop.ba_problem_to_numpy's fields of a TUM-VGA problem;
without it, graft_entry's dry-run problem.)
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from object_slam_tpu_torch.parallel.distributed import (
    global_group, maybe_initialize_distributed)
from object_slam_tpu_torch.solvers.ba import BAProblem, global_ba


def pad_obs_to(prob: BAProblem, multiple: int, block_n: int) -> BAProblem:
    """Append whole keyframe blocks (an identity pose, fixed and invalid,
    and block_n invalid observations each) until the keyframe count is a
    multiple of ``multiple``."""
    Kk = prob.kf_pose.shape[0]
    pad = (-Kk) % multiple
    if pad == 0:
        return prob
    dev = prob.kf_pose.device

    def cat(a, fill, n):
        return torch.cat([a, torch.full((n,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=dev)])

    n_obs = pad * block_n
    eye = torch.eye(4, dtype=prob.kf_pose.dtype, device=dev).expand(
        pad, 4, 4)
    return prob._replace(
        kf_pose=torch.cat([prob.kf_pose, eye]),
        kf_fixed=cat(prob.kf_fixed, True, pad),
        kf_valid=cat(prob.kf_valid, False, pad),
        obs_kf=torch.cat([prob.obs_kf, torch.repeat_interleave(
            torch.arange(Kk, Kk + pad, dtype=prob.obs_kf.dtype,
                         device=dev), block_n)]),
        obs_pt=cat(prob.obs_pt, 0, n_obs),
        obs_uv=cat(prob.obs_uv, 0.0, n_obs),
        obs_ur=cat(prob.obs_ur, -1.0, n_obs),
        obs_inv_sigma2=cat(prob.obs_inv_sigma2, 0.0, n_obs),
        obs_valid=cat(prob.obs_valid, False, n_obs))


def shard_keyframes(prob: BAProblem, world: int, rank: int,
                    block_n: int) -> torch.Tensor:
    """rank's keyframes, ascending: every keyframe ordered by its live
    observations (most first, ties by index) and dealt round-robin, so
    each rank holds as many keyframe blocks (n_kf a multiple of world) and
    about as many live observations. Every rank computes the same deal
    from the same problem."""
    n_kf = prob.kf_pose.shape[0]
    live = (prob.obs_valid & prob.kf_valid[prob.obs_kf.long()]
            & prob.pt_valid[prob.obs_pt.long()])
    order = torch.argsort(-live.reshape(n_kf, block_n).sum(1), stable=True)
    return torch.sort(order[rank::world]).values


def shard_problem(prob: BAProblem, kf_ids, block_n: int) -> BAProblem:
    """prob with the observation slab cut to the blocks of kf_ids."""
    n_kf = prob.kf_pose.shape[0]

    def take(a):
        return a.reshape((n_kf, block_n) + a.shape[1:])[kf_ids].reshape(
            (-1,) + a.shape[1:])
    return prob._replace(
        obs_kf=take(prob.obs_kf), obs_pt=take(prob.obs_pt),
        obs_uv=take(prob.obs_uv), obs_ur=take(prob.obs_ur),
        obs_inv_sigma2=take(prob.obs_inv_sigma2),
        obs_valid=take(prob.obs_valid))


class ObsShard:
    """ba_iterate's all-reduce hook for the blocks of keyframes kf_ids
    (ascending) of n_kf."""

    def __init__(self, group, kf_ids, n_kf: int):
        self.group, self.kf_ids, self.n_kf = group, kf_ids, n_kf
        self.world = dist.get_world_size(group)

    def reduce(self, kf=(), pt=(), cost=()):
        """Sum over the ranks in one all-reduce: kf, this rank's
        per-keyframe rows (placed at rows kf_ids of n_kf, zero elsewhere);
        pt, per-point partial sums; cost, 0-d partial sums. Returns the
        three lists, reduced."""
        parts = []
        for x in kf:
            full = x.new_zeros((self.n_kf,) + x.shape[1:])
            full[self.kf_ids] = x
            parts.append(full)
        parts += list(pt) + list(cost)
        flat = torch.cat([p.reshape(-1) for p in parts])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for p in parts:
            # a fresh tensor, as the unsharded solver has: a view into the
            # packed buffer could change which library kernel runs next
            out.append(flat[at:at + p.numel()].reshape(p.shape).clone())
            at += p.numel()
        nk, npt = len(kf), len(pt)
        return out[:nk], out[nk:nk + npt], out[nk + npt:]

    def agree(self, flag) -> bool:
        """A host branch taken by every rank: raises if the ranks' flags
        (computed from replicated values) differ instead of letting their
        collectives part."""
        t = torch.as_tensor(flag).to(torch.float32).reshape(1)
        dist.all_reduce(t, group=self.group)
        n = int(t.item())
        if n not in (0, self.world):
            raise RuntimeError(f"sharded BA: {n} of {self.world} ranks "
                               f"took a branch the others did not")
        return n == self.world


def make_sharded_ba(K, group=None, n_iters: int = 10, cg_iters: int = 24,
                    *, block_n: int):
    """fn(prob) -> (kf_pose, pt_xyz): global BA with the observations
    sharded over group's ranks (default: the global group) and the state
    replicated. Every rank passes the whole problem and gets the whole
    result."""
    group = group if group is not None else global_group()
    if group is None:
        raise RuntimeError("sharded BA needs a process group: call "
                           "maybe_initialize_distributed first")
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def fn(prob: BAProblem):
        n_kf = prob.kf_pose.shape[0]
        padded = pad_obs_to(prob, world, block_n)
        kf_ids = shard_keyframes(padded, world, rank, block_n)
        comm = ObsShard(group, kf_ids, padded.kf_pose.shape[0])
        kf_pose, pt_xyz = global_ba(
            K, shard_problem(padded, kf_ids, block_n), n_iters,
            block_n=block_n, comm=comm, cg_iters=cg_iters)
        return kf_pose[:n_kf], pt_xyz

    return fn


def run_sharded_global_ba(K, prob: BAProblem, n_iters: int = 10, *,
                          block_n: int, group=None, cg_iters: int = 24):
    """Global BA over an initialized group of any size (1 included)."""
    return make_sharded_ba(K, group, n_iters, cg_iters,
                           block_n=block_n)(prob)


def _rank_main(rank, world, backend, device, init, K, arrays, block_n,
               n_iters, cg_iters, reps, out_dir, setup):
    from object_slam_tpu_torch import interop
    if device == "cpu":
        torch.set_num_threads(1)
    maybe_initialize_distributed(init, world, rank, device=device,
                                 backend=backend)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if device == "cuda" else torch.device(device))
        if setup is not None:
            setup(rank, world)
        prob = interop.ba_problem_from_numpy(arrays, device=dev)
        padded = pad_obs_to(prob, world, block_n)
        mine = shard_problem(padded, shard_keyframes(padded, world, rank,
                                                     block_n), block_n)
        live = int((mine.obs_valid & padded.kf_valid[mine.obs_kf.long()]
                    & padded.pt_valid[mine.obs_pt.long()]).sum())
        ms = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            kf_pose, pt_xyz = run_sharded_global_ba(
                K, prob, n_iters, block_n=block_n, cg_iters=cg_iters)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 kf_pose=kf_pose.cpu().numpy(), pt_xyz=pt_xyz.cpu().numpy(),
                 ms=np.asarray(ms), live=live)
    finally:
        dist.destroy_process_group()


def spawn_sharded_global_ba(K, arrays, world: int, *, block_n: int,
                            n_iters: int = 10, cg_iters: int = 24,
                            device: str = "cuda", backend=None,
                            timeout_s: float = 300.0, reps: int = 1,
                            setup=None):
    """Run the sharded global BA in ``world`` processes started with the
    spawn method (a process that has touched CUDA cannot fork), each
    handed the whole problem (interop.ba_problem_to_numpy's arrays).
    device: "cuda" (rank r on card r modulo the count), "cuda:0" (every
    rank on one card: gloo, since NCCL refuses two ranks on one card) or
    "cpu". setup(rank, world), a module-level function, runs in each rank
    first. Raises if a rank fails or the ranks take longer than
    timeout_s. Returns per rank {"kf_pose", "pt_xyz", "ms", "live"} (ms:
    the synchronized wall time of each of reps runs; live: the live
    observations of the rank's shard)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        init = "file://" + os.path.join(out_dir, "store")
        ctx = mp.start_processes(
            _rank_main, args=(world, backend, device, init, K, dict(arrays),
                              block_n, n_iters, cg_iters, reps, out_dir,
                              setup),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"sharded BA over {world} ranks did not finish in "
                        f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out


def main():
    ap = argparse.ArgumentParser(
        description="global BA over the ranks torchrun starts")
    ap.add_argument("--problem", default=None,
                    help="npz of interop.ba_problem_to_numpy's fields "
                         "(SlamConfig.tum_rgbd()'s camera)")
    ap.add_argument("--block-n", type=int, default=None,
                    help="observation slots per keyframe of --problem")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu: gloo)")
    args = ap.parse_args()
    from object_slam_tpu_torch import graft_entry, interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    if not maybe_initialize_distributed(device=args.device):
        raise SystemExit("no process group configured: run under torchrun")
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl"
               else torch.device(args.device or "cpu"))
        if args.problem:
            K = Intrinsics.from_config(SlamConfig.tum_rgbd().camera)
            with np.load(args.problem) as z:
                arrays = {k: z[k] for k in z.files}
            block_n = args.block_n
        else:
            K = Intrinsics.from_config(graft_entry._small_cfg().camera)
            arrays, block_n = graft_entry.dryrun_problem(K), 64
        prob = interop.ba_problem_from_numpy(arrays, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        kf_pose, pt_xyz = run_sharded_global_ba(K, prob, args.iters,
                                                block_n=block_n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"rank {dist.get_rank()} of {dist.get_world_size()} "
              f"({dist.get_backend()}, {dev}): global BA over "
              f"{prob.kf_pose.shape[0]} keyframes in {ms:.1f} ms; poses "
              f"finite {bool(torch.isfinite(kf_pose).all())}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
