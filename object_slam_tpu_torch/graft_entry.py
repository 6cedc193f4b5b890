"""Entry points: the tracking step on one card and a multi-rank dry run.

Counterpart of the repository root's __graft_entry__.py (the JAX
package's):

entry()             -> (fn, example_args): one forward step of the
                       pipeline's per-frame tracking chain (projection
                       search + robust GN pose solve) over the map state,
                       on tensors on the card (or ``device``);
dryrun_multichip(n) -> one sharded global-BA step over n ranks
                       (parallel/sharded_ba.py: observations split over
                       the ranks, the reduced camera system all-reduced).

    python -m object_slam_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_slam_tpu_torch.device import resolve_device


def _small_cfg():
    from object_slam_tpu_torch.config import (CapacityConfig, OrbConfig,
                                              SlamConfig)
    return SlamConfig(
        orb=OrbConfig(n_features=200, n_levels=4),
        caps=CapacityConfig(n_kp=256, max_points=2048, max_keyframes=32))


def _synth_tracking_inputs(device):
    """A last frame matched into a seeded point slab, and the current
    frame observing the same points from a moved camera."""
    from object_slam_tpu_torch.geometry import camera as cam_mod
    from object_slam_tpu_torch.geometry import se3
    from object_slam_tpu_torch.semantic.object2d import empty_slab
    from object_slam_tpu_torch.slam.frame import FrameData
    from object_slam_tpu_torch.slam.map_state import init_map

    cfg = _small_cfg()
    K = cam_mod.Intrinsics.from_config(cfg.camera)
    N = cfg.caps.n_kp
    rng = np.random.RandomState(0)
    pw = torch.as_tensor(rng.uniform([-2.0, -2.0, 2.0], [2.0, 2.0, 6.0],
                                     (N, 3)).astype(np.float32),
                         device=device)
    desc = torch.as_tensor(rng.randint(0, 2 ** 32, (N, 8), np.uint64)
                           .astype(np.uint32).view(np.int32), device=device)
    m = init_map(cfg.caps, cfg.objects.history_capacity, device=device)
    m.pt_xyz[:N] = pw
    m.pt_desc[:N] = desc
    m.pt_valid[:N] = True

    T_true = se3.exp(torch.tensor([0.05, 0.0, 0.02, 0.0, 0.01, 0.0],
                                  device=device))
    pc = se3.apply(T_true, pw[None])[0]
    uvr = cam_mod.project_stereo(K, pc)
    i32 = torch.int32
    frame = FrameData(
        timestamp=torch.tensor(0.0, device=device), uv_raw=uvr[:, :2],
        uv=uvr[:, :2], ur=uvr[:, 2], depth=pc[:, 2],
        level=torch.zeros(N, dtype=i32, device=device),
        angle=torch.zeros(N, device=device),
        response=torch.ones(N, device=device), desc=desc,
        valid=torch.ones(N, dtype=torch.bool, device=device),
        obj=empty_slab(cfg.semantic.max_instances, 48, 64, N,
                       device=device),
        obj3d=torch.full((cfg.semantic.max_instances,), -1, dtype=i32,
                         device=device),
        kp_pt=torch.full((N,), -1, dtype=i32, device=device),
        Tcw=torch.eye(4, device=device),
        pose_ok=torch.tensor(False, device=device))
    args = (m, frame, uvr[:, :2], torch.arange(N, dtype=i32, device=device),
            torch.zeros(N, dtype=i32, device=device),
            torch.ones(N, dtype=torch.bool, device=device),
            torch.eye(4, device=device))
    return cfg, K, args


def entry(device=None):
    """(fn, example_args): fn(*example_args) -> (Tcw [4, 4], n_inliers)."""
    from object_slam_tpu_torch.slam import tracking as trk
    device = resolve_device(device)
    cfg, K, args = _synth_tracking_inputs(device)
    sf = torch.tensor([cfg.orb.scale_factor ** l
                       for l in range(cfg.orb.n_levels)], device=device)
    inv_s2 = 1.0 / (sf * sf)

    def fn(m, frame, last_uv, last_pt, last_level, last_valid, T_pred):
        res = trk.track_motion_model(
            K, m, frame, last_uv, last_pt, last_level, last_valid,
            T_pred, sf, inv_s2)
        return res.Tcw, res.n_inliers

    return fn, args


def dryrun_problem(K, n_kf: int = 4, n_pt: int = 64):
    """A tiny BA problem (numpy fields, blocked layout: block_n = n_pt):
    n_kf identity cameras observing n_pt seeded points, the points moved
    by 1 cm."""
    rng = np.random.RandomState(0)
    pts = rng.uniform([-2.0, -2.0, 3.0], [2.0, 2.0, 6.0],
                      (n_pt, 3)).astype(np.float32)
    obs_kf = np.repeat(np.arange(n_kf, dtype=np.int32), n_pt)
    obs_pt = np.tile(np.arange(n_pt, dtype=np.int32), n_kf)
    pc = pts[obs_pt]
    z = np.maximum(pc[:, 2], 1e-6)
    uv = np.stack([K.fx * pc[:, 0] / z + K.cx,
                   K.fy * pc[:, 1] / z + K.cy], -1).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return {
        "kf_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                   (n_kf, 4, 4)).copy(),
        "kf_fixed": fixed, "kf_valid": np.ones(n_kf, bool),
        "pt_xyz": pts + np.float32(0.01), "pt_valid": np.ones(n_pt, bool),
        "obs_kf": obs_kf, "obs_pt": obs_pt, "obs_uv": uv,
        "obs_ur": (uv[:, 0] - K.bf / z).astype(np.float32),
        "obs_inv_sigma2": np.ones(n_kf * n_pt, np.float32),
        "obs_valid": np.ones(n_kf * n_pt, bool)}


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 300.0) -> None:
    """One sharded global-BA step (2 LM iterations, 8 CG) over n_devices
    spawned ranks: NCCL, one card each, on the card; gloo with
    device="cpu". Raises unless every rank returns the same finite
    result of the right shape."""
    from object_slam_tpu_torch.geometry import camera as cam_mod
    from object_slam_tpu_torch.parallel.sharded_ba import (
        spawn_sharded_global_ba)
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need as many cards; "
                         f"{torch.cuda.device_count()} found")
    K = cam_mod.Intrinsics.from_config(_small_cfg().camera)
    n_kf, n_pt = 4, 64
    outs = spawn_sharded_global_ba(
        K, dryrun_problem(K, n_kf, n_pt), n_devices, block_n=n_pt,
        n_iters=2, cg_iters=8, device=dev.type, timeout_s=timeout_s)
    for r, o in enumerate(outs):
        if (o["kf_pose"].shape != (n_kf, 4, 4)
                or o["pt_xyz"].shape != (n_pt, 3)):
            raise RuntimeError(f"rank {r}: shapes {o['kf_pose'].shape}, "
                               f"{o['pt_xyz'].shape}")
        if not (np.all(np.isfinite(o["kf_pose"]))
                and np.all(np.isfinite(o["pt_xyz"]))):
            raise RuntimeError(f"rank {r}: non-finite result")
        if not (np.array_equal(o["kf_pose"], outs[0]["kf_pose"])
                and np.array_equal(o["pt_xyz"], outs[0]["pt_xyz"])):
            raise RuntimeError(f"rank {r} disagrees with rank 0")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the card count, "
                         "2 on the CPU)")
    args = ap.parse_args()
    fn, ex = entry(args.device)
    Tcw, n_inl = fn(*ex)
    print("entry ok", tuple(Tcw.shape), int(n_inl))
    dev = resolve_device(args.device)
    n = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                       else 2)
    dryrun_multichip(n, device=args.device)
    print("dryrun ok")


if __name__ == "__main__":
    main()
