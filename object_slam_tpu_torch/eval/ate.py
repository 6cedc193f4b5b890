"""Trajectory evaluation: ATE (Horn-aligned RMSE) and RPE.

A numpy copy of object_slam_tpu/eval/ate.py (the port imports nothing of
the JAX package).

Math parity with the TUM benchmark tools the reference evaluates with
(`ExpResults/TUM/Localization/evaluate_ate.py`: Horn SVD alignment + RMSE of
translational differences; `evaluate_rpe.py`: relative pose deltas over a
fixed frame distance). Host-side numpy — this is offline tooling.
"""

from __future__ import annotations

import numpy as np


def associate_timestamps(ts_a, ts_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (the benchmark's associate.py)."""
    pairs = []
    used_b = set()
    b_sorted = np.argsort(ts_b)
    tsb = np.asarray(ts_b)[b_sorted]
    for ia, t in enumerate(ts_a):
        j = np.searchsorted(tsb, t)
        best, bestd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(tsb):
                d = abs(tsb[jj] - t)
                if d <= bestd and b_sorted[jj] not in used_b:
                    best, bestd = b_sorted[jj], d
        if best >= 0:
            used_b.add(best)
            pairs.append((ia, best))
    return pairs


def align_horn_svd(model, data):
    """SVD absolute orientation: find R, t with data ~ R model + t.
    model, data: [3, N]. Returns (R [3,3], t [3,1], trans_error [N])."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = mz @ dz.T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    t = mu_d - R @ mu_m
    aligned = R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, err


def ate_rmse(est_xyz, gt_xyz):
    """est_xyz, gt_xyz: [N, 3] associated positions. Returns RMSE meters."""
    _, _, err = align_horn_svd(est_xyz.T, gt_xyz.T)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_poses, gt_poses, delta: int = 1, tracked=None):
    """Relative pose error over a fixed frame delta.

    est_poses, gt_poses: [N, 4, 4] camera-to-world. tracked: optional [N]
    bool; pairs including an untracked frame are left out (a LOST frame
    repeats the last good pose). Returns translational / rotational RMSE
    and medians."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = min(len(est), len(gt)) - delta
    terr, rerr = [], []
    for i in range(n):
        if tracked is not None and not (tracked[i] and tracked[i + delta]):
            continue
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        ang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(ang)))
    return {
        "trans_rmse": float(np.sqrt(np.mean(np.square(terr)))) if terr else 0.0,
        "rot_rmse_deg": float(np.sqrt(np.mean(np.square(rerr)))) if rerr else 0.0,
        "trans_median": float(np.median(terr)) if terr else 0.0,
        "rot_median_deg": float(np.median(rerr)) if rerr else 0.0,
    }
