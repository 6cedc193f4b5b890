"""Trajectory evaluation: ATE (Horn-aligned RMSE).

A numpy copy of the ATE part of object_slam_tpu/eval/ate.py (the port
imports nothing of the JAX package).

Math parity with the TUM benchmark tool the reference evaluates with
(`ExpResults/TUM/Localization/evaluate_ate.py`: Horn SVD alignment + RMSE of
translational differences). Host-side numpy — this is offline tooling.
"""

from __future__ import annotations

import numpy as np


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
