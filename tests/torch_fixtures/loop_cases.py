"""Seeded numpy inputs for the loop-closing parity tests.

``loop_map`` is tests/test_loop.py::make_loop_map drawn with numpy: KF0
(the loop target) and KF5 (the query) observe the same 120 points, but
the query's copy of the points and its pose carry a drift; KF1-4 chain
KF0's view. It is returned as the reference map's numpy fields, which
both packages load (the JAX MapState directly, the port's through
interop.map_state_from_numpy).
"""

from __future__ import annotations

import numpy as np


def _se3_exp_np(xi):
    """float64 SE3 exp of a twist [rho, phi] (phi about y only here)."""
    rho, phi = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]])
    if th < 1e-12:
        R, V = np.eye(3), np.eye(3)
    else:
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th ** 2 * K @ K)
        V = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * K
             + (th - np.sin(th)) / th ** 3 * K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def loop_map(base: dict, fx, fy, cx, cy, bf, drift=0.3, seed=0, n=120,
             n_kf=6):
    """base: the reference init_map's numpy fields (uint32 descriptors).
    Returns (fields, T_true [n_kf, 4, 4], Tq_est [4, 4])."""
    rng = np.random.RandomState(seed)
    m = {k: np.array(v) for k, v in base.items()}
    pw = rng.uniform([-2.0, -2.0, 3.0], [2.0, 2.0, 6.0],
                     (n, 3)).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n, 8), np.uint64).astype(np.uint32)
    drift_vec = np.array([drift, 0.0, 0.0], np.float32)
    pw_drift = (pw + drift_vec).astype(np.float32)
    T_true = np.stack([_se3_exp_np([0.05 * i, 0, 0, 0, 0.02 * i, 0])
                       for i in range(n_kf)]).astype(np.float32)
    Tw = np.eye(4, dtype=np.float32)
    Tw[:3, 3] = -drift_vec
    Tq_est = (T_true[0] @ Tw).astype(np.float32)

    m["pt_xyz"][:n] = pw
    m["pt_xyz"][n:2 * n] = pw_drift
    m["pt_desc"][:n] = desc
    m["pt_desc"][n:2 * n] = desc
    m["pt_valid"][:2 * n] = True
    m["pt_ref_kf"][:n] = 0
    m["pt_ref_kf"][n:2 * n] = n_kf - 1
    m["n_pt"] = np.int32(2 * n)
    for i in range(n_kf):
        pose = T_true[i] if i < n_kf - 1 else Tq_est
        src = pw if i < n_kf - 1 else pw_drift
        pts = np.arange(n) if i < n_kf - 1 else np.arange(n, 2 * n)
        pc = src @ pose[:3, :3].T + pose[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = fx * pc[:, 0] / z + cx
        v = fy * pc[:, 1] / z + cy
        m["kf_pose"][i] = pose
        m["kf_valid"][i] = True
        m["kf_parent"][i] = i - 1
        m["kf_kp_uv"][i, :n] = np.stack([u, v], -1)
        m["kf_kp_ur"][i, :n] = u - bf / z
        m["kf_kp_desc"][i, :n] = desc
        m["kf_kp_valid"][i, :n] = True
        m["kf_kp_pt"][i, :n] = pts
    m["n_kf"] = np.int32(n_kf)
    return m, T_true, Tq_est


def pose_graph_case(seed=0, n_kf=6):
    """A chain of n_kf Sim3 vertices (s = 1) with odometry edges measured
    from noise-free poses, initial values drifted, and a loop edge from
    the last vertex to the first: (T0 [K, 4, 4], s0 [K], ei, ej, rel_T,
    rel_s, valid, fixed)."""
    rng = np.random.RandomState(seed)
    T_true = np.stack([_se3_exp_np([0.3 * i, 0.02 * i, 0.1 * np.sin(i),
                                    0.0, 0.25 * i, 0.01 * i])
                       for i in range(n_kf)])
    T0 = T_true.copy()
    for i in range(1, n_kf):
        T0[i] = _se3_exp_np(np.r_[rng.normal(0, 0.02, 3),
                                  rng.normal(0, 0.01, 3)] * i) @ T_true[i]
    ei = np.r_[np.arange(n_kf - 1), 0]
    ej = np.r_[np.arange(1, n_kf), n_kf - 1]
    rel_T = np.stack([T_true[j] @ np.linalg.inv(T_true[i])
                      for i, j in zip(ei, ej)])
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return (T0.astype(np.float32), np.ones(n_kf, np.float32),
            ei.astype(np.int32), ej.astype(np.int32),
            rel_T.astype(np.float32), np.ones(len(ei), np.float32),
            np.ones(len(ei), bool), fixed)


def ba_case(seed=0, n_kf=5, block_n=64, n_pt=60, fx=520.9, fy=521.0,
            cx=325.1, cy=249.7):
    """A small global-BA problem in the blocked layout: n_kf keyframes of
    block_n observation slots, n_pt points, noisy poses and points.
    Returns numpy BAProblem fields."""
    rng = np.random.RandomState(seed)
    pw = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0],
                     (n_pt, 3)).astype(np.float32)
    T = np.stack([_se3_exp_np([0.1 * i, 0.0, 0.02 * i, 0.0, 0.03 * i, 0.0])
                  for i in range(n_kf)]).astype(np.float32)
    obs_pt = np.zeros((n_kf, block_n), np.int32)
    obs_uv = np.zeros((n_kf, block_n, 2), np.float32)
    obs_valid = np.zeros((n_kf, block_n), bool)
    for k in range(n_kf):
        sel = rng.choice(n_pt, block_n - 4, replace=False)
        pc = pw[sel] @ T[k, :3, :3].T + T[k, :3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        obs_pt[k, :len(sel)] = sel
        obs_uv[k, :len(sel)] = uv + rng.normal(0, 0.5, uv.shape)
        obs_valid[k, :len(sel)] = True
    T_noisy = T.copy()
    for k in range(1, n_kf):
        T_noisy[k] = (_se3_exp_np(np.r_[rng.normal(0, 0.01, 3),
                                        rng.normal(0, 0.005, 3)])
                      @ T[k]).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return dict(
        kf_pose=T_noisy, kf_fixed=fixed, kf_valid=np.ones(n_kf, bool),
        pt_xyz=(pw + rng.normal(0, 0.02, pw.shape)).astype(np.float32),
        pt_valid=np.ones(n_pt, bool),
        obs_kf=np.repeat(np.arange(n_kf, dtype=np.int32), block_n),
        obs_pt=obs_pt.reshape(-1), obs_uv=obs_uv.reshape(-1, 2),
        obs_ur=np.full(n_kf * block_n, -1.0, np.float32),
        obs_inv_sigma2=np.ones(n_kf * block_n, np.float32),
        obs_valid=obs_valid.reshape(-1))
