"""Pose-only optimization: Levenberg-Marquardt with Huber IRLS.

Counterpart of object_slam_tpu/solvers/pose_opt.py: the reference's 4x10
schedule with chi2 re-gating between rounds (Optimizer.cc:239-451), the
cost-gated LM step, and the dual-init basin pick (pose_optimize_best).
The ``while_loop`` / ``fori_loop`` become Python loops; the early exit of
each round reads one device scalar per LM step.

Residual convention (g2o's): e = obs - project(T p), J = de/dxi with the
left-multiplicative update T <- exp(xi) T.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.geometry.camera import Intrinsics


class PoseObs(NamedTuple):
    """uv [N, 2]; ur [N] (< 0 mono edge); pw [N, 3]; inv_sigma2 [N];
    valid [N] bool."""

    uv: torch.Tensor
    ur: torch.Tensor
    pw: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor


def reproj_residual_jac(K: Intrinsics, Tcw, obs: PoseObs):
    """Returns (r [N, 3], J [N, 3, 6], stereo_mask [N], z [N])."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = obs.pw @ R.T + t
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz

    u = K.fx * x * iz + K.cx
    v = K.fy * y * iz + K.cy
    ur = u - K.bf * iz

    stereo = obs.ur >= 0.0
    zero = torch.zeros_like(z)
    r = torch.stack([obs.uv[..., 0] - u, obs.uv[..., 1] - v,
                     torch.where(stereo, obs.ur - ur, zero)], dim=-1)

    du = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], -1)
    dv = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], -1)
    dur = du + torch.stack([zero, zero, K.bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(stereo[..., None], dur,
                                             torch.zeros_like(dur))], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    dpc = torch.cat([eye, -se3.hat(pc)], dim=-1)
    J = -(dproj @ dpc)
    return r, J, stereo, pc[..., 2]


def edge_chi2(r, inv_sigma2, stereo):
    e2 = torch.where(stereo, torch.sum(r * r, dim=-1),
                     r[..., 0] ** 2 + r[..., 1] ** 2)
    return e2 * inv_sigma2


def huber_weight(chi2, delta2):
    a = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = torch.sqrt(torch.as_tensor(delta2, dtype=chi2.dtype,
                                   device=chi2.device))
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), d / a)


def robust_cost(chi2, delta2, active):
    rho = torch.where(chi2 <= delta2, chi2,
                      2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=1e-12))
                      - delta2)
    return torch.sum(torch.where(active, rho, torch.zeros_like(rho)))


def _delta2(stereo, chi2_mono, chi2_stereo):
    return torch.where(stereo, torch.full(stereo.shape, chi2_stereo,
                                          device=stereo.device),
                       torch.full(stereo.shape, chi2_mono,
                                  device=stereo.device))


def _lm_step(K, Tcw, lam, obs, active, chi2_mono, chi2_stereo):
    """One LM step with cost-gated acceptance. Returns (T, lam, converged)
    with lam and converged as device scalars."""
    r, J, stereo, z = reproj_residual_jac(K, Tcw, obs)
    ok = active & obs.valid & (z > 0)
    chi2 = edge_chi2(r, obs.inv_sigma2, stereo)
    delta2 = _delta2(stereo, chi2_mono, chi2_stereo)
    cost0 = robust_cost(chi2, delta2, ok)
    w = huber_weight(chi2, delta2) * obs.inv_sigma2
    w = torch.where(ok, w, torch.zeros_like(w))

    Jw = J * w[..., None, None]
    H = torch.einsum('nij,nik->jk', Jw, J)
    b = -torch.einsum('nij,ni->j', Jw, r)
    dH = torch.diagonal(H)
    Hd = H + torch.diag(lam * dH + 1e-8)
    dx = torch.linalg.solve(Hd, b)
    T2 = se3.retract(Tcw, dx)

    r2, _, stereo2, z2 = reproj_residual_jac(K, T2, obs)
    chi2_2 = edge_chi2(r2, obs.inv_sigma2, stereo2)
    cost1 = robust_cost(chi2_2, delta2, active & obs.valid & (z2 > 0))

    good = (cost1 < cost0) & torch.all(torch.isfinite(dx))
    Tn = torch.where(good, T2, Tcw)
    lam_n = torch.where(good, torch.clamp(lam * 0.5, min=1e-9),
                        torch.clamp(lam * 4.0, max=1e6))
    converged = good & (cost1 > cost0 * (1.0 - 1e-4))
    return Tn, lam_n, converged


def pose_optimize(K: Intrinsics, Tcw0, obs: PoseObs,
                  rounds: int = 4, iters_per_round: int = 10,
                  chi2_mono: float = 5.991, chi2_stereo: float = 7.815,
                  damping: float = 1e-3):
    """4x10 LM with inter-round chi2 re-gating. Returns (Tcw, inlier_mask,
    n_inliers)."""
    Tcw = Tcw0
    lam = torch.tensor(damping, dtype=torch.float32, device=Tcw0.device)
    active = obs.valid
    for _ in range(rounds):
        for _ in range(iters_per_round):
            Tcw, lam, conv = _lm_step(K, Tcw, lam, obs, active,
                                      chi2_mono, chi2_stereo)
            if bool(conv):
                break
        r, _, stereo, z = reproj_residual_jac(K, Tcw, obs)
        chi2 = edge_chi2(r, obs.inv_sigma2, stereo)
        gate = _delta2(stereo, chi2_mono, chi2_stereo)
        active = obs.valid & (chi2 <= gate) & (z > 0)
    return Tcw, active, torch.sum(active.to(torch.int32))


def pose_optimize_best(K: Intrinsics, inits, obs: PoseObs,
                       rounds: int = 4, iters_per_round: int = 10,
                       chi2_mono: float = 5.991, chi2_stereo: float = 7.815):
    """Run the full schedule from each [M, 4, 4] init; keep the lowest
    robust cost (minus a 0.5-per-inlier bonus; edges behind the camera
    charged 8 delta^2)."""
    best = None
    for m in range(inits.shape[0]):
        Tcw, active, n = pose_optimize(
            K, inits[m], obs, rounds=rounds, iters_per_round=iters_per_round,
            chi2_mono=chi2_mono, chi2_stereo=chi2_stereo)
        r, _, stereo, z = reproj_residual_jac(K, Tcw, obs)
        chi2 = edge_chi2(r, obs.inv_sigma2, stereo)
        delta2 = _delta2(stereo, chi2_mono, chi2_stereo)
        cost = robust_cost(chi2, delta2, obs.valid & (z > 0))
        cost = cost + torch.sum(torch.where(obs.valid & (z <= 0),
                                            8.0 * delta2,
                                            torch.zeros_like(delta2)))
        score = cost - 0.5 * n.to(cost.dtype)
        # argmin keeps the FIRST minimum: a later init must be strictly
        # better to win
        if best is None or bool(score < best[0]):
            best = (score, Tcw, active, n)
    return best[1], best[2], best[3]
