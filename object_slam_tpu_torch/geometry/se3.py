"""SE(3) Lie-group operations on ``[..., 4, 4]`` float32 tensors.

Counterpart of object_slam_tpu/geometry/se3.py: poses are world->camera
``Tcw`` matrices; twists are xi = [rho(3), phi(3)] (translation first), the
g2o SE3Quat ordering. All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v):
    """Skew-symmetric matrix of [..., 3] vectors -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(phi):
    """Rodrigues: [..., 3] rotation vector -> [..., 3, 3] rotation matrix,
    with the same Taylor branches as the reference."""
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    ts = torch.sqrt(torch.clamp(t2, min=1e-12))
    A = torch.where(t2 < 1e-8, 1.0 - t2 / 6.0, torch.sin(ts) / ts)
    B = torch.where(t2 < 1e-8, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(ts)) / torch.clamp(t2, min=1e-12))
    K = hat(phi)
    return _eye3(phi) + A * K + B * (K @ K)


def so3_log(R):
    """[..., 3, 3] rotation matrix -> [..., 3] rotation vector."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    near_id = cos_theta > 1.0 - 1e-6
    safe_cos = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sqrt(torch.clamp(1.0 - safe_cos * safe_cos, min=_EPS))
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    scale = torch.where(near_id, 0.5 + (1.0 - cos_theta) / 6.0,
                        theta / (2.0 * sin_theta))
    return w * scale[..., None]


def _left_jacobian(phi):
    """SO(3) left Jacobian J_l(phi), [..., 3, 3]."""
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    ts = torch.sqrt(torch.clamp(t2, min=1e-12))
    K = hat(phi)
    A = torch.where(t2 < 1e-8, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(ts)) / torch.clamp(t2, min=_EPS))
    B = torch.where(t2 < 1e-8, 1.0 / 6.0 - t2 / 120.0,
                    (ts - torch.sin(ts)) / torch.clamp(t2 * ts, min=_EPS))
    return _eye3(phi) + A * K + B * (K @ K)


def _assemble(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp(xi):
    """se(3) twist [..., 6] (rho, phi) -> [..., 4, 4] transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return _assemble(R, t)


def log(T):
    """[..., 4, 4] transform -> [..., 6] twist (rho, phi).

    The reference solves J_l(phi) rho = t; here the inverse left Jacobian
    is in closed form, J_l^-1 = I - K / 2 + c K^2 with c = (1 - theta sin
    / (2 (1 - cos))) / theta^2, so no batched LU (whose info check syncs
    the card) runs per call: the pose graph takes 280 of these per solve.
    Below theta = 0.1, c is its series 1/12 + theta^2/720 + theta^4/30240
    (the next term is below 1e-12), since f32 loses 1 - cos there."""
    phi = so3_log(T[..., :3, :3])
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = t2 < 1e-2
    safe = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(safe)
    c_big = (1.0 - th * torch.sin(th)
             / (2.0 * (1.0 - torch.cos(th)))) / safe
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                    c_big)
    K = hat(phi)
    Jinv = _eye3(phi) - 0.5 * K + c * (K @ K)
    rho = (Jinv @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _assemble(Rt, -(Rt @ t[..., None])[..., 0])


def compose(A, B):
    return A @ B


def apply(T, p):
    """Transform points: [..., 4, 4] x [..., N, 3] -> [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return p @ R.transpose(-1, -2) + t[..., None, :]


def orthonormalize(T):
    """One Newton sweep of the symmetric polar factor on the rotation
    block: R <- R (3 I - R^T R) / 2."""
    R = T[..., :3, :3]
    RtR = R.transpose(-1, -2) @ R
    R = R @ (1.5 * _eye3(T) - 0.5 * RtR)
    out = T.clone()
    out[..., :3, :3] = R
    return out


def retract(T, xi):
    """Left-multiplicative update exp(xi) * T, re-projected onto SE(3)."""
    return orthonormalize(exp(xi) @ T)
