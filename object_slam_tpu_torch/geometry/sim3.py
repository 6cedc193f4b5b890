"""Sim(3) operations for loop closing and 7-DoF pose-graph optimization.

Counterpart of object_slam_tpu/geometry/sim3.py. A similarity is a pair
``(T [..., 4, 4], s [...])`` acting as p' = s R p + t; the tangent is
7-dim [rho(3), phi(3), sigma(1)] with s = exp(sigma). The matrices are
assembled without in-place writes, so every function here runs under
``torch.func.jacfwd`` / ``vmap`` (the pose graph and the Sim3
Gauss-Newton take their Jacobians that way, as the reference takes
``jax.jacfwd``).
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.geometry import se3


def _assemble(R, t):
    """[..., 3, 3] and [..., 3] -> [..., 4, 4] (functional)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom = bottom + torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                                   device=R.device)
    return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None):
    T = torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4)).clone()
    return T, torch.ones(batch_shape, dtype=dtype, device=device)


def apply(T, s, p):
    """p' = s R p + t, points [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return s[..., None, None] * (p @ R.transpose(-1, -2)) + t[..., None, :]


def compose(Ta, sa, Tb, sb):
    """(Ta, sa) o (Tb, sb): first apply b, then a."""
    Ra, ta = Ta[..., :3, :3], Ta[..., :3, 3]
    Rb, tb = Tb[..., :3, :3], Tb[..., :3, 3]
    R = Ra @ Rb
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return _assemble(R, t), sa * sb


def inverse(T, s):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    si = 1.0 / s
    return _assemble(Rt, -si[..., None] * (Rt @ t[..., None])[..., 0]), si


def exp(xi):
    """7-dim tangent [rho, phi, sigma] -> (T, s): the SE3 exp of (rho,
    phi) and the scale separately (the reference's small-step form)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = se3.so3_exp(phi)
    t = (se3._left_jacobian(phi) @ rho[..., None])[..., 0]
    return _assemble(R, t), torch.exp(xi[..., 6])


def log(T, s):
    return torch.cat([se3.log(T), torch.log(s)[..., None]], dim=-1)


def retract(T, s, xi):
    dT, ds = exp(xi)
    Tn, sn = compose(dT, ds, T, s)
    return se3.orthonormalize(Tn), sn


def error(Ta, sa, Tb, sb):
    """log((Ta, sa) o (Tb, sb)^-1), the 7-dim relative error."""
    Tbi, sbi = inverse(Tb, sb)
    Te, se_ = compose(Ta, sa, Tbi, sbi)
    return log(Te, se_)
