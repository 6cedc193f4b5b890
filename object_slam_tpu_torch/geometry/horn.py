"""Horn 1987 closed-form absolute orientation (Sim3 / SE3 alignment).

Counterpart of object_slam_tpu/geometry/horn.py (Sim3Solver.cc:226-284):
the rotation is the top eigenvector of Horn's symmetric 4x4 N matrix,
batched over leading dims so one ``torch.linalg.eigh`` solves every RANSAC
hypothesis at once. q and -q give the same R, so the eigenvector's sign
does not matter.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.geometry.sim3 import _assemble


def horn_align(p_src, p_dst, weights=None, fix_scale: bool = False):
    """(T [..., 4, 4], s [...]) minimizing || p_dst - (s R p_src + t) ||^2
    over [..., N, 3] correspondences, optionally weighted [..., N];
    fix_scale: s = 1 (stereo / RGB-D)."""
    if weights is None:
        weights = torch.ones(p_src.shape[:-1], dtype=p_src.dtype,
                             device=p_src.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    w = (weights / wsum)[..., None]

    mu_s = torch.sum(w * p_src, dim=-2, keepdim=True)
    mu_d = torch.sum(w * p_dst, dim=-2, keepdim=True)
    xs = p_src - mu_s
    xd = p_dst - mu_d

    M = torch.einsum('...ni,...nj->...ij', w[..., 0][..., None] * xs, xd)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]            # largest eigenvalue: (w, x, y, z)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                     2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)

    Rxs = torch.einsum('...ij,...nj->...ni', R, xs)
    num = torch.sum(w[..., 0] * torch.sum(xd * Rxs, dim=-1), dim=-1)
    den = torch.clamp(torch.sum(w[..., 0] * torch.sum(xs * xs, dim=-1),
                                dim=-1), min=1e-12)
    s = torch.ones_like(num) if fix_scale else num / den
    t = mu_d[..., 0, :] - s[..., None] * torch.einsum(
        '...ij,...j->...i', R, mu_s[..., 0, :])
    return _assemble(R, t), s
