"""Two-view triangulation (batched DLT) with the reference's gates.

Counterpart of object_slam_tpu/geometry/triangulation.py. The null vector
of the 4x4 DLT system comes from a batched ``torch.linalg.eigh`` of A^T A;
the eigenvector's sign is arbitrary, and it cancels in the divide by w.
"""

from __future__ import annotations

import torch


def triangulate_dlt(P1, P2, xn1, xn2):
    """P1, P2: [3, 4]; xn1, xn2: [..., 2] -> [..., 3] points."""
    A0 = xn1[..., 0:1] * P1[2] - P1[0]
    A1 = xn1[..., 1:2] * P1[2] - P1[1]
    A2 = xn2[..., 0:1] * P2[2] - P2[0]
    A3 = xn2[..., 1:2] * P2[2] - P2[1]
    A = torch.stack([A0, A1, A2, A3], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    _, v = torch.linalg.eigh(AtA)
    X = v[..., :, 0]
    w4 = X[..., 3]
    w4 = torch.where(torch.abs(w4) < 1e-10, torch.full_like(w4, 1e-10), w4)
    return X[..., :3] / w4[..., None]


def parallax_cos(pw, c1, c2):
    r1 = pw - c1
    r2 = pw - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-9)


def triangulate_two_view(K, T1w, T2w, uv1, uv2,
                         reproj_chi2: float = 5.991,
                         min_parallax_cos: float = 0.9998):
    """Triangulate [N, 2] undistorted matches between two cameras.
    Returns (pw [N, 3], ok [N])."""
    fx, fy, cx, cy = K.fx, K.fy, K.cx, K.cy
    xn1 = torch.stack([(uv1[..., 0] - cx) / fx, (uv1[..., 1] - cy) / fy], -1)
    xn2 = torch.stack([(uv2[..., 0] - cx) / fx, (uv2[..., 1] - cy) / fy], -1)
    pw = triangulate_dlt(T1w[:3, :4], T2w[:3, :4], xn1, xn2)

    def cam(T, p):
        return p @ T[:3, :3].T + T[:3, 3]

    pc1 = cam(T1w, pw)
    pc2 = cam(T2w, pw)
    z1, z2 = pc1[..., 2], pc2[..., 2]
    u1 = fx * pc1[..., 0] / torch.clamp(z1, min=1e-6) + cx
    v1 = fy * pc1[..., 1] / torch.clamp(z1, min=1e-6) + cy
    u2 = fx * pc2[..., 0] / torch.clamp(z2, min=1e-6) + cx
    v2 = fy * pc2[..., 1] / torch.clamp(z2, min=1e-6) + cy
    e1 = (u1 - uv1[..., 0]) ** 2 + (v1 - uv1[..., 1]) ** 2
    e2 = (u2 - uv2[..., 0]) ** 2 + (v2 - uv2[..., 1]) ** 2

    c1 = -T1w[:3, :3].T @ T1w[:3, 3]
    c2 = -T2w[:3, :3].T @ T2w[:3, 3]
    pcos = parallax_cos(pw, c1, c2)

    ok = ((z1 > 0) & (z2 > 0)
          & (e1 < reproj_chi2) & (e2 < reproj_chi2)
          & (pcos < min_parallax_cos) & (pcos > 0.0)
          & torch.all(torch.isfinite(pw), dim=-1))
    return pw, ok
