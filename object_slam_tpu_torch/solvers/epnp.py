"""PnP RANSAC for relocalization (3D-2D camera pose from map matches).

Counterpart of object_slam_tpu/solvers/epnp.py: T minimal 6-point DLT
pose hypotheses (one batched 12x12 eigendecomposition each), all scored
against all correspondences in one [T, N] reprojection matrix, the winner
Gauss-Newton-polished on its inliers by the shared pose optimizer.

The reference draws the index sets inside ``pnp_ransac`` from a
``jax.random`` key. Here the hypothesis and scoring part,
``pnp_ransac_sets``, takes the [T, 6] index sets as an argument, so a test
can hand it the reference's own sets; ``pnp_ransac`` draws them from a
``torch.Generator`` first (solvers/ransac.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.solvers import ransac
from object_slam_tpu_torch.solvers.pose_opt import PoseObs, pose_optimize


def dlt_pose(pw, xn):
    """Batched 6+ point DLT pose: pw [..., M, 3] world, xn [..., M, 2]
    normalized image coords. Returns Tcw [..., 4, 4] with orthonormal R."""
    X, Y, Z = pw[..., 0], pw[..., 1], pw[..., 2]
    x, y = xn[..., 0], xn[..., 1]
    zero = torch.zeros_like(X)
    one = torch.ones_like(X)
    # rows: [X Y Z 1 0 0 0 0 -xX -xY -xZ -x] and the y-row
    r1 = torch.stack([X, Y, Z, one, zero, zero, zero, zero,
                      -x * X, -x * Y, -x * Z, -x], -1)
    r2 = torch.stack([zero, zero, zero, zero, X, Y, Z, one,
                      -y * X, -y * Y, -y * Z, -y], -1)
    A = torch.cat([r1, r2], dim=-2)                      # [..., 2M, 12]
    AtA = A.transpose(-1, -2) @ A
    _, v = torch.linalg.eigh(AtA)
    p = v[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    # sign: the centroid in front of the camera
    c = torch.mean(pw, dim=-2)
    zc = torch.sum(P[..., 2, :3] * c, dim=-1) + P[..., 2, 3]
    P = P * torch.where(zc < 0, -1.0, 1.0)[..., None, None]
    # project R onto SO(3), rescale t by the mean singular value
    R = P[..., :3, :3]
    U, S, Vh = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vh)
    ones = torch.ones_like(det)
    Rn = U @ torch.diag_embed(torch.stack([ones, ones, det], -1)) @ Vh
    scale = torch.mean(S, dim=-1) * torch.where(det < 0, -1.0, 1.0)
    t = (P[..., :3, 3] / torch.clamp(torch.abs(scale), min=1e-9)[..., None]
         * torch.sign(scale)[..., None])
    T = torch.zeros(P.shape[:-2] + (4, 4), dtype=P.dtype, device=P.device)
    T[..., :3, :3] = Rn
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def hypothesis_scores(idx, K: Intrinsics, pw, uv, valid,
                      chi2_th: float = 5.991, inv_sigma2=None):
    """The DLT hypotheses of the [T, 6] index sets ``idx`` and their
    scores against pw [N, 3] world points and uv [N, 2] undistorted pixels
    (valid [N]): (T [T, 4, 4], inliers [T, N], scores [T] int32)."""
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(uv.shape[0], dtype=uv.dtype, device=uv.device)
    xn = torch.stack([(uv[..., 0] - K.cx) / K.fx,
                      (uv[..., 1] - K.cy) / K.fy], -1)
    idx = idx.long()
    T = dlt_pose(pw[idx], xn[idx])                        # [T, 4, 4]

    # score: [T, N] reprojection chi2
    pc = torch.einsum('tij,nj->tni', T[:, :3, :3], pw) + T[:, None, :3, 3]
    z = pc[..., 2]
    u = K.fx * pc[..., 0] / torch.clamp(z, min=1e-6) + K.cx
    v = K.fy * pc[..., 1] / torch.clamp(z, min=1e-6) + K.cy
    chi2 = ((u - uv[None, :, 0]) ** 2
            + (v - uv[None, :, 1]) ** 2) * inv_sigma2[None, :]
    inl = (chi2 < chi2_th) & (z > 0) & valid[None, :]
    return T, inl, torch.sum(inl.to(torch.int32), dim=-1)


def pnp_ransac_sets(idx, K: Intrinsics, pw, uv, valid,
                    chi2_th: float = 5.991, min_inliers: int = 10,
                    inv_sigma2=None) -> PnPResult:
    """The hypotheses of the [T, 6] index sets ``idx``, scored against pw
    [N, 3] world points and uv [N, 2] undistorted pixels (valid [N]); the
    best one polished. ok=False if it has < min_inliers."""
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(uv.shape[0], dtype=uv.dtype, device=uv.device)
    T, inl, scores = hypothesis_scores(idx, K, pw, uv, valid, chi2_th,
                                       inv_sigma2)
    best = torch.argmax(scores)          # the first maximum, as jnp.argmax
    T0, inl0 = T[best], inl[best]

    # polish with the shared pose optimizer on the inlier set
    obs = PoseObs(uv=uv, ur=torch.full((uv.shape[0],), -1.0, dtype=uv.dtype,
                                       device=uv.device),
                  pw=pw, inv_sigma2=inv_sigma2, valid=inl0)
    Tp, inl_final, n = pose_optimize(K, T0, obs, rounds=2, iters_per_round=5,
                                     chi2_mono=chi2_th)
    return PnPResult(Tcw=Tp, inliers=inl_final, n_inliers=n,
                     ok=scores[best] >= min_inliers)


def pnp_ransac(gen: torch.Generator, K: Intrinsics, pw, uv, valid,
               n_trials: int = 256, chi2_th: float = 5.991,
               min_inliers: int = 10, inv_sigma2=None) -> PnPResult:
    """pw [N, 3] world points, uv [N, 2] undistorted pixels, valid [N]:
    ``n_trials`` index sets drawn from ``gen``, then pnp_ransac_sets."""
    idx = ransac.sample_minimal_sets(gen, pw.shape[0], valid, n_trials, 6)
    return pnp_ransac_sets(idx, K, pw, uv, valid, chi2_th=chi2_th,
                           min_inliers=min_inliers, inv_sigma2=inv_sigma2)
