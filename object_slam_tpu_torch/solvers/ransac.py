"""Batched hypothesize-and-verify RANSAC: the minimal-set sampler and the
fundamental-matrix model.

Counterpart of object_slam_tpu/solvers/ransac.py. Every trial's index set
is drawn up front by Gumbel top-k over the valid entries, so each trial
holds k distinct valid indices (when that many exist); all hypotheses are
solved in one batch and scored against all correspondences in one [T, N]
matrix. The reference draws from a ``jax.random`` key; the port draws
from an explicit ``torch.Generator``. The two streams differ, so tests
that compare the packages inject the reference's index sets instead
(``ransac_fundamental_sets``, as solvers/epnp.py::pnp_ransac_sets).
"""

from __future__ import annotations

import math

import torch

from object_slam_tpu_torch.ops.scatter import topk

# the dtype of the minimal-set null-vector solves (eight_point_fundamental
# and the initializer's homography_4pt)
MINIMAL_DTYPE = torch.float64


def sample_minimal_sets(gen: torch.Generator, n_points: int, valid_mask,
                        n_trials: int, k: int):
    """[T, k] int64 index sets, k distinct valid indices per trial (Gumbel
    top-k; invalid entries score -inf and come last)."""
    u = torch.rand((n_trials, n_points), generator=gen,
                   device=valid_mask.device)
    # Gumbel(0, 1) noise; the clamp keeps log(0) out of a zero draw
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    g = torch.where(valid_mask[None, :], g, torch.full_like(g, -torch.inf))
    return topk(g, k)[1]


def null_vector(A):
    """The eigenvector of A^T A [..., n, n] with the smallest eigenvalue
    (the least-squares null vector of A; its sign is arbitrary)."""
    AtA = A.transpose(-1, -2) @ A
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def normalize_dividing_by_33(M):
    """M / M[..., 2, 2], left as is where |M[2, 2]| < 1e-9."""
    m22 = M[..., 2:3, 2:3]
    return M / torch.where(torch.abs(m22) < 1e-9, torch.ones_like(m22), m22)


def _hartley(p):
    """Hartley normalization of [..., M, 2] points: (points, T [..., 3, 3])."""
    mean = torch.mean(p, dim=-2, keepdim=True)
    d = torch.mean(torch.linalg.norm(p - mean, dim=-1), dim=-1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    T = torch.zeros(p.shape[:-2] + (3, 3), dtype=p.dtype, device=p.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -s * mean[..., 0, 0]
    T[..., 1, 2] = -s * mean[..., 0, 1]
    return (p - mean) * s[..., None, None], T


def eight_point_fundamental(p1, p2):
    """Normalized 8-point algorithm, batched over trials: p1, p2 [..., 8, 2]
    pixel correspondences -> F [..., 3, 3] in their dtype, rank 2,
    F[2, 2] = 1 where it is not ~0.

    Solved in float64 (MINIMAL_DTYPE): the null vector of a minimal set's
    A^T A is ill-conditioned (eigengaps of 1e-7 to 1e-12 of the largest
    eigenvalue on rendered pairs), and float32 eigensolvers return
    different vectors for it: LAPACK builds differ by ~1e-3 of F, and on
    the card cuSOLVER's single-matrix path returned a vector no 8-point
    solve of that set has. In float64 every backend gives the exact F of
    the float32 inputs to ~1e-9."""
    dtype = p1.dtype
    p1n, T1 = _hartley(p1.to(MINIMAL_DTYPE))
    p2n, T2 = _hartley(p2.to(MINIMAL_DTYPE))
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    # x2^T F x1 = 0 rows
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     ones], dim=-1)
    f = null_vector(A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    # rank 2 through the SVD
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = U @ (S[..., None] * Vh)
    F = T2.transpose(-1, -2) @ F @ T1
    return normalize_dividing_by_33(F).to(dtype)


def _homogeneous(p):
    return torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype,
                                    device=p.device)], dim=-1)


def sampson_epipolar_chi2(F, p1, p2):
    """Symmetric epipolar distances (Initializer::CheckFundamental): F
    [T, 3, 3], p1, p2 [N, 2] -> [T, N], the squared distance to the
    epipolar line in both images, summed."""
    h1 = _homogeneous(p1)
    h2 = _homogeneous(p2)
    l2 = torch.einsum('tij,nj->tni', F, h1)               # lines in img2
    l1 = torch.einsum('tji,nj->tni', F, h2)               # lines in img1
    d2 = torch.einsum('ni,tni->tn', h2, l2) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.einsum('ni,tni->tn', h1, l1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1 + d2


def ransac_fundamental_sets(idx, p1, p2, valid,
                            inlier_th: float = 3.84 * 2.0):
    """The 8-point hypotheses of the [T, 8] index sets ``idx`` scored
    against p1, p2 [N, 2] (valid [N]): (F [3, 3], inlier mask [N],
    n_inliers) of the first best-scoring trial."""
    idx = idx.long()
    F = eight_point_fundamental(p1[idx], p2[idx])         # [T, 3, 3]
    d = sampson_epipolar_chi2(F, p1, p2)                  # [T, N]
    inl = (d < inlier_th) & valid[None, :]
    scores = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(scores)
    return F[best], inl[best], scores[best]


def ransac_fundamental(gen: torch.Generator, p1, p2, valid,
                       n_trials: int = 128, inlier_th: float = 3.84 * 2.0):
    """Fundamental-matrix RANSAC (the reference's stand-in for
    cv::findFundamentalMat, ObjectMatcher.cc:897-933): ``n_trials`` index
    sets drawn from ``gen``, then ransac_fundamental_sets."""
    idx = sample_minimal_sets(gen, p1.shape[0], valid, n_trials, 8)
    return ransac_fundamental_sets(idx, p1, p2, valid, inlier_th)
