"""RANSAC Sim3 / SE3 estimation between two keyframes' matched points.

Counterpart of object_slam_tpu/solvers/sim3_solver.py (Sim3Solver.cc:
140-365, Optimizer::OptimizeSim3): every trial's Horn problem is one
batched 4x4 eigendecomposition, both directions' reprojection checks one
[T, N] matrix each. As PnP's (solvers/epnp.py), the RANSAC takes
its [T, 3] index sets as an argument (``sim3_ransac_sets``), so a test can
hand it the reference's own draws; the loop closer draws them from its own
``torch.Generator`` (``LoopCloser._minimal_sets``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from object_slam_tpu_torch.geometry import sim3
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.geometry.horn import horn_align


class Sim3Result(NamedTuple):
    T12: torch.Tensor     # [4, 4] rotation + translation, frame 2 -> 1
    s12: torch.Tensor     # [] scale
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _project(K: Intrinsics, p):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([K.fx * p[..., 0] / z + K.cx,
                        K.fy * p[..., 1] / z + K.cy], -1)


def sim3_ransac_sets(idx, K: Intrinsics, pc1, pc2, valid,
                     inv_sigma2_1=None, inv_sigma2_2=None,
                     fix_scale: bool = True, chi2_th1: float = 9.210,
                     chi2_th2: float = 9.210,
                     min_inliers: int = 20) -> Sim3Result:
    """The hypotheses of the [T, 3] index sets ``idx`` for p1 ~ s12 R12 p2
    + t12 (pc1, pc2 [N, 3] camera-frame points), gated by bidirectional
    reprojection chi2 (9.21, Sim3Solver.cc:83-88); the winner refined by
    a weighted Horn on its inliers and re-gated."""
    N = pc1.shape[0]
    ones = torch.ones(N, dtype=pc1.dtype, device=pc1.device)
    inv_sigma2_1 = ones if inv_sigma2_1 is None else inv_sigma2_1
    inv_sigma2_2 = ones if inv_sigma2_2 is None else inv_sigma2_2
    idx = idx.long()
    T, s = horn_align(pc2[idx], pc1[idx], fix_scale=fix_scale)

    p2in1 = s[:, None, None] * torch.einsum('tij,nj->tni', T[:, :3, :3],
                                            pc2) + T[:, None, :3, 3]
    uv1 = _project(K, pc1)
    e1 = torch.sum((_project(K, p2in1) - uv1[None]) ** 2, -1) \
        * inv_sigma2_1[None]
    p1in2 = torch.einsum('tji,tnj->tni', T[:, :3, :3],
                         pc1[None] - T[:, None, :3, 3]) / s[:, None, None]
    uv2 = _project(K, pc2)
    e2 = torch.sum((_project(K, p1in2) - uv2[None]) ** 2, -1) \
        * inv_sigma2_2[None]

    inl = (e1 < chi2_th1) & (e2 < chi2_th2) & valid[None]
    scores = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(scores)          # the first maximum, as jnp.argmax

    w = inl[best].to(pc1.dtype)
    Tr, sr = horn_align(pc2, pc1, weights=w, fix_scale=fix_scale)
    p2in1 = sr * (pc2 @ Tr[:3, :3].T) + Tr[:3, 3]
    e1r = torch.sum((_project(K, p2in1) - uv1) ** 2, -1) * inv_sigma2_1
    p1in2 = ((pc1 - Tr[:3, 3]) @ Tr[:3, :3]) / sr
    e2r = torch.sum((_project(K, p1in2) - uv2) ** 2, -1) * inv_sigma2_2
    inl_r = (e1r < chi2_th1) & (e2r < chi2_th2) & valid
    n = torch.sum(inl_r.to(torch.int32))
    return Sim3Result(T12=Tr, s12=sr, inliers=inl_r, n_inliers=n,
                      ok=n >= min_inliers)


def sim3_gn_refine(K: Intrinsics, pc1, pc2, valid, T12, s12,
                   inv_sigma2_1=None, inv_sigma2_2=None,
                   fix_scale: bool = True, chi2_th: float = 10.0,
                   iters1: int = 5, iters2: int = 10):
    """Gauss-Newton on the Sim3 tangent with bidirectional projection
    residuals and Huber IRLS (delta^2 = chi2_th): iters1 steps, a chi2
    prune of both directions of a pair, iters2 more. The [N, 4, 7]
    Jacobian is forward-mode (torch.func.jacfwd), as the reference's
    jax.jacfwd. Returns (T12, s12, inliers [N], n_inliers)."""
    N = pc1.shape[0]
    dt, dev = pc1.dtype, pc1.device
    ones = torch.ones(N, dtype=dt, device=dev)
    inv_sigma2_1 = ones if inv_sigma2_1 is None else inv_sigma2_1
    inv_sigma2_2 = ones if inv_sigma2_2 is None else inv_sigma2_2
    uv1 = _project(K, pc1)
    uv2 = _project(K, pc2)
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(xi, T, s):
        # a leading axis of 1 keeps the scale 1-d: under jacfwd a 0-d
        # intermediate's tangent comes out float64 (torch 2.x)
        dT, ds = sim3.exp(xi[None])
        Tc, sc = sim3.compose(dT, ds, T[None], s[None])
        Tc, sc = Tc[0], sc
        p2in1 = sc * (pc2 @ Tc[:3, :3].T) + Tc[:3, 3]
        r1 = (_project(K, p2in1) - uv1) * sq1
        p1in2 = ((pc1 - Tc[:3, 3]) @ Tc[:3, :3]) / sc
        r2 = (_project(K, p1in2) - uv2) * sq2
        return torch.cat([r1, r2], dim=-1)        # [N, 4]

    jac = jacfwd(residuals)
    zero = torch.zeros(7, dtype=dt, device=dev)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    delta2 = chi2_th

    def chis(T, s):
        r = residuals(zero, T, s)
        return r, torch.sum(r[:, :2] ** 2, -1), torch.sum(r[:, 2:] ** 2, -1)

    def gn_step(T, s, inl):
        r, chi1, chi2 = chis(T, s)
        J = jac(zero, T, s)                        # [N, 4, 7]
        one = torch.ones_like(chi1)
        w1 = torch.where(chi1 > delta2, torch.sqrt(
            delta2 / torch.clamp(chi1, min=1e-12)), one)
        w2 = torch.where(chi2 > delta2, torch.sqrt(
            delta2 / torch.clamp(chi2, min=1e-12)), one)
        w = torch.cat([w1[:, None].expand(N, 2), w2[:, None].expand(N, 2)],
                      -1) * inl[:, None].to(dt)
        Jw = J * w[..., None]
        H = torch.einsum('nrk,nrl->kl', Jw, J)
        b = -torch.einsum('nrk,nr->k', Jw, r)
        if fix_scale:
            keep = torch.ones(7, dtype=dt, device=dev)
            keep[6] = 0.0
            H = H * keep[:, None] * keep[None, :]
            H = H + torch.diag(1.0 - keep)
            b = b * keep
        dx = torch.linalg.solve(H + 1e-6 * eye7, b)
        dT, ds = sim3.exp(dx)
        return sim3.compose(dT, ds, T, s)

    T = T12
    s = torch.as_tensor(s12, dtype=dt, device=dev)
    for _ in range(iters1):
        T, s = gn_step(T, s, valid)
    _, chi1, chi2 = chis(T, s)
    inl = valid & (chi1 <= chi2_th) & (chi2 <= chi2_th)
    for _ in range(iters2):
        T, s = gn_step(T, s, inl)
    _, chi1, chi2 = chis(T, s)
    inl = valid & (chi1 <= chi2_th) & (chi2 <= chi2_th)
    return T, s, inl, torch.sum(inl.to(torch.int32))
