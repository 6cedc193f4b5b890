"""Monocular map initialization: two-view relative pose + triangulation.

Counterpart of object_slam_tpu/solvers/initializer.py (``Initializer``,
Initializer.cc): a homography and a fundamental matrix are both scored as
batched hypothesize-and-verify RANSAC (solvers/ransac.py), a score ratio
selects the model (Initializer.cc:108-121), and every motion candidate of
both models (4 from the essential matrix, 8 from the Faugeras homography
decomposition) is triangulated; a cheirality vote masked by the selected
model picks the winner, which must dominate the runner-up by 1.2x. Pure
rotation and planar scenes fail the vote and are refused.

The reference draws its index sets from a ``jax.random`` key, split once
for each model. ``initialize_mono_sets`` takes the [T, 8] and [T, 4] sets
as arguments, so a test can hand it the reference's own draws;
``initialize_mono`` draws them from a ``torch.Generator`` first.

Backends choose different signs for eigen- and singular vectors, so the
candidates come out in another order or sign than the reference's; the
vote's outcome (ok, the winning motion, the good set) is what matches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.geometry.triangulation import triangulate_two_view
from object_slam_tpu_torch.solvers import ransac


def homography_4pt(p1, p2):
    """Batched 4-point DLT homography: [..., 4, 2] x2 -> [..., 3, 3] in
    their dtype, solved in float64 as ransac.eight_point_fundamental is
    (the unnormalized DLT on pixels is worse conditioned still)."""
    dtype = p1.dtype
    p1, p2 = p1.to(ransac.MINIMAL_DTYPE), p2.to(ransac.MINIMAL_DTYPE)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    rA = torch.stack([x1, y1, one, zero, zero, zero,
                      -x2 * x1, -x2 * y1, -x2], -1)
    rB = torch.stack([zero, zero, zero, x1, y1, one,
                      -y2 * x1, -y2 * y1, -y2], -1)
    h = ransac.null_vector(torch.cat([rA, rB], dim=-2))   # [..., 9]
    return ransac.normalize_dividing_by_33(
        h.reshape(h.shape[:-1] + (3, 3))).to(dtype)


def _dehomogenize(q):
    """q[..., :2] / |q[..., 2]| * sign(q[..., 2]), the divisor clamped at
    1e-9 as the reference's."""
    w = q[..., 2:]
    return q[..., :2] / torch.clamp(torch.abs(w), min=1e-9) * torch.sign(w)


def homography_transfer_chi2(H, p1, p2):
    """Symmetric transfer error [T, N] (Initializer::CheckHomography)."""
    h1 = ransac._homogeneous(p1)
    h2 = ransac._homogeneous(p2)
    p1in2 = _dehomogenize(torch.einsum('tij,nj->tni', H, h1))
    Hinv = torch.linalg.inv_ex(H)[0]
    p2in1 = _dehomogenize(torch.einsum('tij,nj->tni', Hinv, h2))
    d12 = torch.sum((p1in2 - p2[None]) ** 2, -1)
    d21 = torch.sum((p2in1 - p1[None]) ** 2, -1)
    return d12 + d21


def _rows3(*rows):
    return torch.stack([torch.stack(r) for r in rows])


def decompose_homography(H, Km):
    """Faugeras SVD decomposition of a homography into 8 candidate (R, t)
    motions (Initializer::ReconstructH, Initializer.cc:470-571). Returns
    ([8, 3, 3], [8, 3]) with unit translations."""
    A = torch.linalg.inv_ex(Km)[0] @ H @ Km
    U, d, Vt = torch.linalg.svd(A)
    s_det = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = (aux1, aux1, -aux1, -aux1)
    x3s = (aux3, -aux3, aux3, -aux3)
    sin_num = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2)
                                     * (d2 * d2 - d3 * d3), min=0.0))

    Rs, ts = [], []
    # case d' = d2 (sin / cos theta)
    st = sin_num / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for x1, x3 in zip(x1s, x3s):
        s = torch.sign(x1 + 1e-30) * torch.sign(x3 + 1e-30) * st
        Rp = _rows3((ct, zero, -s), (zero, one, zero), (s, zero, ct))
        tp = (d1 - d3) * torch.stack([x1, zero, -x3])
        Rs.append(s_det * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2 (sin / cos phi)
    sp = sin_num / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for x1, x3 in zip(x1s, x3s):
        s = torch.sign(x1 + 1e-30) * torch.sign(x3 + 1e-30) * sp
        Rp = _rows3((cp, zero, s), (zero, -one, zero), (s, zero, -cp))
        tp = (d1 + d3) * torch.stack([x1, zero, x3])
        Rs.append(s_det * U @ Rp @ Vt)
        ts.append(U @ tp)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    tn = torch.linalg.norm(ts, dim=-1, keepdim=True)
    return Rs, ts / torch.clamp(tn, min=1e-9)


def decompose_essential(E):
    """E -> 4 candidate (R, t) pairs, [4, 3, 3] and [4, 3]."""
    U, _, Vt = torch.linalg.svd(E)
    # proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


class MonoInit(NamedTuple):
    ok: torch.Tensor          # [] bool
    T21: torch.Tensor         # [4, 4] pose of frame 2 with frame 1 as world
    pw: torch.Tensor          # [N, 3] triangulated points (frame-1 frame)
    good: torch.Tensor        # [N] triangulation validity


def _pose(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def initialize_mono_sets(idxF, idxH, K: Intrinsics, uv1, uv2, valid,
                         sigma: float = 1.0, min_inliers: int = 50,
                         h_ratio_reject: float = 0.45) -> MonoInit:
    """uv1 / uv2 [N, 2] matched undistorted keypoints of the two frames,
    valid [N]; idxF [T, 8] and idxH [T, 4] the RANSAC index sets of the
    fundamental and homography models."""
    # F model; the reference's score sums (th - chi2) over the inliers
    # (Initializer.cc:390)
    F = ransac.eight_point_fundamental(uv1[idxF.long()], uv2[idxF.long()])
    dF = ransac.sampson_epipolar_chi2(F, uv1, uv2)
    thF = 3.841 * sigma * sigma * 2
    inlF = (dF < thF) & valid[None]
    scoreF = torch.sum(torch.where(inlF, thF - dF, torch.zeros_like(dF)), 1)
    bestF = torch.argmax(scoreF)

    # H model
    H = homography_4pt(uv1[idxH.long()], uv2[idxH.long()])
    dH = homography_transfer_chi2(H, uv1, uv2)
    thH = 5.991 * sigma * sigma * 2
    inlH = (dH < thH) & valid[None]
    scoreH = torch.sum(torch.where(inlH, thH - dH, torch.zeros_like(dH)), 1)
    SH = torch.max(scoreH)
    bestH = torch.argmax(scoreH)
    SF = scoreF[bestF]
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > h_ratio_reject

    # every candidate of both models; the selected model's may win
    Km = K.matrix(device=uv1.device).to(uv1.dtype)
    E = Km.T @ F[bestF] @ Km
    Rs_e, ts_e = decompose_essential(E)
    Rs_h, ts_h = decompose_homography(H[bestH], Km)
    Rs = torch.cat([Rs_e, Rs_h])                 # [12, 3, 3]
    ts = torch.cat([ts_e, ts_h])
    model_ok = torch.cat([(~use_H).expand(4), use_H.expand(8)])
    inl = torch.where(use_H, inlH[bestH], inlF[bestF])

    T1 = torch.eye(4, dtype=uv1.dtype, device=uv1.device)
    counts, pws, oks = [], [], []
    for i in range(12):
        pw, ok = triangulate_two_view(K, T1, _pose(Rs[i], ts[i]), uv1, uv2,
                                      reproj_chi2=thF)
        ok = ok & inl
        counts.append(torch.sum(ok.to(torch.int32)))
        pws.append(pw)
        oks.append(ok)
    counts = torch.stack(counts) * model_ok.to(torch.int32)
    best = torch.argmax(counts)
    n_good = counts[best]
    # the winner must dominate (Initializer.cc:560-600)
    second = torch.sort(counts).values[-2]
    decisive = n_good.to(torch.float32) > second.to(torch.float32) * 1.2
    ok_all = (n_good >= min_inliers) & decisive
    return MonoInit(ok=ok_all, T21=_pose(Rs[best], ts[best]),
                    pw=torch.stack(pws)[best],
                    good=torch.stack(oks)[best] & ok_all)


def initialize_mono(gen: torch.Generator, K: Intrinsics, uv1, uv2, valid,
                    n_trials: int = 200, sigma: float = 1.0,
                    min_inliers: int = 50,
                    h_ratio_reject: float = 0.45) -> MonoInit:
    """initialize_mono_sets on ``n_trials`` F sets then ``n_trials`` H sets
    drawn from ``gen``."""
    N = uv1.shape[0]
    idxF = ransac.sample_minimal_sets(gen, N, valid, n_trials, 8)
    idxH = ransac.sample_minimal_sets(gen, N, valid, n_trials, 4)
    return initialize_mono_sets(idxF, idxH, K, uv1, uv2, valid, sigma=sigma,
                                min_inliers=min_inliers,
                                h_ratio_reject=h_ratio_reject)
