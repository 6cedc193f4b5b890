"""Bundle adjustment: Schur-complement Levenberg-Marquardt over
observation slabs.

Counterpart of object_slam_tpu/solvers/ba.py. The problem is a flat
observation slab; point blocks are eliminated in closed form; the reduced
camera system is solved with block-Jacobi preconditioned CG; LM step
control accepts only cost-decreasing steps. Every solver path uses the
reference's blocked layout (``block_n``: [Kk, block_n] rows per keyframe)
and per-point observation-slot table (``pt_obs_slot``), so the per-KF and
per-point reductions are axis sums; ``global_ba`` builds that table over
the whole map (``obs_slot_table``) where the reference takes segment sums.
``ba_iterate`` also takes the reference's scatter forms (``block_n=None``,
``pt_obs_slot=None``: segment sums by ``index_add_``), which
scripts/diag_ba_profile_torch.py times against the blocked ones.

``comm`` is the counterpart of the reference's ``comm_axis`` (its
``psum`` over a mesh axis): the observation slab holds only the blocks of
keyframes ``comm.kf_ids`` (ascending) of a problem sharded at
keyframe-block boundaries (parallel/sharded_ba.py). ``comm.reduce(kf,
pt, cost)`` sums the per-keyframe partial sums (this rank's rows, zero
elsewhere), the per-point partial sums and the cost over the ranks, and
``comm.agree(flag)`` makes every host branch one decision that all ranks
take. Poses, points and the CG over the reduced camera system are
replicated. With ``comm=None`` nothing is reduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.solvers.pose_opt import huber_weight


class BAProblem(NamedTuple):
    """kf_pose [K, 4, 4]; kf_fixed, kf_valid [K]; pt_xyz [P, 3]; pt_valid
    [P]; obs_kf, obs_pt [O] int; obs_uv [O, 2]; obs_ur [O] (< 0 mono);
    obs_inv_sigma2 [O]; obs_valid [O]."""

    kf_pose: torch.Tensor
    kf_fixed: torch.Tensor
    kf_valid: torch.Tensor
    pt_xyz: torch.Tensor
    pt_valid: torch.Tensor
    obs_kf: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_ur: torch.Tensor
    obs_inv_sigma2: torch.Tensor
    obs_valid: torch.Tensor


def _residual_jacobians(K: Intrinsics, prob: BAProblem, kf_pose, pt_xyz,
                        block_n: int | None):
    """Per-obs residuals r [O, 3], pose Jacobian Jc [O, 3, 6], point
    Jacobian Jp [O, 3, 3], stereo mask, camera-frame depth. block_n None:
    each observation's pose gathered by obs_kf (the reference's
    unblocked form)."""
    Kk = kf_pose.shape[0]
    if block_n is not None:
        pw_b = pt_xyz[prob.obs_pt.long()].reshape(Kk, block_n, 3)
        R_b = kf_pose[:, :3, :3]
        pc = (torch.einsum('kij,knj->kni', R_b, pw_b)
              + kf_pose[:, None, :3, 3]).reshape(-1, 3)
    else:
        T = kf_pose[prob.obs_kf.long()]
        pc = (torch.einsum('oij,oj->oi', T[:, :3, :3],
                           pt_xyz[prob.obs_pt.long()]) + T[:, :3, 3])
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz

    u = K.fx * x * iz + K.cx
    v = K.fy * y * iz + K.cy
    ur = u - K.bf * iz
    stereo = prob.obs_ur >= 0.0
    zero = torch.zeros_like(z)
    r = torch.stack([prob.obs_uv[..., 0] - u, prob.obs_uv[..., 1] - v,
                     torch.where(stereo, prob.obs_ur - ur, zero)], dim=-1)

    du = torch.stack([K.fx * iz, zero, -K.fx * x * iz2], -1)
    dv = torch.stack([zero, K.fy * iz, -K.fy * y * iz2], -1)
    dur = du + torch.stack([zero, zero, K.bf * iz2], -1)
    dproj = torch.stack([du, dv, torch.where(stereo[..., None], dur,
                                             torch.zeros_like(dur))], -2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)
    Jc = -(dproj @ dpc_dxi)
    if block_n is not None:
        Jp = -torch.einsum('knij,kjl->knil',
                           dproj.reshape(Kk, block_n, 3, 3),
                           R_b).reshape(-1, 3, 3)
    else:
        Jp = -(dproj @ T[:, :3, :3])
    return r, Jc, Jp, stereo, pc[..., 2]


def _delta2(stereo, chi2_mono, chi2_stereo):
    return torch.where(stereo, torch.full(stereo.shape, chi2_stereo,
                                          device=stereo.device),
                       torch.full(stereo.shape, chi2_mono,
                                  device=stereo.device))


def _weights(prob, r, stereo, z, chi2_mono, chi2_stereo, robust=True):
    e2 = torch.where(stereo, torch.sum(r * r, -1),
                     r[..., 0] ** 2 + r[..., 1] ** 2)
    chi2 = e2 * prob.obs_inv_sigma2
    delta2 = _delta2(stereo, chi2_mono, chi2_stereo)
    w = huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
    w = w * prob.obs_inv_sigma2
    live = (prob.obs_valid & (z > 0) & prob.kf_valid[prob.obs_kf.long()]
            & prob.pt_valid[prob.obs_pt.long()])
    return torch.where(live, w, torch.zeros_like(w)), chi2


def _spd_inv3(H):
    """Batched 3x3 SPD inverse via the adjugate."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                      det)
    inv = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([B, a * f - c * c, c * b - a * e], -1),
        torch.stack([C, c * b - a * e, a * d - b * b], -1),
    ], -2) / det[..., None, None]
    return inv


def _robust_cost(K: Intrinsics, prob: BAProblem, kf_pose, pt_xyz,
                 chi2_mono, chi2_stereo, block_n: int | None, comm=None):
    """Total Huber cost over live observations; points behind a camera
    carry a 1e4 penalty. With comm, this shard's observations, summed
    over the ranks."""
    if comm is not None and block_n is not None:
        kf_pose = kf_pose[comm.kf_ids]
    r, _, _, stereo, z = _residual_jacobians(K, prob, kf_pose, pt_xyz,
                                             block_n=block_n)
    e2 = torch.where(stereo, torch.sum(r * r, -1),
                     r[..., 0] ** 2 + r[..., 1] ** 2)
    chi2 = e2 * prob.obs_inv_sigma2
    d2 = _delta2(stereo, chi2_mono, chi2_stereo)
    rho = torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * chi2) - d2)
    rho = rho + torch.where(z <= 0, torch.full_like(z, 1e4),
                            torch.zeros_like(z))
    live = (prob.obs_valid & prob.kf_valid[prob.obs_kf.long()]
            & prob.pt_valid[prob.obs_pt.long()])
    cost = torch.sum(torch.where(live, rho, torch.zeros_like(rho)))
    if comm is not None:
        (cost,) = comm.reduce(cost=[cost])[2]
    return cost


def _scatter_rows(prob: BAProblem):
    """The segment ids of the scatter forms' sums: (per keyframe, per
    point)."""
    return prob.obs_kf.long(), prob.obs_pt.long()


def ba_iterate(K: Intrinsics, prob: BAProblem, n_iters: int,
               chi2_mono: float = 5.991, chi2_stereo: float = 7.815,
               damping: float = 1e-4, cg_iters: int = 24,
               robust: bool = True, *, block_n: int | None, pt_obs_slot,
               comm=None):
    """n_iters LM/Schur iterations with a convergence exit. Returns
    (kf_pose, pt_xyz).

    block_n: the observation slots per keyframe (the slab in [Kk, block_n]
    row-major blocks, per-keyframe sums as axis sums); None: the
    reference's scatter form, per-keyframe sums by index_add_ over obs_kf
    and each observation's pose gathered by obs_kf. pt_obs_slot [P, M]:
    each point's observation indices (-1 empty), per-point sums as a
    gather and an axis sum; None: the scatter form, index_add_ over
    obs_pt. Both arguments are required, so no caller takes a scatter form
    by default: on the card index_add_ adds atomically, in another order
    on each run, so the scatter forms are not deterministic there, and no
    tracking, mapping, loop or sharded path takes them (they are the forms
    scripts/diag_ba_profile_torch.py profiles).

    comm: the all-reduce hook of a sharded slab (module docstring), None
    on one process. With the scatter forms the slab holds this rank's
    observations and the sums are this rank's rows, left to comm.reduce
    to sum over the ranks (the reference's psum of its segment sums)."""
    Kk = prob.kf_pose.shape[0]
    O = prob.obs_kf.shape[0]
    P = prob.pt_xyz.shape[0]
    obs_pt = prob.obs_pt.long()
    dev = prob.pt_xyz.device
    if block_n is None or pt_obs_slot is None:
        seg_kf_ids, seg_pt_ids = _scatter_rows(prob)
    # the keyframe blocks of this slab (the blocked form), or the
    # keyframes whose rows this rank hands to comm.reduce
    Kl = Kk if comm is None else comm.kf_ids.shape[0]

    def seg_kf(vals):
        if block_n is None:
            out = vals.new_zeros((Kk,) + vals.shape[1:]).index_add_(
                0, seg_kf_ids, vals)
            return out if comm is None else out[comm.kf_ids]
        return torch.sum(vals.reshape((Kl, block_n) + vals.shape[1:]), dim=1)

    if pt_obs_slot is not None:
        slot_ok = pt_obs_slot >= 0
        slot_idx = torch.clamp(pt_obs_slot, 0, O - 1).long()

    def seg_pt(vals):
        if pt_obs_slot is None:
            return vals.new_zeros((P,) + vals.shape[1:]).index_add_(
                0, seg_pt_ids, vals)
        g = vals[slot_idx]
        mask = slot_ok.reshape(slot_ok.shape + (1,) * (vals.dim() - 1))
        return torch.sum(torch.where(mask, g, torch.zeros_like(g)), dim=1)

    def per_obs_kf(vals):
        if block_n is None:
            return vals[prob.obs_kf.long()]
        if comm is not None:
            vals = vals[comm.kf_ids]
        return vals[:, None].expand((Kl, block_n) + vals.shape[1:]) \
            .reshape((-1,) + vals.shape[1:])

    def local(kf_pose):
        return (kf_pose if comm is None or block_n is None
                else kf_pose[comm.kf_ids])

    def reduce(kf=(), pt=()):
        return (list(kf), list(pt)) if comm is None else \
            comm.reduce(kf=kf, pt=pt)[:2]

    def decide(flag) -> bool:
        return bool(flag) if comm is None else comm.agree(flag)

    free_kf = (~prob.kf_fixed) & prob.kf_valid
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)

    def one_iter(kf_pose, pt_xyz, lam, cost):
        r, Jc, Jp, stereo, z = _residual_jacobians(K, prob, local(kf_pose),
                                                   pt_xyz, block_n=block_n)
        w, _ = _weights(prob, r, stereo, z, chi2_mono, chi2_stereo, robust)
        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]

        (Hcc, bc), (Hpp, bp) = reduce(
            kf=[seg_kf(torch.einsum('oik,oil->okl', Jcw, Jc)),
                seg_kf(torch.einsum('oik,oi->ok', Jcw, r))],
            pt=[seg_pt(torch.einsum('oik,oil->okl', Jpw, Jp)),
                seg_pt(torch.einsum('oik,oi->ok', Jpw, r))])
        Wcp = torch.einsum('oik,oil->okl', Jcw, Jp)
        bc, bp = -bc, -bp

        Hcc = Hcc + lam * (Hcc * eye6) + 1e-6 * eye6
        Hpp = Hpp + lam * (Hpp * eye3) + 1e-6 * eye3
        Hpp_inv = _spd_inv3(Hpp)

        y0 = torch.einsum('pkl,pl->pk', Hpp_inv, bp)
        (sy0,), _ = reduce(kf=[seg_kf(torch.einsum('okl,ol->ok', Wcp,
                                                   y0[obs_pt]))])
        bt = bc - sy0
        bt = torch.where(free_kf[:, None], bt, torch.zeros_like(bt))

        def S_matvec(xc):
            xc = torch.where(free_kf[:, None], xc, torch.zeros_like(xc))
            out = torch.einsum('kij,kj->ki', Hcc, xc)
            _, (tp,) = reduce(pt=[seg_pt(torch.einsum('okl,ok->ol', Wcp,
                                                      per_obs_kf(xc)))])
            yp = torch.einsum('pkl,pl->pk', Hpp_inv, tp)
            (sy,), _ = reduce(kf=[seg_kf(torch.einsum('okl,ol->ok', Wcp,
                                                      yp[obs_pt]))])
            out = out - sy
            return torch.where(free_kf[:, None], out, torch.zeros_like(out))

        Hcc_inv = torch.linalg.inv(
            Hcc + (~free_kf)[:, None, None].to(Hcc.dtype) * eye6)

        def precond(v):
            return torch.where(free_kf[:, None],
                               torch.einsum('kij,kj->ki', Hcc_inv, v),
                               torch.zeros_like(v))

        def tiny(x):
            return torch.where(torch.abs(x) < 1e-12,
                               torch.full_like(x, 1e-12), x)

        xk = torch.zeros_like(bt)
        rk = bt
        pk = precond(bt)
        rz = torch.sum(bt * pk)
        b_norm2 = torch.sum(bt * bt)
        for _ in range(cg_iters):
            if not decide(torch.sum(rk * rk) > 1e-4 * b_norm2):
                break
            Ap = S_matvec(pk)
            alpha = rz / tiny(torch.sum(pk * Ap))
            xk = xk + alpha * pk
            rk = rk - alpha * Ap
            zk = precond(rk)
            rz_new = torch.sum(rk * zk)
            beta = rz_new / tiny(rz)
            pk = zk + beta * pk
            rz = rz_new
        dxc = xk

        # trust region on point steps: 25% of the distance to the mean
        # observer, and 0.5 on pose steps
        obs_w = torch.where(w > 0, torch.ones_like(w), torch.zeros_like(w))
        cam_per_kf = -torch.einsum('kji,kj->ki', kf_pose[:, :3, :3],
                                   kf_pose[:, :3, 3])
        cams = per_obs_kf(cam_per_kf)
        _, (tp, n_obs_pt, cam_sum) = reduce(pt=[
            seg_pt(torch.einsum('okl,ok->ol', Wcp, per_obs_kf(dxc))),
            seg_pt(obs_w), seg_pt(cams * obs_w[:, None])])
        dxp = torch.einsum('pkl,pl->pk', Hpp_inv, bp - tp)
        dxp = torch.where(prob.pt_valid[:, None], dxp, torch.zeros_like(dxp))
        mean_cam = cam_sum / torch.clamp(n_obs_pt[:, None], min=1.0)
        d_pt = torch.linalg.norm(pt_xyz - mean_cam, dim=-1)
        step = torch.linalg.norm(dxp, dim=-1)
        cap = 0.25 * d_pt + 1e-3
        dxp = dxp * (torch.minimum(step, cap)
                     / torch.clamp(step, min=1e-12))[:, None]
        cstep = torch.linalg.norm(dxc, dim=-1)
        dxc = dxc * (torch.clamp(cstep, max=0.5)
                     / torch.clamp(cstep, min=1e-12))[:, None]

        cand_pose = torch.where(free_kf[:, None, None],
                                se3.retract(kf_pose, dxc), kf_pose)
        cand_pt = pt_xyz + dxp
        cand_cost = _robust_cost(K, prob, cand_pose, cand_pt,
                                 chi2_mono, chi2_stereo, block_n=block_n,
                                 comm=comm)
        accept = cand_cost < cost
        kf_pose = torch.where(accept, cand_pose, kf_pose)
        pt_xyz = torch.where(accept, cand_pt, pt_xyz)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0),
                          1e-6, 1e3)
        return kf_pose, pt_xyz, lam, cost

    kf_pose, pt_xyz = prob.kf_pose, prob.pt_xyz
    cost = _robust_cost(K, prob, kf_pose, pt_xyz, chi2_mono, chi2_stereo,
                        block_n=block_n, comm=comm)
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        kf_pose, pt_xyz, lam, new_cost = one_iter(kf_pose, pt_xyz, lam, cost)
        accepted = new_cost < cost
        tiny_dec = new_cost > cost * (1.0 - 1e-4)
        cost = new_cost
        if decide((accepted & tiny_dec) | (lam >= 1e3)):
            break
    return kf_pose, pt_xyz


def ba_chi2(K: Intrinsics, prob: BAProblem, kf_pose, pt_xyz, block_n: int):
    """Per-observation chi2 + depth at the current estimate."""
    r, _, _, stereo, z = _residual_jacobians(K, prob, kf_pose, pt_xyz,
                                             block_n=block_n)
    e2 = torch.where(stereo, torch.sum(r * r, -1),
                     r[..., 0] ** 2 + r[..., 1] ** 2)
    return e2 * prob.obs_inv_sigma2, z, stereo


def local_ba(K: Intrinsics, prob: BAProblem,
             iters1: int = 5, iters2: int = 10,
             chi2_mono: float = 5.991, chi2_stereo: float = 7.815,
             *, block_n: int, pt_obs_slot):
    """optimize(iters1), prune outlier observations (chi2 > gate or
    negative depth), optimize(iters2). Returns (kf_pose, pt_xyz,
    obs_valid)."""
    kf_pose, pt_xyz = ba_iterate(K, prob, iters1, chi2_mono, chi2_stereo,
                                 block_n=block_n, pt_obs_slot=pt_obs_slot)
    chi2, z, stereo = ba_chi2(K, prob, kf_pose, pt_xyz, block_n=block_n)
    gate = _delta2(stereo, chi2_mono, chi2_stereo)
    keep = prob.obs_valid & (chi2 <= gate) & (z > 0)
    prob2 = prob._replace(kf_pose=kf_pose, pt_xyz=pt_xyz, obs_valid=keep)
    kf_pose, pt_xyz = ba_iterate(K, prob2, iters2, chi2_mono, chi2_stereo,
                                 block_n=block_n, pt_obs_slot=pt_obs_slot)
    chi2, z, stereo = ba_chi2(K, prob2, kf_pose, pt_xyz, block_n=block_n)
    keep2 = keep & (chi2 <= gate) & (z > 0)
    return kf_pose, pt_xyz, keep2


def obs_slot_table(prob: BAProblem):
    """[P, M] int64: each point's live observation indices in ascending
    order (-1 empty), M the most any point has. Only live observations
    (valid, on a valid keyframe and point) carry weight, so the per-point
    sums over this table are the segment sums, summed in one fixed order:
    the card's atomic index_add_ sums in a different order each run."""
    P = prob.pt_xyz.shape[0]
    live = (prob.obs_valid & prob.kf_valid[prob.obs_kf.long()]
            & prob.pt_valid[prob.obs_pt.long()])
    o = torch.nonzero(live).squeeze(1)
    pt = prob.obs_pt.long()[o]
    order = torch.argsort(pt, stable=True)
    o, pt = o[order], pt[order]
    counts = torch.bincount(pt, minlength=P)
    M = max(int(counts.max()), 1) if o.numel() else 1
    rank = torch.arange(o.numel(), device=o.device) \
        - (torch.cumsum(counts, 0) - counts)[pt]
    table = torch.full((P, M), -1, dtype=torch.long, device=o.device)
    table[pt, rank] = o
    return table


def global_ba(K: Intrinsics, prob: BAProblem, iters: int = 10, *,
              block_n: int, comm=None, cg_iters: int = 24):
    """GlobalBundleAdjustment (Optimizer.cc:41-237): robust Huber edges
    over the whole map, the caller fixing kf_fixed[0]; the observations in
    [K, block_n] row-major blocks, the per-point sums over obs_slot_table
    (the reference's segment sums, in a fixed order). With comm, prob's
    slab is one rank's shard and the table is that shard's."""
    return ba_iterate(K, prob, iters, cg_iters=cg_iters, block_n=block_n,
                      pt_obs_slot=obs_slot_table(prob), comm=comm)
