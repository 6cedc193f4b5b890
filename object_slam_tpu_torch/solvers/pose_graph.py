"""7-DoF Sim(3) pose-graph optimization (the essential graph).

Counterpart of object_slam_tpu/solvers/pose_graph.py
(Optimizer::OptimizeEssentialGraph, Optimizer.cc:781-1044): vertices are a
dense [K, 7]-tangent problem; each edge's two 7x7 Jacobians come from
forward-mode autodiff of the Sim3 relative error (``torch.func.jvp`` of
the edge-batched error, vmapped over the 7 basis directions, where the
reference takes ``vmap(jacfwd)`` per edge: torch's vmap over edges of
jacfwd returned wrong columns for all but the first edge); the normal
equations
assemble by index-add into a dense [7K, 7K] system solved by
``torch.linalg.solve`` once per iteration (the reference solves it
densely too; at K = 512 it is 3584^2 f32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from object_slam_tpu_torch.geometry import sim3


class PoseGraphProblem(NamedTuple):
    """T [K, 4, 4]; s [K]; fixed [K] bool. Edges: ei, ej [E]; rel_T [E, 4,
    4], rel_s [E], the measured S_ji (vertex i -> vertex j); valid [E];
    weight [E]."""

    T: torch.Tensor
    s: torch.Tensor
    fixed: torch.Tensor
    ei: torch.Tensor
    ej: torch.Tensor
    rel_T: torch.Tensor
    rel_s: torch.Tensor
    valid: torch.Tensor
    weight: torch.Tensor


def _edge_error(xi_i, xi_j, Ti, si, Tj, sj, rel_T, rel_s):
    """e = log( S_ji_meas^-1 o (exp(xi_j) S_jw) o (exp(xi_i) S_iw)^-1 ),
    batched over the edges' leading axis."""
    dTi, dsi = sim3.exp(xi_i)
    dTj, dsj = sim3.exp(xi_j)
    Si_T, Si_s = sim3.compose(dTi, dsi, Ti, si)
    Sj_T, Sj_s = sim3.compose(dTj, dsj, Tj, sj)
    inv_T, inv_s = sim3.inverse(Si_T, Si_s)
    Sji_T, Sji_s = sim3.compose(Sj_T, Sj_s, inv_T, inv_s)
    mi_T, mi_s = sim3.inverse(rel_T, rel_s)
    E_T, E_s = sim3.compose(mi_T, mi_s, Sji_T, Sji_s)
    return sim3.log(E_T, E_s)


def edge_jacobians(Ti, si, Tj, sj, rel_T, rel_s):
    """(e [E, 7], J_i [E, 7, 7], J_j [E, 7, 7]) at xi = 0: the reference's
    per-edge ``vmap(jacfwd)``, as a forward-mode product of the batched
    error with each basis direction applied to every edge at once (an
    edge's error depends on its own tangents only, so direction d gives
    column d of every edge's Jacobian), vmapped over the 7 directions."""
    E = Ti.shape[0]
    zero = torch.zeros((E, 7), dtype=Ti.dtype, device=Ti.device)
    rest = (Ti, si, Tj, sj, rel_T, rel_s)
    basis = torch.eye(7, dtype=Ti.dtype, device=Ti.device)[:, None, :] \
        .expand(7, E, 7)

    def col_i(t):
        return jvp(lambda x: _edge_error(x, zero, *rest), (zero,), (t,))[1]

    def col_j(t):
        return jvp(lambda x: _edge_error(zero, x, *rest), (zero,), (t,))[1]
    e = _edge_error(zero, zero, *rest)
    return (e, vmap(col_i)(basis).permute(1, 2, 0),
            vmap(col_j)(basis).permute(1, 2, 0))


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        damping: float = 1e-6):
    """Gauss-Newton over the Sim3 graph. Returns (T [K, 4, 4], s [K])."""
    Kk = prob.T.shape[0]
    dt, dev = prob.T.dtype, prob.T.device
    ei, ej = prob.ei.long(), prob.ej.long()
    free = ~prob.fixed
    m = free.to(dt)
    w = torch.where(prob.valid, prob.weight.to(dt),
                    torch.zeros((), dtype=dt, device=dev))[:, None, None]
    fixdiag = torch.repeat_interleave(1.0 - m, 7)
    reg = torch.diag(fixdiag) + damping * torch.eye(Kk * 7, dtype=dt,
                                                    device=dev)
    mask2 = (m[:, None, None, None] * m[None, None, :, None])

    T, s = prob.T, prob.s
    for _ in range(n_iters):
        e, Ji, Jj = edge_jacobians(T[ei], s[ei], T[ej], s[ej], prob.rel_T,
                                   prob.rel_s)
        Jiw, Jjw = Ji * w, Jj * w

        # dense [K, 7, K, 7] normal equations by index-add of the blocks
        Hii = torch.einsum('eik,eil->ekl', Jiw, Ji)
        Hjj = torch.einsum('eik,eil->ekl', Jjw, Jj)
        Hij = torch.einsum('eik,eil->ekl', Jiw, Jj)
        Hb = torch.zeros((Kk * Kk, 7, 7), dtype=dt, device=dev)
        Hb.index_add_(0, ei * Kk + ei, Hii)
        Hb.index_add_(0, ej * Kk + ej, Hjj)
        Hb.index_add_(0, ei * Kk + ej, Hij)
        Hb.index_add_(0, ej * Kk + ei, Hij.transpose(-1, -2))
        H = Hb.reshape(Kk, Kk, 7, 7).permute(0, 2, 1, 3) * mask2

        b = torch.zeros((Kk, 7), dtype=dt, device=dev)
        b.index_add_(0, ei, -torch.einsum('eik,ei->ek', Jiw, e))
        b.index_add_(0, ej, -torch.einsum('eik,ei->ek', Jjw, e))

        Hd = H.reshape(Kk * 7, Kk * 7) + reg
        bd = (b * m[:, None]).reshape(Kk * 7)
        dx = torch.linalg.solve(Hd, bd).reshape(Kk, 7)
        dx = torch.where(free[:, None], dx, torch.zeros_like(dx))
        T, s = sim3.retract(T, s, dx)
    return T, s


def correct_points(pt_xyz, pt_ref_kf, T_old, s_old, T_new, s_new):
    """Move map points by their reference keyframe's pose correction:
    p' = S_new^-1(S_old(p)) per point (LoopClosing.cc:694-715)."""
    r = pt_ref_kf.long()
    pc = sim3.apply(T_old[r], s_old[r], pt_xyz[:, None, :])[:, 0]
    Tni, sni = sim3.inverse(T_new[r], s_new[r])
    return sim3.apply(Tni, sni, pc[:, None, :])[:, 0]
