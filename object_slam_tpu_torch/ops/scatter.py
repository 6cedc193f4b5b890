"""Index helpers with the reference package's semantics.

The JAX reference leans on three behaviours that torch does not share:

* ``x.at[idx].set(v)`` drops out-of-range indices and, where ``idx`` holds
  duplicates, the LAST update wins (XLA's CPU scatter applies updates in
  order). torch's ``index_put_`` raises on out-of-range indices and leaves
  the winner of a duplicate unspecified (on the card it races).
  ``scatter_set`` keeps only in-range rows and the last writer of each
  index, so the result is the same on the CPU and on the card.
* ``lax.top_k`` breaks ties by the lower index; the order of ties in
  ``torch.topk`` is unspecified. ``topk`` sorts stably instead.
* ``x.at[idx].add / max / min`` drop out-of-range indices.
"""

from __future__ import annotations

import torch


def topk(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: values descending, ties broken by the
    lower index. Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _flat_rows(dst, idx, vals):
    n0 = dst.shape[0]
    idx = idx.reshape(-1).long()
    vals = vals.reshape((idx.shape[0],) + tuple(dst.shape[1:]))
    ok = (idx >= 0) & (idx < n0)
    return idx[ok], vals[ok]


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Functional ``dst.at[idx].set(vals)``: out-of-range rows are dropped,
    and among duplicate indices the last update wins."""
    if not torch.is_tensor(vals):
        vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device)
    shape = (idx.numel(),) + tuple(dst.shape[1:])
    if vals.numel() == torch.Size(shape).numel() and vals.dim() > 0:
        vals = vals.reshape(shape)
    else:
        vals = vals.expand(shape)
    vals = vals.to(dst.dtype)
    i, v = _flat_rows(dst, idx, vals)
    out = dst.clone()
    if i.numel() == 0:
        return out
    order = torch.argsort(i, stable=True)
    s = i[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    sel = order[last]
    out[i[sel]] = v[sel]
    return out


def scatter_set2(dst, i0, i1, vals):
    """``dst.at[i0, i1].set(vals)`` over the first two axes (broadcast
    index arrays), same semantics as scatter_set."""
    n0, n1 = dst.shape[0], dst.shape[1]
    i0, i1 = torch.broadcast_tensors(i0.long(), i1.long())
    ok = (i0 >= 0) & (i0 < n0) & (i1 >= 0) & (i1 < n1)
    lin = torch.where(ok, i0 * n1 + i1, torch.full_like(i0, n0 * n1))
    flat = dst.reshape((n0 * n1,) + tuple(dst.shape[2:]))
    out = scatter_set(flat, lin, vals)
    return out.reshape(dst.shape)


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Functional ``dst.at[idx].add(vals)`` with out-of-range drop."""
    i, v = _flat_rows(dst, idx, vals.to(dst.dtype))
    out = dst.clone()
    out.index_add_(0, i, v)
    return out


def scatter_or(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Functional ``dst.at[idx].max(vals)`` for bool arrays."""
    vals = torch.as_tensor(vals, device=dst.device).to(torch.bool)
    vals = vals.expand(idx.shape) if vals.dim() == 0 else vals
    i, v = _flat_rows(dst, idx, vals)
    out = dst.clone()
    out[i[v]] = True
    return out


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Functional ``dst.at[idx].min(vals)`` for a 1-D dst."""
    i, v = _flat_rows(dst, idx, vals.to(dst.dtype))
    out = dst.clone()
    out.scatter_reduce_(0, i, v, reduce="amin", include_self=True)
    return out
