"""Batched hypothesize-and-verify RANSAC: the minimal-set sampler.

Counterpart of object_slam_tpu/solvers/ransac.py::sample_minimal_sets:
every trial's index set is drawn up front by Gumbel top-k over the valid
entries, so each trial holds k distinct valid indices (when that many
exist). The reference draws from a ``jax.random`` key; the port draws from
an explicit ``torch.Generator``. The two streams differ, so tests that
compare the packages inject the reference's index sets instead
(solvers/epnp.py::pnp_ransac_sets).

The fundamental-matrix RANSAC of the reference belongs to the mono slice.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.ops.scatter import topk


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
