"""Batched tracking: many sequences per card.

Counterpart of object_slam_tpu/parallel/batched_tracking.py, which vmaps
motion-model + local-map tracking over a leading batch axis of
independent sequences (one stacked map and frame per element, one
compiled program). Every argument and result here carries that batch
axis too. The port's tracking reads a few scalars on the host (the pose
solver's convergence exit, the match counts), which no vmap can trace, so
``step`` runs the elements one after another on the card inside one call;
each element's result is what the reference's vmapped, per-element
``while_loop`` gives it.
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.slam import tracking as trk
from object_slam_tpu_torch.slam.map_state import MapState


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def stack_pytrees(trees):
    """Stack a list of NamedTuples of one structure (nested ones, such as
    a frame's detection slab, included) along a new axis 0; a field that
    is None in all of them stays None."""
    first = trees[0]
    return type(first)(*[
        None if v is None else
        stack_pytrees([getattr(t, f) for t in trees]) if _is_tree(v) else
        torch.stack([getattr(t, f) for t in trees])
        for f, v in zip(first._fields, first)])


def index_pytree(tree, b: int):
    """Element b of a stacked NamedTuple (views, no copy)."""
    return type(tree)(*[None if v is None else
                        index_pytree(v, b) if _is_tree(v) else v[b]
                        for v in tree])


class BatchedTracker:
    """Motion-model + local-map tracking over a batch of sequences that
    share the camera model and capacities; their map contents are
    independent."""

    def __init__(self, K, scale_factors, inv_sigma2, log_scale: float,
                 radius_th: float = 15.0):
        self.K = K
        self.scale_factors = scale_factors
        self.inv_sigma2 = inv_sigma2
        self.log_scale = log_scale
        self.radius_th = radius_th

    def one(self, m: MapState, frame, last_uv, last_pt, last_level,
            last_valid, T_pred):
        """One element: track_motion_model -> track_local_map. Returns
        (TrackResult, map)."""
        tr = trk.track_motion_model(
            self.K, m, frame, last_uv, last_pt, last_level, last_valid,
            T_pred, self.scale_factors, self.inv_sigma2,
            radius_th=self.radius_th)
        res, m2, _ = trk.track_local_map(
            self.K, m, frame, tr, self.scale_factors, self.inv_sigma2,
            self.log_scale)
        return res, m2

    def step(self, maps: MapState, frames, last_uv, last_pt, last_level,
             last_valid, T_pred):
        """All arguments carry a leading batch axis B (stacked
        NamedTuples: stack_pytrees). Returns (TrackResult with [B, ...]
        fields, maps with their visibility counters updated)."""
        ms = [index_pytree(maps, b) for b in range(T_pred.shape[0])]
        outs = [self.one(m, index_pytree(frames, b), last_uv[b], last_pt[b],
                         last_level[b], last_valid[b], T_pred[b])
                for b, m in enumerate(ms)]
        res = stack_pytrees([r for r, _ in outs])
        # a field no element changed (local-map tracking changes only the
        # visibility counters) stays the input's stacked tensor
        maps2 = type(maps)(*[
            v if all(getattr(m2, f) is getattr(m, f)
                     for m, (_, m2) in zip(ms, outs))
            else torch.stack([getattr(m2, f) for _, m2 in outs])
            for f, v in zip(maps._fields, maps)])
        return res, maps2
