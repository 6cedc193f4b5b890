"""Keyframe database: BoW place-recognition queries.

Counterpart of object_slam_tpu/loop/kfdb.py. BoW rows live as a dense
[K, W] matrix in the map (``kf_bow``); "common words" is one boolean
reduction and the scores one L1 sweep, in place of DBoW2's inverted index
(KeyFrameDatabase.cc:76-310).
"""

from __future__ import annotations

import torch

from object_slam_tpu_torch.loop.vocabulary import l1_score


def detect_loop_candidates(kf_bow, kf_valid, query_bow, query_id,
                           covis_row, min_score):
    """[K] candidate mask and [K] scores: valid keyframes, not the query
    and not covisible with it, sharing more than 0.8x the most common
    words, scoring at least min_score."""
    K = kf_bow.shape[0]
    ids = torch.arange(K, device=kf_bow.device)
    eligible = kf_valid & ~covis_row & (ids != query_id)
    common = torch.sum((kf_bow > 0) & (query_bow > 0)[None, :], dim=-1)
    common = torch.where(eligible, common, torch.zeros_like(common))
    word_ok = common > 0.8 * torch.max(common)
    scores = l1_score(kf_bow, query_bow[None, :])
    return eligible & word_ok & (scores >= min_score), scores


def aggregate_group_scores(cand_mask, scores, covis, top_n: int = 10):
    """Covisibility-group score aggregation and the 0.75x-best gate
    (KeyFrameDatabase.cc:130-197); covis [K, K] int32 weights. The
    {0, 1} x f32 product runs in f32 (TF32 is off package-wide)."""
    K = covis.shape[0]
    member = (covis > 0) | torch.eye(K, dtype=torch.bool,
                                     device=covis.device)
    s = torch.where(cand_mask, scores, torch.zeros_like(scores))
    group_score = member.to(torch.float32) @ s
    group_score = torch.where(cand_mask, group_score,
                              torch.zeros_like(group_score))
    keep = cand_mask & (group_score >= 0.75 * torch.max(group_score))
    return keep, group_score


def detect_reloc_candidates(kf_bow, kf_valid, query_bow):
    """[K] relocalization candidates (relative word gate only) and
    scores."""
    common = torch.sum((kf_bow > 0) & (query_bow > 0)[None, :], dim=-1)
    common = torch.where(kf_valid, common, torch.zeros_like(common))
    max_common = torch.clamp(torch.max(common), min=1)
    word_ok = common > 0.8 * max_common
    scores = l1_score(kf_bow, query_bow[None, :])
    return kf_valid & word_ok, scores
