"""Hierarchical binary vocabulary (the DBoW2 replacement).

Counterpart of object_slam_tpu/loop/vocabulary.py. The tree is stored as
dense level-major center tables ``centers[level]`` of ``branching^(l+1)``
descriptors, so ``transform`` is ``depth`` rounds of a batched Hamming
argmin over ``branching`` children (the first index wins a tie, as the
reference's argmin). Training and the DBoW2 text IO are numpy and
identical to the reference's.

The tables are kept on the host as uint32 and moved to a device on first
use there (int32 with the same bits, as the port stores descriptors).
BoW vectors are dense ``[W]`` tf-idf rows, L1-normalized; similarity is
DBoW2's L1 score ``1 - 0.5 * |v - w|_1``.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import torch

from object_slam_tpu_torch.features.matching import popcount32


def _popcount_np(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_np(a, b):
    """[M, 8]u32 x [C, 8]u32 -> [M, C] int."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount_np(x.reshape(x.shape[0], x.shape[1], -1))


def _bit_majority(descs):
    """[M, 8]u32 -> [8]u32 bitwise majority."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)   # [M, 256]
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs, k, rng, iters=8):
    """Binary k-medians. Returns centers [k, 8]u32, assignment [M]."""
    M = descs.shape[0]
    if M <= k:
        centers = np.zeros((k, 8), np.uint32)
        centers[:M] = descs
        return centers, np.arange(M) % k
    centers = descs[rng.choice(M, k, replace=False)]
    assign = np.zeros(M, np.int64)
    for _ in range(iters):
        d = _hamming_np(descs, centers)
        assign = d.argmin(1)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                centers[c] = _bit_majority(sel)
            else:  # re-seed empty cluster
                centers[c] = descs[rng.randint(M)]
    return centers, assign


class Vocabulary:
    """branching^depth-word tree with level-major center tables."""

    def __init__(self, centers: List[np.ndarray], idf: np.ndarray):
        self.branching = centers[0].shape[0]
        self.depth = len(centers)
        self.n_words = self.branching ** self.depth
        self.centers_np = [np.array(c, np.uint32)
                           for c in centers]
        self.idf_np = np.array(idf, np.float32)
        self._tables = {}          # device -> (centers int32, idf f32)
        self._content_key = None

    # ------------------------------------------------------------------
    @staticmethod
    def train(descs: np.ndarray, branching: int = 10, depth: int = 3,
              seed: int = 0) -> "Vocabulary":
        """descs [M, 8]u32 training pool."""
        rng = np.random.RandomState(seed)
        k = branching
        centers = []
        c0, assign = _kmedians(descs, k, rng)
        centers.append(c0)
        parents = assign
        for level in range(1, depth):
            n_parent = k ** level
            cl = np.zeros((n_parent * k, 8), np.uint32)
            new_assign = np.zeros_like(parents)
            for p in range(n_parent):
                sel = np.nonzero(parents == p)[0]
                if len(sel) == 0:
                    continue
                cp, ap = _kmedians(descs[sel], k, rng)
                cl[p * k:(p + 1) * k] = cp
                new_assign[sel] = p * k + ap
            centers.append(cl)
            parents = new_assign
        n_words = k ** depth
        counts = np.bincount(parents, minlength=n_words).astype(np.float64)
        idf = np.log(max(len(descs), 1) / np.maximum(counts, 1.0))
        return Vocabulary(centers, idf)

    @staticmethod
    def load_dbow2_text(path: str) -> "Vocabulary":
        """Load a DBoW2 text vocabulary (header ``k L scoring weighting``,
        then ``parentId isLeaf b0 .. b31 weight`` per node in creation
        order). The tree is re-laid into dense complete-k-ary tables: an
        early leaf propagates itself down, and a short sibling list pads
        with its first sibling; argmin descent prefers the first of equal
        candidates, so the duplicates are unreachable."""
        with open(path) as f:
            header = f.readline().split()
            k, depth = int(header[0]), int(header[1])
            parent_ids, descs, weights = [], [], []
            for line in f:
                v = line.split()
                if len(v) < 35:
                    continue
                parent_ids.append(int(v[0]))
                descs.append([int(x) for x in v[2:34]])
                weights.append(float(v[34]))
        parent_ids = np.asarray(parent_ids, np.int64)
        descs = np.asarray(descs, np.uint8).view(np.uint32).reshape(-1, 8)
        weights = np.asarray(weights)

        # node ids: 0 = implicit root, file row i = node i+1
        n_nodes = len(parent_ids) + 1
        children = [[] for _ in range(n_nodes)]
        for i, p in enumerate(parent_ids):
            children[p].append(i + 1)

        centers = [np.zeros((k ** (l + 1), 8), np.uint32)
                   for l in range(depth)]
        idf = np.zeros(k ** depth)

        def place(node, level, slot, desc_row, weight):
            centers[level][slot] = descs[desc_row]
            if level == depth - 1:
                idf[slot] = weight
                return
            kids = children[node] if node >= 0 else []
            if not kids:          # early leaf: propagate itself downward
                place(-1, level + 1, slot * k, desc_row, weight)
                for ci in range(1, k):
                    centers[level + 1][slot * k + ci] = descs[desc_row]
                return
            for ci, c in enumerate(kids[:k]):
                place(c, level + 1, slot * k + ci, c - 1, weights[c - 1])
            for ci in range(len(kids), k):   # pad with first sibling
                centers[level + 1][slot * k + ci] = descs[kids[0] - 1]

        roots = children[0]
        for ci, c in enumerate(roots[:k]):
            place(c, 0, ci, c - 1, weights[c - 1])
        for ci in range(len(roots), k):
            if roots:
                centers[0][ci] = descs[roots[0] - 1]
        return Vocabulary(centers, idf)

    def save_dbow2_text(self, path: str):
        """Write the DBoW2 text format: header ``k L 0 0`` (L1 scoring,
        TF-IDF weighting), then ``parentId isLeaf b0..b31 w`` per node in
        level-major order."""
        k, depth = self.branching, self.depth
        offset = [1]
        for l in range(depth):
            offset.append(offset[-1] + k ** (l + 1))
        idf = self.idf_np
        with open(path, "w") as f:
            f.write(f"{k} {depth} 0 0\n")
            for l in range(depth):
                c = self.centers_np[l].view(np.uint8)
                for s in range(k ** (l + 1)):
                    parent = 0 if l == 0 else offset[l - 1] + s // k
                    is_leaf = 1 if l == depth - 1 else 0
                    w = idf[s] if is_leaf else 0.0
                    bytes_str = " ".join(str(int(b)) for b in c[s])
                    f.write(f"{parent} {is_leaf} {bytes_str} {w}\n")

    @staticmethod
    def train_random(branching: int = 10, depth: int = 3, seed: int = 0,
                     n_train: int = 20000) -> "Vocabulary":
        """Seeded random-descriptor vocabulary (a structure-only stand-in
        until a corpus-trained vocabulary is loaded)."""
        rng = np.random.RandomState(seed)
        descs = rng.randint(0, 2 ** 32, (n_train, 8),
                            np.uint64).astype(np.uint32)
        return Vocabulary.train(descs, branching, depth, seed)

    # ------------------------------------------------------------------
    def tables(self, device):
        """(centers [depth] int32 tensors, idf f32) on ``device``."""
        device = torch.device(device)
        if device not in self._tables:
            cs = [torch.as_tensor(c.view(np.int32), device=device)
                  for c in self.centers_np]
            self._tables[device] = (cs, torch.as_tensor(self.idf_np,
                                                        device=device))
        return self._tables[device]

    def transform(self, desc, valid):
        """desc [N, 8] int32, valid [N] -> (word [N] int32 (-1 where not
        valid), bow [W] f32 tf-idf, L1-normed)."""
        centers, idf = self.tables(desc.device)
        k = self.branching
        N = desc.shape[0]
        kk = torch.arange(k, device=desc.device)
        rows = torch.arange(N, device=desc.device)
        node = torch.zeros(N, dtype=torch.long, device=desc.device)
        for level in range(self.depth):
            cand = node[:, None] * k + kk[None, :]            # [N, k]
            cd = centers[level][cand]                         # [N, k, 8]
            dist = popcount32(cd ^ desc[:, None, :]).sum(-1)
            node = cand[rows, torch.argmin(dist, dim=1)]
        # tf counts are sums of ones: exact in f32 in any order
        tf = torch.zeros(self.n_words, dtype=torch.float32,
                         device=desc.device)
        tf.index_add_(0, torch.clamp(node, 0, self.n_words - 1),
                      valid.to(torch.float32))
        bow = tf * idf
        bow = bow / torch.clamp(torch.sum(torch.abs(bow)), min=1e-9)
        word = torch.where(valid, node.to(torch.int32),
                           torch.full_like(node, -1, dtype=torch.int32))
        return word, bow

    def content_key(self) -> str:
        """Digest of the tree content (the reference's key, byte for
        byte)."""
        if self._content_key is None:
            h = hashlib.sha1()
            for c in self.centers_np:
                h.update(c.tobytes())
            h.update(self.idf_np.tobytes())
            self._content_key = h.hexdigest()
        return self._content_key


def l1_score(bow_a, bow_b):
    """DBoW2 L1 similarity 1 - 0.5 * ||a - b||_1 of L1-normalized rows:
    [..., W] x [..., W] -> [...]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(bow_a - bow_b), dim=-1)
