"""A patch corpus that every machine builds bit for bit (numpy integer
arithmetic only), for holding the BRIEF-pattern selection of the port
(scripts/train_brief_pattern_torch.py::TestSelector) to the reference's
(scripts/train_brief_pattern.py::main) on the same corpus: a harvested
corpus differs between the packages in its floats (the IC angles), which
moves the tests' means and so the whole greedy order."""

from __future__ import annotations

import numpy as np

PATCH = 32
CELL = 4


def integer_corpus(n: int, seed: int = 0) -> np.ndarray:
    """[n, 32, 32] float64 patches with integer values: 9 x 9 knots drawn
    from RandomState(seed) in 0..255, interpolated over 4-pixel cells with
    integer bilinear weights (values up to 255 * 16)."""
    rng = np.random.RandomState(seed)
    knots = rng.randint(0, 256, (n, PATCH // CELL + 1, PATCH // CELL + 1))
    i = np.arange(PATCH)
    f = i % CELL
    W = np.zeros((PATCH, PATCH // CELL + 1), np.int64)
    W[i, i // CELL] = CELL - f
    W[i, i // CELL + 1] = f
    out = np.einsum("yk,nkl,xl->nyx", W, knots.astype(np.int64), W)
    return out.astype(np.float64)


def window_hashes(patches):
    """A 16-bit hash of each [32, 32] float64 window's bits (integer
    arithmetic: the same on every machine), [n] uint16: equal windows hash
    equal, and two windows that differ collide with probability 2^-16."""
    bits = np.ascontiguousarray(patches, np.float64).reshape(
        patches.shape[0], -1).view(np.uint64)
    mult = (np.arange(bits.shape[1], dtype=np.uint64) * np.uint64(2)
            + np.uint64(0x9E3779B97F4A7C15))
    h = (bits * mult[None, :]).sum(1, dtype=np.uint64)
    return (h >> np.uint64(48)).astype(np.uint16)
