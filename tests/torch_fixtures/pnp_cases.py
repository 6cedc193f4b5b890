"""Seeded PnP correspondences (numpy), shared by tests/test_torch_reloc.py
and make_reference.py ``pnp_cases``: the TUM camera, a random pose and
world points in front of it, projected with pixel noise, a share of them
replaced by uniform outliers."""

from __future__ import annotations

import numpy as np

TUM = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
           bf=40.0, dist=(0.0,) * 5, width=640.0, height=480.0)
# the seeds of test_pnp_ransac_with_injected_sets_matches_jax
SEEDS = (2, 3, 4)


def rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def correspondences(seed, n=300, inlier_frac=0.8, noise=0.3):
    """pw [n, 3], uv [n, 2], valid [n], true Tcw, inlier truth."""
    rng = np.random.RandomState(seed)
    T = np.eye(4)
    T[:3, :3] = rot(rng.randn(3) * 0.3)
    T[:3, 3] = rng.randn(3) * 0.5
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1)
    Twc = np.linalg.inv(T)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    uv = np.stack([TUM["fx"] * pc[:, 0] / pc[:, 2] + TUM["cx"],
                   TUM["fy"] * pc[:, 1] / pc[:, 2] + TUM["cy"]], -1)
    uv += rng.randn(n, 2) * noise
    good = rng.rand(n) < inlier_frac
    uv[~good] = rng.uniform([0, 0], [640, 480], ((~good).sum(), 2))
    valid = rng.rand(n) < 0.9
    return (pw.astype(np.float32), uv.astype(np.float32), valid,
            T.astype(np.float32), good)
