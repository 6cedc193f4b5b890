"""The port's patch extraction (object_slam_tpu_torch/ops/patch.py) against
the JAX package's contract (extract_patches_xla) and its Pallas kernel.

On the CPU the port runs its plain version; the CUDA kernel itself is
held against that plain version by tests/test_torch_kernels_cuda.py (run
on a card) and by chip_smoke.py. Tolerance: none — the op is a pure
copy, so every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.ops.patch_pallas import (extract_patches as
                                              pallas_extract_patches,
                                              extract_patches_xla)
from object_slam_tpu_torch.ops import patch as patch_mod
from torch_fixtures.threads import share_cores

share_cores()


def _inputs(seed, H=120, W=160, n=64, lo=-20):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    ys = rng.randint(lo, H + 20, n).astype(np.int32)
    xs = rng.randint(lo, W + 20, n).astype(np.int32)
    # make sure every clamp branch is hit
    ys[:4] = [-7, H - 32, H - 31, H + 5]
    xs[:4] = [W + 9, -1, W - 32, 0]
    return img, ys, xs


@pytest.mark.parametrize("seed,H,W", [(0, 120, 160), (1, 32, 32),
                                      (2, 48, 200), (3, 333, 41)])
def test_matches_xla_contract_bitwise(seed, H, W):
    img, ys, xs = _inputs(seed, H, W)
    ref = np.asarray(extract_patches_xla(jnp.asarray(img), jnp.asarray(ys),
                                         jnp.asarray(xs)))
    got = patch_mod.extract_patches(torch.from_numpy(img),
                                    torch.from_numpy(ys),
                                    torch.from_numpy(xs)).numpy()
    assert got.shape == ref.shape == (len(ys), 32, 32)
    assert np.array_equal(got, ref)


def test_matches_pallas_kernel_interpret_bitwise():
    """The TPU kernel itself, run in Pallas interpret mode on the CPU, at
    8 corners in [-20, 120) x [-20, 160) of a 120x160 image."""
    img, ys, xs = _inputs(7, 120, 160, n=8)
    ref = np.asarray(pallas_extract_patches(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), interpret=True))
    got = patch_mod.extract_patches(torch.from_numpy(img),
                                    torch.from_numpy(ys),
                                    torch.from_numpy(xs)).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed,shapes", [
    (8, [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309),
         (193, 257), (161, 214), (134, 179)]),
    (9, [(32, 32), (67, 55), (120, 160), (33, 35)] * 4)])
def test_levels_plain_version_matches_xla_contract_per_level(seed, shapes):
    """extract_patches_levels' plain version (a level slot per window, the
    slots in any order, up to 16 levels) equals extract_patches_xla on
    each window's level, bit for bit; a slot outside the table gives a
    zero window."""
    rng = np.random.RandomState(seed)
    imgs = [rng.uniform(0, 255, hw).astype(np.float32) for hw in shapes]
    n = 40 * len(shapes)
    lvl = rng.randint(-1, len(shapes) + 1, n).astype(np.int32)
    ys = np.array([rng.randint(-20, shapes[l][0] + 20) if 0 <= l < len(
        shapes) else 0 for l in lvl], np.int32)
    xs = np.array([rng.randint(-20, shapes[l][1] + 20) if 0 <= l < len(
        shapes) else 0 for l in lvl], np.int32)
    got = patch_mod.extract_patches_levels(
        [torch.from_numpy(im) for im in imgs], torch.from_numpy(ys),
        torch.from_numpy(xs), torch.from_numpy(lvl)).numpy()
    assert got.shape == (n, 32, 32)
    for l, im in enumerate(imgs):
        sel = lvl == l
        ref = np.asarray(extract_patches_xla(
            jnp.asarray(im), jnp.asarray(ys[sel]), jnp.asarray(xs[sel])))
        assert np.array_equal(got[sel], ref)
    out = (lvl < 0) | (lvl >= len(shapes))
    assert out.any() and not got[out].any()


def test_levels_wrapper_never_falls_back_to_cpu():
    img, ys, xs = _inputs(10)
    lvl = np.zeros_like(ys)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_levels_cuda(
            [torch.from_numpy(img)], torch.from_numpy(ys),
            torch.from_numpy(xs), torch.from_numpy(lvl))


def test_cpu_path_counts_no_launch():
    before = patch_mod.extract_patches.launches
    img, ys, xs = _inputs(4)
    patch_mod.extract_patches(torch.from_numpy(img), torch.from_numpy(ys),
                              torch.from_numpy(xs))
    assert patch_mod.extract_patches.launches == before == 0


def test_kernel_wrapper_never_falls_back_to_cpu():
    img, ys, xs = _inputs(5)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(torch.from_numpy(img),
                                       torch.from_numpy(ys),
                                       torch.from_numpy(xs))


def test_plain_version_clamps_like_reference_at_extremes():
    img = np.arange(40 * 50, dtype=np.float32).reshape(40, 50)
    ys = np.array([-1000, 1000, 3], np.int32)
    xs = np.array([1000, -1000, 7], np.int32)
    got = patch_mod.extract_patches_ref(torch.from_numpy(img),
                                        torch.from_numpy(ys),
                                        torch.from_numpy(xs)).numpy()
    assert np.array_equal(got[0], img[0:32, 18:50])
    assert np.array_equal(got[1], img[8:40, 0:32])
    assert np.array_equal(got[2], img[3:35, 7:39])
