"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import neither JAX nor the JAX package, so they run where
only the port is installed (``--noconftest`` skips tests/conftest.py,
which configures JAX):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Without a card each test skips (the CPU tests hold the plain versions to
the JAX package). Tolerance: none — the patch kernel is a pure copy.
"""

import numpy as np
import pytest
import torch

from object_slam_tpu_torch.ops import patch as patch_mod


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(seed, H, W, n):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    ys = rng.randint(-40, H + 40, n).astype(np.int32)
    xs = rng.randint(-40, W + 40, n).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (img, ys, xs)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,n", [(480, 640, 241), (32, 32, 7),
                                   (67, 55, 60), (400, 533, 1)])
def test_patch_kernel_matches_plain(H, W, n):
    _card()
    img, ys, xs = _inputs(H * 7 + n, H, W, n)
    before = patch_mod.extract_patches.launches
    got = patch_mod.extract_patches(img, ys, xs)
    torch.cuda.synchronize()
    assert patch_mod.extract_patches.launches == before + 1
    assert torch.equal(got, patch_mod.extract_patches_ref(img, ys, xs))


@pytest.mark.cuda
def test_patch_kernel_rejects_bad_inputs():
    _card()
    img, ys, xs = _inputs(1, 64, 64, 8)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(img.double(), ys, xs)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(img, ys.long(), xs)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(img.t(), ys, xs)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(img[:31], ys, xs)
    with pytest.raises(ValueError):
        patch_mod.extract_patches_cuda(img, ys.cpu(), xs)


@pytest.mark.cuda
def test_patch_kernel_empty_batch_launches_nothing():
    _card()
    img, ys, xs = _inputs(2, 64, 64, 0)
    before = patch_mod.extract_patches.launches
    out = patch_mod.extract_patches(img, ys, xs)
    assert out.shape == (0, 32, 32)
    assert patch_mod.extract_patches.launches == before
