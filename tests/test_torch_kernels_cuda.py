"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import neither JAX nor the JAX package, so they run where
only the port is installed (``--noconftest`` skips tests/conftest.py,
which configures JAX):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Without a card each test skips (the CPU tests hold the plain versions to
the JAX package). Tolerances: none for the patch kernel, a pure copy. For
orb_describe, the one chip_smoke.py states: angles within 1e-5 rad (mod
2 pi) except where the plain version's stability margin is below
1e-4 tau mass, descriptors bit-exact where the bins agree, bins agree for
>= 99.9% of keypoints (the moments sum in another order than torch's).
"""

import math

import numpy as np
import pytest
import torch

from object_slam_tpu_torch.features import extractor as ex_mod
from object_slam_tpu_torch.features import pyramid as pyr
from object_slam_tpu_torch.ops import describe as dsc
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


def _texture(rng, H, W):
    """Smooth random texture in 0..255, so that most IC angles pass the
    stability gate."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.full((H, W), 128.0, np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(-0.15, 0.15, 2)
        img += rng.uniform(10, 30) * np.sin(fy * y + fx * x
                                            + rng.uniform(0, 6.3))
    img += rng.normal(0, 2.0, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


def _describe_inputs(seed, shapes, n_per_level):
    rng = np.random.RandomState(seed)
    levels, cy, cx, lvl = [], [], [], []
    for l, (H, W) in enumerate(shapes):
        levels.append(torch.from_numpy(_texture(rng, H, W)).cuda())
        cy.append(rng.randint(-40, H + 40, n_per_level))
        cx.append(rng.randint(-40, W + 40, n_per_level))
        lvl.append(np.full(n_per_level, l))
    cat = [torch.from_numpy(np.concatenate(a).astype(np.int32)).cuda()
           for a in (cy, cx, lvl)]
    i1, i2 = ex_mod.make_brief_index(ex_mod.make_pattern())
    idx = [torch.from_numpy(i.astype(np.int16)).cuda() for i in (i1, i2)]
    return (levels, *cat, *idx)


def _bins(a):
    return torch.remainder(torch.round(
        a / (2.0 * math.pi) * dsc.N_ANGLE_BINS).to(torch.int64),
        dsc.N_ANGLE_BINS)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,n", [
    (pyr.level_shapes(480, 640, 8, 1.2), 128),
    (pyr.level_shapes(120, 160, 4, 1.2), 60),
    ([(32, 32)], 7),
    ([(400, 533)], 1)])
def test_describe_kernel_matches_plain(shapes, n):
    _card()
    args = _describe_inputs(len(shapes) * 31 + n, shapes, n)
    before = dsc.orb_describe.launches
    k_ang, k_desc = dsc.orb_describe(*args)
    torch.cuda.synchronize()
    assert dsc.orb_describe.launches == before + 1
    p_ang, p_desc = dsc.orb_describe_ref(*args)
    near = dsc.near_gate(*args[:4])
    err = (torch.remainder(k_ang.double() - p_ang.double() + math.pi,
                           2 * math.pi) - math.pi).abs()
    assert bool(torch.all(err[~near] <= 1e-5))
    same = _bins(k_ang) == _bins(p_ang)
    assert float(same.double().mean()) >= 0.999
    assert torch.equal(k_desc[same], p_desc[same])
    assert k_desc.shape == (len(shapes) * n, 8)


@pytest.mark.cuda
def test_describe_kernel_rejects_bad_inputs():
    _card()
    levels, cy, cx, lvl, i1, i2 = _describe_inputs(
        3, [(64, 64), (48, 40)], 8)
    bad = [
        ([levels[0].double()], cy, cx, lvl, i1, i2),
        ([levels[0].t()], cy, cx, lvl, i1, i2),
        ([levels[0][:31]], cy, cx, lvl, i1, i2),
        ([levels[0]] * 9, cy, cx, lvl, i1, i2),
        (levels, cy.long(), cx, lvl, i1, i2),
        (levels, cy, cx[:-1], lvl, i1, i2),
        (levels, cy, cx, lvl.cpu(), i1, i2),
        (levels, cy, cx, lvl, i1.long(), i2),
        (levels, cy, cx, lvl, i1, i2[:32]),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            dsc.orb_describe_cuda(*case)


@pytest.mark.cuda
def test_describe_kernel_empty_batch_launches_nothing():
    _card()
    levels, cy, cx, lvl, i1, i2 = _describe_inputs(4, [(64, 64)], 0)
    before = dsc.orb_describe.launches
    ang, desc = dsc.orb_describe(levels, cy, cx, lvl, i1, i2)
    assert ang.shape == (0,) and desc.shape == (0, 8)
    assert dsc.orb_describe.launches == before
