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
@pytest.mark.parametrize("level", range(8))
def test_patch_kernel_at_the_brief_harvest_shapes(level):
    """The BRIEF-pattern learner's launches: a VGA pyramid level's blurred
    image (480x640 down by 1.2 per level), the level's keypoint budget of
    corners round(uv / scale) - 15 (their windows clamp at the borders)."""
    _card()
    h, w = pyr.level_shapes(480, 640, 8, 1.2)[level]
    n = ex_mod._level_budgets(1000, 8, 1.2)[level]
    rng = np.random.RandomState(level)
    img = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(
        np.float32)).cuda()
    blurred = pyr.gaussian_blur(img).contiguous()
    ys = torch.from_numpy(rng.randint(0, h, n).astype(np.int32) - 15).cuda()
    xs = torch.from_numpy(rng.randint(0, w, n).astype(np.int32) - 15).cuda()
    before = patch_mod.extract_patches.launches
    got = patch_mod.extract_patches(blurred, ys, xs)
    torch.cuda.synchronize()
    assert patch_mod.extract_patches.launches == before + 1
    assert got.shape == (n, 32, 32)
    assert torch.equal(got, patch_mod.extract_patches_ref(blurred, ys, xs))


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
    (pyr.level_shapes(376, 1241, 8, 1.2), 256),     # KITTI: 2048 keypoints
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
        ([levels[0]] * (dsc.MAX_LEVELS + 1), cy, cx, lvl, i1, i2),
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


def _hold_describe(k_ang, k_desc, args):
    p_ang, p_desc = dsc.orb_describe_ref(*args)
    near = dsc.near_gate(*args[:4])
    err = (torch.remainder(k_ang.double() - p_ang.double() + math.pi,
                           2 * math.pi) - math.pi).abs()
    assert bool(torch.all(err[~near] <= 1e-5))
    same = _bins(k_ang) == _bins(p_ang)
    assert float(same.double().mean()) >= 0.999
    assert torch.equal(k_desc[same], p_desc[same])


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["inside", "border"])
@pytest.mark.parametrize("shapes", [
    [(67, 55), (33, 35), (101, 257), (45, 309)],
    pyr.level_shapes(480, 640, 8, 1.2)])
def test_describe_kernel_inside_and_wrapped_windows(shapes, where):
    """Windows whose 38x38 halo lies inside the level (the 16-byte staging
    path, every row misalignment of odd widths) and windows at the borders
    (the wrapping path), each held to the plain version."""
    _card()
    rng = np.random.RandomState(len(shapes) + len(where))
    levels, cy, cx, lvl = [], [], [], []
    for l, (H, W) in enumerate(shapes):
        levels.append(torch.from_numpy(_texture(rng, H, W)).cuda())
        n = 64
        if where == "inside" and H >= 38 and W >= 38:
            ys = rng.randint(3, H - 34, n)
            xs = rng.randint(3, W - 34, n)
        else:
            ys = rng.choice([-40, -3, 0, 1, 2, H - 34, H - 32, H + 5], n)
            xs = rng.choice([-40, -3, 0, 1, 2, W - 34, W - 32, W + 5], n)
        cy.append(ys)
        cx.append(xs)
        lvl.append(np.full(n, l))
    cat = [torch.from_numpy(np.concatenate(a).astype(np.int32)).cuda()
           for a in (cy, cx, lvl)]
    i1, i2 = ex_mod.make_brief_index(ex_mod.make_pattern())
    idx = [torch.from_numpy(i.astype(np.int16)).cuda() for i in (i1, i2)]
    args = (levels, *cat, *idx)
    k_ang, k_desc = dsc.orb_describe(*args)
    torch.cuda.synchronize()
    _hold_describe(k_ang, k_desc, args)


@pytest.mark.cuda
def test_describe_pair_in_one_launch_equals_two():
    """A stereo pair's 16-level table (a TUM-VGA pyramid and a KITTI one)
    in one launch: each image's half bit-equal to its one-image launch,
    held to the plain version, and level slots outside the table give a
    NaN angle and a zero descriptor."""
    _card()
    a = _describe_inputs(5, pyr.level_shapes(480, 640, 8, 1.2), 64)
    b = _describe_inputs(6, pyr.level_shapes(376, 1241, 8, 1.2), 64)
    levels = a[0] + b[0]
    cy = torch.cat([a[1], b[1]])
    cx = torch.cat([a[2], b[2]])
    lvl = torch.cat([a[3], b[3] + 8])
    call = dsc.OrbDescribe([tuple(t.shape) for t in levels], "cuda", a[4],
                           a[5])
    before = dsc.orb_describe.launches
    ang, desc = call(levels, cy, cx, lvl)
    torch.cuda.synchronize()
    assert dsc.orb_describe.launches == before + 1
    n_a = a[1].shape[0]
    for args, sl in ((a, slice(0, n_a)), (b, slice(n_a, None))):
        one_ang, one_desc = dsc.orb_describe(*args)
        torch.cuda.synchronize()
        assert torch.equal(ang[sl], one_ang)
        assert torch.equal(desc[sl], one_desc)
    _hold_describe(ang, desc, (levels, cy, cx, lvl, a[4], a[5]))
    bad = lvl.clone()
    bad[:5] = torch.tensor([-1, 16, 99, -7, 17], dtype=torch.int32)
    ang2, desc2 = call(levels, cy, cx, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ang2[:5]).all()) and not desc2[:5].any()
    assert torch.equal(ang2[5:], ang[5:]) and torch.equal(desc2[5:], desc[5:])


@pytest.mark.cuda
def test_describe_lean_wrapper_rejects_bad_calls():
    _card()
    levels, cy, cx, lvl, i1, i2 = _describe_inputs(
        7, [(64, 64), (48, 40)], 8)
    call = dsc.OrbDescribe([(64, 64), (48, 40)], "cuda", i1, i2)
    bad = [
        ([levels[0]], cy, cx, lvl),
        ([levels[0], levels[0]], cy, cx, lvl),
        ([levels[0], levels[1].double()], cy, cx, lvl),
        ([levels[0].t().contiguous().t(), levels[1]], cy, cx, lvl),
        ([levels[0].cpu(), levels[1]], cy, cx, lvl),
        (levels, cy.long(), cx, lvl),
        (levels, cy, cx[:-1], lvl),
        (levels, cy, cx, lvl.cpu()),
        (levels, cy[::2], cx[::2], lvl[::2]),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            call(*case)
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    before = dsc.orb_describe.launches
    ang, desc = call(levels, empty, empty, empty)
    assert ang.shape == (0,) and desc.shape == (0, 8)
    assert dsc.orb_describe.launches == before


def _levels_inputs(seed, shapes, n):
    rng = np.random.RandomState(seed)
    levels = [torch.from_numpy(rng.uniform(0, 255, hw).astype(
        np.float32)).cuda() for hw in shapes]
    lvl = rng.randint(0, len(shapes), n)
    ys = np.array([rng.randint(-40, shapes[l][0] + 40) for l in lvl])
    xs = np.array([rng.randint(-40, shapes[l][1] + 40) for l in lvl])
    return levels, *[torch.from_numpy(a.astype(np.int32)).cuda()
                     for a in (ys, xs, lvl)]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,n", [
    (pyr.level_shapes(480, 640, 8, 1.2), 1017),
    ([(32, 32), (67, 55), (101, 257), (45, 309)] * 4, 600),
    ([(400, 533)], 1)])
def test_patch_levels_kernel_matches_plain(shapes, n):
    """One launch for the windows of every level (up to 16, odd widths:
    rows 16-byte aligned and not), bit for bit the plain version and the
    per-level kernel; slots outside the table give zero windows."""
    _card()
    levels, ys, xs, lvl = _levels_inputs(len(shapes) * 3 + n, shapes, n)
    if n > 1:
        lvl[:3] = -1
    before = patch_mod.extract_patches.launches
    got = patch_mod.extract_patches_levels(levels, ys, xs, lvl)
    torch.cuda.synchronize()
    assert patch_mod.extract_patches.launches == before + 1
    assert torch.equal(got, patch_mod.extract_patches_levels_ref(
        levels, ys, xs, lvl))
    for l, im in enumerate(levels):
        sel = torch.nonzero(lvl == l)[:, 0]
        if sel.numel():
            assert torch.equal(got[sel], patch_mod.extract_patches(
                im, ys[sel].contiguous(), xs[sel].contiguous()))


@pytest.mark.cuda
def test_patch_levels_kernel_rejects_bad_inputs_and_empty_batches():
    _card()
    levels, ys, xs, lvl = _levels_inputs(3, [(64, 64), (40, 50)], 8)
    bad = [
        ([levels[0].double()], ys, xs, lvl),
        ([levels[0].t()], ys, xs, lvl),
        ([levels[0][:31]], ys, xs, lvl),
        ([levels[0]] * (patch_mod.MAX_LEVELS + 1), ys, xs, lvl),
        ([levels[0].cpu()], ys, xs, lvl),
        (levels, ys.long(), xs, lvl),
        (levels, ys, xs[:-1], lvl),
        (levels, ys, xs, lvl.cpu()),
    ]
    for case in bad:
        with pytest.raises(ValueError):
            patch_mod.extract_patches_levels_cuda(*case)
    empty = torch.zeros(0, dtype=torch.int32, device="cuda")
    before = patch_mod.extract_patches.launches
    out = patch_mod.extract_patches_levels(levels, empty, empty, empty)
    assert out.shape == (0, 32, 32)
    assert patch_mod.extract_patches.launches == before

