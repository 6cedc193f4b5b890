"""The port's frame-wide ORB describe (object_slam_tpu_torch/ops/describe.py)
against the JAX package's per-level chain, on the same numpy inputs.

The JAX chain is what the reference extractor runs per level:
extract_patches_xla -> _ic_angle_from_patches on the raw level, and
gaussian_blur -> extract_patches_xla -> _brief_from_patches (with
make_brief_matrix) for the descriptor. On the CPU the port runs its plain
version; the CUDA kernel (csrc/orb_describe.cu) is held against that plain
version on a card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
Here its algorithm (wrapped halo, in-block blur, moments, bin, bit layout)
is written out in plain torch and held to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.features import extractor as j_ex
from object_slam_tpu.features import pyramid as j_pyr
from object_slam_tpu.ops.patch_pallas import extract_patches_xla
from object_slam_tpu_torch.features import extractor as t_ex
from object_slam_tpu_torch.features import pyramid as t_pyr
from object_slam_tpu_torch.ops import describe as d_mod

TUM_VGA = t_pyr.level_shapes(480, 640, 8, 1.2)
SMALL = t_pyr.level_shapes(120, 160, 4, 1.2)


def _image(rng, H, W):
    """Smooth random texture in 0..255 (sinusoids plus a little noise), so
    that most IC angles pass the stability gate."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.full((H, W), 128.0, np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(-0.15, 0.15, 2)
        img += rng.uniform(10, 30) * np.sin(fy * y + fx * x
                                            + rng.uniform(0, 6.3))
    img += rng.normal(0, 2.0, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


def _inputs(seed, shapes, per_level):
    """Levels, and per_level corners on each with a quarter of them past a
    border (every border and corner appears), sorted by level."""
    rng = np.random.RandomState(seed)
    levels, cy, cx, lvl = [], [], [], []
    for l, (H, W) in enumerate(shapes):
        levels.append(_image(rng, H, W))
        ys = rng.randint(0, H - 31, per_level)
        xs = rng.randint(0, W - 31, per_level)
        n_out = per_level // 4
        ys[:n_out] = rng.choice([-40, -16, -1, H - 31, H - 16, H + 10], n_out)
        xs[:n_out] = rng.choice([-40, -16, -1, W - 31, W - 16, W + 10], n_out)
        cy.append(ys)
        cx.append(xs)
        lvl.append(np.full(per_level, l))
    cat = [np.concatenate(a).astype(np.int32) for a in (cy, cx, lvl)]
    return levels, cat[0], cat[1], cat[2]


def _bins(a):
    n = d_mod.N_ANGLE_BINS
    return np.mod(np.round(a / (2 * np.pi) * n).astype(np.int64), n)


def _brief_tables():
    i1, i2 = t_ex.make_brief_index(t_ex.make_pattern())
    return (torch.from_numpy(i1.astype(np.int16)),
            torch.from_numpy(i2.astype(np.int16)))


def _run_ref(levels, cy, cx, lvl, radius=15):
    i1, i2 = _brief_tables()
    ang, desc = d_mod.orb_describe(
        [torch.from_numpy(x) for x in levels], torch.from_numpy(cy),
        torch.from_numpy(cx), torch.from_numpy(lvl), i1, i2, radius=radius)
    return ang.numpy(), desc.numpy()


@pytest.mark.parametrize("name,shapes,per_level,seed",
                         [("tum_vga", TUM_VGA, 16, 0),
                          ("small", SMALL, 40, 1)])
def test_ref_matches_jax_chain(name, shapes, per_level, seed):
    """Angles within 1e-4 rad and descriptors bit-exact where the bins
    agree (>= 99.5% of keypoints), as test_torch_features states for the
    extractor: the blur is the same 14 float32 rolled adds, the moments sum
    in another order."""
    levels, cy, cx, lvl = _inputs(seed, shapes, per_level)
    ang, desc = _run_ref(levels, cy, cx, lvl)
    D = j_ex.make_brief_matrix(j_ex.make_pattern())
    j_ang, j_desc = [], []
    for l, img in enumerate(levels):
        sel = lvl == l
        im = jnp.asarray(img)
        ys, xs = jnp.asarray(cy[sel]), jnp.asarray(cx[sel])
        a = j_ex._ic_angle_from_patches(extract_patches_xla(im, ys, xs))
        p_blur = extract_patches_xla(j_pyr.gaussian_blur(im), ys, xs)
        j_ang.append(np.asarray(a))
        j_desc.append(np.asarray(j_ex._brief_from_patches(p_blur, a, D)))
    j_ang = np.concatenate(j_ang)
    j_desc = np.ascontiguousarray(np.concatenate(j_desc)).view(np.int32)
    assert (j_ang != 0).mean() > 0.5          # the gate passes most angles
    d = np.angle(np.exp(1j * (ang.astype(np.float64) - j_ang)))
    assert np.abs(d).max() <= 1e-4
    same = _bins(ang) == _bins(j_ang)
    assert same.mean() >= 0.995
    assert np.array_equal(desc[same], j_desc[same])


def _kernel_blur_window(img, y0, x0):
    """The kernel's blur of one window, step by step: gather the 38x38 raw
    window with wrapped rows and columns, a horizontal pass over 38 rows,
    a vertical pass over 32, each tap a separately rounded multiply and
    add in the plain version's tap order."""
    H, W = img.shape
    w = [float(v) for v in t_pyr.blur_weights()]
    rows = torch.remainder(torch.arange(38) + y0 - 3, H)
    cols = torch.remainder(torch.arange(38) + x0 - 3, W)
    win = img[rows[:, None], cols[None, :]]
    hor = torch.zeros(38, 32)
    for q in range(7):
        hor = hor + w[q] * win[:, q:q + 32]
    out = torch.zeros(32, 32)
    for q in range(7):
        out = out + w[q] * hor[q:q + 32, :]
    return win, out


@pytest.mark.parametrize("H,W", [(32, 32), (69, 93), (134, 179)])
def test_kernel_blur_window_is_bitwise_the_blurred_level(H, W):
    """Every border and corner: the wrapped 38x38 window blurred in the
    block equals gaussian_blur(level)[y:y+32, x:x+32] bit for bit."""
    img = torch.from_numpy(_image(np.random.RandomState(H), H, W))
    full = t_pyr.gaussian_blur(img)
    for y0 in (0, (H - 32) // 2, H - 32):
        for x0 in (0, (W - 32) // 2, W - 32):
            win, got = _kernel_blur_window(img, y0, x0)
            assert torch.equal(win[3:35, 3:35], img[y0:y0 + 32, x0:x0 + 32])
            assert torch.equal(got, full[y0:y0 + 32, x0:x0 + 32])


def _kernel_emulation(levels, cy, cx, lvl, idx1, idx2, radius=15, tau=0.02):
    """The kernel's arithmetic per keypoint: moments summed in float64,
    rounded to float32, then the plain version's float32 gate, atan2 and
    bin; the blurred window rounded to bf16; bit t of word t // 32 from
    the bin's two samples (the warp ballot's layout)."""
    n = cy.shape[0]
    d = np.arange(32) - 15
    dy, dx = np.meshgrid(d, d, indexing="ij")
    circ = dy * dy + dx * dx <= radius * radius
    f32 = np.float32
    ang = np.zeros(n, f32)
    desc = np.zeros((n, 8), np.int64)
    for k in range(n):
        img = levels[lvl[k]]
        H, W = img.shape
        y0 = min(max(int(cy[k]), 0), H - 32)
        x0 = min(max(int(cx[k]), 0), W - 32)
        win, blur = _kernel_blur_window(img, y0, x0)
        p = win[3:35, 3:35].numpy().astype(np.float64)[circ]
        m10 = f32((p * dx[circ]).sum())
        m01 = f32((p * dy[circ]).sum())
        mass = f32(np.abs(p).sum()) * f32(radius)
        mag = np.sqrt(m10 * m10 + m01 * m01)
        a = np.arctan2(m01, m10) if mag > f32(tau) * mass else f32(0)
        ang[k] = a
        b = int(np.rint(f32(a) / f32(2 * np.pi) * f32(64))) & 63
        flat = blur.reshape(-1).to(torch.bfloat16).float().numpy()
        bits = flat[idx2[b].long().numpy()] > flat[idx1[b].long().numpy()]
        desc[k] = (bits.reshape(8, 32).astype(np.int64)
                   << np.arange(32)).sum(-1)
    return ang, np.where(desc >= 2 ** 31, desc - 2 ** 32, desc) \
        .astype(np.int32)


def test_kernel_arithmetic_within_stated_tolerance_of_plain_version():
    """The tolerance chip_smoke.py holds the kernel to: angles within 1e-5
    rad (mod 2 pi) except where the plain version's stability margin
    |mag - tau*mass| is below 1e-4 tau mass, bits exact where the bins
    agree, bins agree for >= 99.9%. Here on the kernel's arithmetic,
    written out, at all eight TUM-VGA level shapes."""
    levels, cy, cx, lvl = _inputs(5, TUM_VGA, 12)
    i1, i2 = _brief_tables()
    tl = [torch.from_numpy(x) for x in levels]
    ang, desc = _run_ref(levels, cy, cx, lvl)
    k_ang, k_desc = _kernel_emulation(tl, cy, cx, lvl, i1, i2)
    d = np.abs(np.angle(np.exp(1j * (k_ang.astype(np.float64) - ang))))
    assert d.max() <= 1e-5
    same = _bins(k_ang) == _bins(ang)
    assert same.mean() >= 0.999
    assert np.array_equal(k_desc[same], desc[same])


def test_ref_is_the_extractors_per_level_chain():
    """orb_describe_ref on a level set equals running the blur, the two
    patch gathers, the IC angle and BRIEF level by level."""
    from object_slam_tpu_torch.ops.patch import extract_patches_ref
    levels, cy, cx, lvl = _inputs(3, SMALL, 20)
    ang, desc = _run_ref(levels, cy, cx, lvl, radius=13)
    i1, i2 = _brief_tables()
    for l, img in enumerate(levels):
        sel = lvl == l
        im = torch.from_numpy(img)
        ys, xs = torch.from_numpy(cy[sel]), torch.from_numpy(cx[sel])
        a = d_mod._ic_angle_from_patches(extract_patches_ref(im, ys, xs), 13)
        b = d_mod._brief_from_patches(
            extract_patches_ref(t_pyr.gaussian_blur(im), ys, xs), a, i1, i2)
        assert np.array_equal(ang[sel], a.numpy())
        assert np.array_equal(desc[sel], b.numpy())


def test_cpu_path_counts_no_launch():
    levels, cy, cx, lvl = _inputs(4, SMALL, 8)
    before = d_mod.orb_describe.launches
    _run_ref(levels, cy, cx, lvl)
    assert d_mod.orb_describe.launches == before == 0


def test_kernel_wrapper_never_falls_back_to_cpu():
    levels, cy, cx, lvl = _inputs(6, SMALL, 8)
    i1, i2 = _brief_tables()
    with pytest.raises(ValueError):
        d_mod.orb_describe_cuda(
            [torch.from_numpy(x) for x in levels], torch.from_numpy(cy),
            torch.from_numpy(cx), torch.from_numpy(lvl), i1, i2)


def test_extractor_describes_a_frame_in_one_call(monkeypatch):
    """The extractor's second pass calls orb_describe once per frame, with
    every level's keypoints, in level order."""
    from object_slam_tpu_torch import config as t_config
    cfg = t_config.SlamConfig(
        camera=t_config.CameraConfig(width=160, height=120, fx=130.0,
                                     fy=130.0, cx=80.0, cy=60.0,
                                     dist=(0, 0, 0, 0, 0), bf=13.0,
                                     th_depth=40.0, depth_map_factor=1.0),
        orb=t_config.OrbConfig(n_features=300, n_levels=4),
        caps=t_config.CapacityConfig(n_kp=384, max_points=8192,
                                     max_keyframes=64))
    calls = []

    def spy(levels, cy, cx, lvl, *a, **kw):
        calls.append((len(levels), lvl.clone()))
        return d_mod.orb_describe(levels, cy, cx, lvl, *a, **kw)

    monkeypatch.setattr(t_ex, "orb_describe", spy)
    ex = t_ex.OrbExtractor(cfg, device="cpu")
    img = torch.from_numpy(_image(np.random.RandomState(9), 120, 160))
    kp = ex(img)
    assert len(calls) == 1
    n_levels, lvl = calls[0]
    assert n_levels == 4
    assert torch.all(lvl[1:] >= lvl[:-1])
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    assert kp.desc.shape == (384, 8) and kp.angle.shape == (384,)
