"""ORB front end of the PyTorch port against the JAX package, on the same
numpy inputs at the small verify geometry (160x120, 300 features, 4
levels). Tolerances and their reasons are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.config import (CameraConfig, CapacityConfig, OrbConfig,
                                    SlamConfig)
from object_slam_tpu.datasets.synthetic import SyntheticScene, orbit_poses
from object_slam_tpu.features import extractor as j_ex
from object_slam_tpu.features import fast as j_fast
from object_slam_tpu.features import matching as j_match
from object_slam_tpu.features import pyramid as j_pyr
from object_slam_tpu_torch import config as t_config
from object_slam_tpu_torch.features import extractor as t_ex
from object_slam_tpu_torch.features import fast as t_fast
from object_slam_tpu_torch.features import matching as t_match
from object_slam_tpu_torch.features import pyramid as t_pyr
from torch_fixtures.threads import share_cores

share_cores()


def _cfgs():
    kw = dict(camera=dict(width=160, height=120, fx=130.0, fy=130.0,
                          cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0), bf=13.0,
                          th_depth=40.0, depth_map_factor=1.0),
              orb=dict(n_features=300, n_levels=4),
              caps=dict(n_kp=384, max_points=8192, max_keyframes=64))
    j = SlamConfig(camera=CameraConfig(**kw["camera"]),
                   orb=OrbConfig(**kw["orb"]),
                   caps=CapacityConfig(**kw["caps"]))
    t = t_config.SlamConfig(camera=t_config.CameraConfig(**kw["camera"]),
                            orb=t_config.OrbConfig(**kw["orb"]),
                            caps=t_config.CapacityConfig(**kw["caps"]))
    return j, t


@pytest.fixture(scope="module")
def frame_gray():
    jcfg, _ = _cfgs()
    scene = SyntheticScene.make(jcfg, seed=1, n_objects=2)
    gray, _, _, _ = scene.render_rgbd(orbit_poses(3, step=0.02)[2])
    return gray.astype(np.float32)


@pytest.fixture(scope="module")
def keypoints(frame_gray):
    jcfg, tcfg = _cfgs()
    jk = j_ex.OrbExtractor(jcfg)(jnp.asarray(frame_gray))
    tk = t_ex.OrbExtractor(tcfg, device="cpu")(torch.from_numpy(frame_gray))
    return jax.tree_util.tree_map(np.asarray, jk), tk


def test_pyramid_levels_match(frame_gray):
    """abs <= 1e-3 on 0..255: the port rebuilds jax.image.resize's
    antialiased weights; the products sum in another order."""
    jl = j_pyr.build_pyramid(jnp.asarray(frame_gray), 4, 1.2)
    tl = t_pyr.build_pyramid(torch.from_numpy(frame_gray), 4, 1.2)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3,
                                   rtol=0)


def test_gaussian_blur_wraps_like_reference(frame_gray):
    """abs <= 1e-3: the same 14 rolled adds, in float32."""
    a = np.asarray(j_pyr.gaussian_blur(jnp.asarray(frame_gray)))
    b = t_pyr.gaussian_blur(torch.from_numpy(frame_gray)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-3, rtol=0)


def test_fast_response_exact(frame_gray):
    """Exact: ring differences, arc AND/min and the quantized NMS are the
    same float32 operations on the same input."""
    ja, jb = j_fast.detect_dual(jnp.asarray(frame_gray), 7.0, 20.0, 9, 19)
    ta, tb = t_fast.detect_dual(torch.from_numpy(frame_gray), 7.0, 20.0, 9,
                                19)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


def test_cell_topk_tie_order():
    """Quantized ties resolve to the lowest linear index, as jnp.argmax."""
    rng = np.random.RandomState(3)
    resp = np.floor(rng.uniform(0, 3, (64, 96))).astype(np.float32)
    js, jy, jx = j_ex._cell_topk(jnp.asarray(resp), 16, 3)
    ts, ty, tx = t_ex._cell_topk(torch.from_numpy(resp), 16, 3)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert np.array_equal(tx.numpy(), np.asarray(jx))


def test_brief_operator_matches_reference():
    """The port's gather indices are the nonzeros of the reference's D."""
    pat = np.asarray(j_ex.make_pattern())
    D_ref = np.asarray(j_ex.make_brief_matrix(jnp.asarray(pat)),
                       np.float32)
    D = t_ex.make_brief_matrix(t_ex.make_pattern())
    assert np.array_equal(D, D_ref)


def test_extractor_valid_and_level_identical(keypoints):
    jk, tk = keypoints
    assert np.array_equal(tk.valid.numpy(), jk.valid)
    assert np.array_equal(tk.level.numpy(), jk.level)
    assert jk.valid.sum() > 50


def test_extractor_uv_and_angle(keypoints):
    """uv within 1e-3 px and angle within 1e-4 rad: the level images differ
    by float32 summation order (see test_pyramid_levels_match)."""
    jk, tk = keypoints
    v = jk.valid
    np.testing.assert_allclose(tk.uv.numpy()[v], jk.uv[v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tk.angle.numpy()[v], jk.angle[v], atol=1e-4,
                               rtol=0)


def test_extractor_descriptors_bit_exact(keypoints):
    """Bit-exact wherever the angle bin agrees, and bins agree for >= 99.5%
    of the keypoints (an angle on a bin edge may round either way)."""
    jk, tk = keypoints
    v = jk.valid
    n_bins = t_ex.N_ANGLE_BINS

    def bins(a):
        return np.mod(np.round(a / (2 * np.pi) * n_bins).astype(np.int64),
                      n_bins)

    same_bin = bins(tk.angle.numpy()) == bins(jk.angle)
    assert same_bin[v].mean() >= 0.995
    jd = np.ascontiguousarray(jk.desc).view(np.int32)
    sel = v & same_bin
    assert np.array_equal(tk.desc.numpy()[sel], jd[sel])


def _desc(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_popcount32_matches_numpy():
    rng = np.random.RandomState(0)
    x = _desc(rng, 500).reshape(-1)
    ref = np.array([bin(int(v)).count("1") for v in x])
    got = t_match.popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    assert np.array_equal(got, ref)


def test_hamming_matrix_exact():
    rng = np.random.RandomState(1)
    a, b = _desc(rng, 70), _desc(rng, 90)
    ref = np.asarray(j_match.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = t_match.hamming_matrix(torch.from_numpy(a.view(np.int32)),
                                 torch.from_numpy(b.view(np.int32))).numpy()
    assert np.array_equal(got, ref)


def _perturbed(rng, base, flips):
    out = base.copy()
    for i in range(out.shape[0]):
        for _ in range(flips):
            w, bit = rng.randint(8), rng.randint(32)
            out[i, w] ^= np.uint32(1 << bit)
    return out


def test_brute_match_exact():
    """Exact: integer distances, first-index argmin and stable ties."""
    rng = np.random.RandomState(2)
    b = _desc(rng, 80)
    a = _perturbed(rng, b[rng.permutation(80)[:60]], 12)
    a = np.concatenate([a, _desc(rng, 20)])
    va = rng.rand(80) > 0.1
    vb = rng.rand(80) > 0.1
    ang_a = rng.uniform(-np.pi, np.pi, 80).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 80).astype(np.float32)
    ji, jm = j_match.brute_match(jnp.asarray(a), jnp.asarray(va),
                                 jnp.asarray(b), jnp.asarray(vb),
                                 angle_a=jnp.asarray(ang_a),
                                 angle_b=jnp.asarray(ang_b))
    ti, tm = t_match.brute_match(
        torch.from_numpy(a.view(np.int32)), torch.from_numpy(va),
        torch.from_numpy(b.view(np.int32)), torch.from_numpy(vb),
        angle_a=torch.from_numpy(ang_a), angle_b=torch.from_numpy(ang_b))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.asarray(jm).sum() > 10


@pytest.mark.parametrize("mode", ["ratio", "levels", "rotation"])
def test_search_by_projection_exact(mode):
    rng = np.random.RandomState({"ratio": 3, "levels": 4, "rotation": 5}[mode])
    N, M = 120, 90
    kp_desc = _desc(rng, N)
    kp_uv = rng.uniform(0, 160, (N, 2)).astype(np.float32)
    kp_level = rng.randint(0, 4, N).astype(np.int32)
    kp_valid = rng.rand(N) > 0.05
    kp_ur = np.where(rng.rand(N) > 0.3, kp_uv[:, 0] - 5.0, -1.0) \
        .astype(np.float32)
    src = rng.randint(0, N, M)
    proj_desc = _perturbed(rng, kp_desc[src], 8)
    proj_uv = (kp_uv[src] + rng.normal(0, 2, (M, 2))).astype(np.float32)
    proj_level = kp_level[src]
    proj_valid = rng.rand(M) > 0.05
    proj_ur = (proj_uv[:, 0] - 5.0).astype(np.float32)
    radius = np.full(M, 6.0, np.float32)
    kw_j, kw_t = {}, {}
    if mode == "ratio":
        kw = dict(nn_ratio=0.9)
    elif mode == "levels":
        lo = (proj_level - 1).astype(np.int32)
        hi = np.full(M, 3, np.int32)
        kw = dict(nn_ratio=None)
        kw_j = dict(lvl_lo=jnp.asarray(lo), lvl_hi=jnp.asarray(hi),
                    kp_ur=jnp.asarray(kp_ur), proj_ur=jnp.asarray(proj_ur),
                    r_ur=jnp.asarray(radius))
        kw_t = dict(lvl_lo=torch.from_numpy(lo), lvl_hi=torch.from_numpy(hi),
                    kp_ur=torch.from_numpy(kp_ur),
                    proj_ur=torch.from_numpy(proj_ur),
                    r_ur=torch.from_numpy(radius))
    else:
        aa = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
        ab = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
        kw = dict(nn_ratio=None)
        kw_j = dict(angle_a=jnp.asarray(aa), angle_b=jnp.asarray(ab))
        kw_t = dict(angle_a=torch.from_numpy(aa), angle_b=torch.from_numpy(ab))
    ji, jm = j_match.search_by_projection(
        jnp.asarray(proj_uv), jnp.asarray(proj_level), jnp.asarray(proj_desc),
        jnp.asarray(proj_valid), jnp.asarray(kp_uv), jnp.asarray(kp_level),
        jnp.asarray(kp_desc), jnp.asarray(kp_valid), jnp.asarray(radius),
        th_dist=100, **kw, **kw_j)
    ti, tm = t_match.search_by_projection(
        torch.from_numpy(proj_uv), torch.from_numpy(proj_level),
        torch.from_numpy(proj_desc.view(np.int32)),
        torch.from_numpy(proj_valid), torch.from_numpy(kp_uv),
        torch.from_numpy(kp_level), torch.from_numpy(kp_desc.view(np.int32)),
        torch.from_numpy(kp_valid), torch.from_numpy(radius),
        th_dist=100, **kw, **kw_t)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.asarray(jm).sum() > 5
