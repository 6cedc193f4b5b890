"""Mono (the two-view initializer and the mono system) of the PyTorch port
against the JAX package on the CPU, on the same seeded numpy inputs.

The RANSAC streams of the two packages differ, so the port is handed the
reference's own index sets everywhere (``*_sets`` entry points; the system
run wraps ``SlamSystem._minimal_sets``). Eigen- and singular-vector signs
differ between backends, so decomposition candidates are compared as sets
of motions.

Tolerances: F and H of minimal sets (normalized to [2, 2] = 1), computed
in float64 by both packages, within the null vector's perturbation bound
of each trial's eigengap (in float32 the minimal sets' eigengaps make both
packages' solutions unstable; see the test); epipolar and transfer chi2 1e-3 relative (plus 1e-4
absolute); inlier sets exact; decomposition candidates 1e-4 each, matched
as sets; the initializer: the same ok, T21 within 1e-4, the good set equal
except where a point's two-view gate (reprojection chi2 against thF,
parallax cosine against 0.9998) is within 1e-3 relative of its threshold;
the Sim3 RANSAC with a free scale (mono loop closing): inlier set exact,
T12 1e-4, s12 1e-5. The 160x120 mono system (tests/test_mono.py's scene,
tests/torch_fixtures/mono_small.npz), replayed with the JAX run's
winning index sets and held to the JAX run handed the same ("pinned"):
the same initialization frame and tracked flags; keyframes within 2
frames of those of one of the JAX runs; the initializer's T21, its good
set and the records (camera centers after the Sim(3) alignment, the
monocular gauge; rotations) within 2x the spread of the JAX noise runs
(one ulp in the initializer's pixels and in every mapping pass's input;
or 0.05 deg, a direction cosine of 0.9999, 1e-3 units and 0.1 deg). The port
solves the minimal sets in float64 (solvers/ransac.py), the reference in
float32: its winner's F moves by ~1e-3 under one ulp of its pixels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.config import SlamConfig as JSlamConfig
from object_slam_tpu.geometry import camera as j_cam
from object_slam_tpu.geometry import se3 as j_se3
from object_slam_tpu.solvers import initializer as j_init
from object_slam_tpu.solvers import ransac as j_ransac
from object_slam_tpu.solvers import sim3_solver as j_ss
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SlamConfig,
                                          TrackingConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      orbit_poses)
from object_slam_tpu_torch.geometry import camera as t_cam
from object_slam_tpu_torch.slam.system import SlamSystem
from object_slam_tpu_torch.solvers import initializer as t_init
from object_slam_tpu_torch.solvers import ransac as t_ransac
from object_slam_tpu_torch.solvers import sim3_solver as t_ss
from torch_fixtures.threads import share_cores

share_cores()

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")
JK = j_cam.Intrinsics.from_config(JSlamConfig().camera)
TK = t_cam.Intrinsics.from_config(SlamConfig().camera)
THF = 3.841 * 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _two_view(seed, xi, n=300):
    """tests/test_mono.py's construction: points in a box 3-8 m ahead,
    projected into the identity view and into exp(xi)."""
    key = jax.random.PRNGKey(seed)
    pw = jax.random.uniform(key, (n, 3), minval=jnp.array([-2.0, -2.0, 3.0]),
                            maxval=jnp.array([2.0, 2.0, 8.0]))
    T2 = j_se3.exp(jnp.asarray(xi, jnp.float32))
    uv1 = j_cam.project(JK, pw)
    uv2 = j_cam.project(JK, j_se3.apply(T2, pw[None])[0])
    ok = j_cam.in_image(JK, uv1) & j_cam.in_image(JK, uv2)
    return (np.asarray(uv1), np.asarray(uv2), np.asarray(ok),
            np.asarray(T2))


def _noisy_pairs(seed, n=200, out_frac=0.2):
    rng = np.random.RandomState(seed)
    uv1, uv2, ok, _ = _two_view(seed + 10, [0.4, 0.05, 0.02, 0.02, 0.08,
                                            0.01], n)
    uv2 = uv2 + rng.normal(0, 0.3, uv2.shape).astype(np.float32)
    bad = rng.rand(n) < out_frac
    uv2[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(np.float32)
    return uv1, uv2.astype(np.float32), ok & (rng.rand(n) < 0.95)


def _close_33(got, want, rtol=1e-3):
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale + 1e-6), \
        np.abs(got - want).max()


def _planar_pairs(seed, n=200):
    """Noise-free matches of points on a tilted plane 4-6 m ahead."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-2, 2, (n, 2))
    pw = np.concatenate([xy, (5.0 + 0.3 * xy[:, :1])], 1).astype(np.float32)
    T2 = np.asarray(j_se3.exp(jnp.asarray([0.3, 0.05, 0.02, 0.01, 0.06, 0.0],
                                          jnp.float32)))
    uv1 = np.asarray(j_cam.project(JK, jnp.asarray(pw)))
    uv2 = np.asarray(j_cam.project(JK, jnp.asarray(pw @ T2[:3, :3].T
                                                   + T2[:3, 3])))
    return uv1, uv2, np.ones(n, bool)


def _eigengap(k, p1, p2):
    """Per trial, the second-smallest eigenvalue of the minimal set's A^T A
    over its largest (float64): how well the null vector is determined."""
    from object_slam_tpu_torch.solvers.ransac import _hartley
    p1, p2 = _t(p1), _t(p2)
    if k == 8:
        p1, p2 = _hartley(p1)[0], _hartley(p2)[0]
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    o, z = torch.ones_like(x1), torch.zeros_like(x1)
    if k == 8:
        A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                         o], -1)
    else:
        A = torch.cat([torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1,
                                    -x2], -1),
                       torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1,
                                    -y2], -1)], -2)
    ev = torch.linalg.eigvalsh(A.transpose(-1, -2) @ A)
    return (ev[:, 1] / ev[:, -1]).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_point_and_homography_in_f64(seed):
    """F from 16 batched 8-point sets and H from 16 4-point sets, in
    float64 in both packages. In float32 a minimal set's null vector comes
    from an eigh of A^T A whose eigengap is as small as 1e-7 of its norm on
    these inputs, so the f32 solutions of one package sit up to O(1) from
    the other's (and from the exact one) on such sets. In float64 each
    trial agrees to 1e-9 + 1e-13 / gap of its largest entry, gap the
    eigengap over the largest eigenvalue (a null vector's first-order
    perturbation bound at ~1000 ulp; the unnormalized 4-point DLT's gaps are
    1e-16 to 1e-12 on pixel coordinates)."""
    uv1, uv2, ok, _ = _two_view(seed, [0.5, 0.05, 0.02, 0.01, 0.1, 0.0])
    p1, p2 = uv1.astype(np.float64), uv2.astype(np.float64)
    for k, jf, tf in ((8, j_ransac.eight_point_fundamental,
                       t_ransac.eight_point_fundamental),
                      (4, j_init.homography_4pt, t_init.homography_4pt)):
        idx = np.asarray(j_ransac.sample_minimal_sets(
            jax.random.PRNGKey(seed), uv1.shape[0], jnp.asarray(ok), 16, k))
        with jax.enable_x64(True):
            Mj = np.asarray(jf(jnp.asarray(p1[idx]), jnp.asarray(p2[idx])))
        Mt = tf(_t(p1[idx]), _t(p2[idx])).numpy()
        assert Mj.dtype == Mt.dtype == np.float64
        bound = 1e-9 + 1e-13 / _eigengap(k, p1[idx], p2[idx])
        err = (np.abs(Mt - Mj).max(axis=(1, 2))
               / np.abs(Mj).max(axis=(1, 2)))
        assert np.all(err <= bound), (err, bound)


@pytest.mark.parametrize("seed", [0, 1])
def test_sampson_and_transfer_chi2(seed):
    """The epipolar and transfer chi2 of the same F and H (float32)."""
    uv1, uv2, valid = _noisy_pairs(seed)
    idx = np.asarray(j_ransac.sample_minimal_sets(
        jax.random.PRNGKey(seed), uv1.shape[0], jnp.asarray(valid), 16, 8))
    Fj = j_ransac.eight_point_fundamental(jnp.asarray(uv1[idx]),
                                          jnp.asarray(uv2[idx]))
    Hj = j_init.homography_4pt(jnp.asarray(uv1[idx[:, :4]]),
                               jnp.asarray(uv2[idx[:, :4]]))
    for jf, tf, M in ((j_ransac.sampson_epipolar_chi2,
                       t_ransac.sampson_epipolar_chi2, Fj),
                      (j_init.homography_transfer_chi2,
                       t_init.homography_transfer_chi2, Hj)):
        dj = np.asarray(jf(M, jnp.asarray(uv1), jnp.asarray(uv2)))
        dt = tf(_t(M), _t(uv1), _t(uv2)).numpy()
        np.testing.assert_allclose(dt, dj, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_fundamental_with_reference_sets(seed):
    """ransac_fundamental's key draws the sets that are injected here: the
    same winning trial, its count within 2 and its inlier set equal except
    for at most 2 points whose chi2 under the reference's F is within 10% of
    the threshold (the winner's F itself comes from an f32 eigh of a
    minimal set: see test_eight_point_and_homography_in_f64)."""
    uv1, uv2, valid = _noisy_pairs(seed)
    key = jax.random.PRNGKey(seed + 5)
    idx = np.asarray(j_ransac.sample_minimal_sets(
        key, uv1.shape[0], jnp.asarray(valid), 128, 8))
    Fj, inl_j, n_j = j_ransac.ransac_fundamental(
        key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid))
    Ft, inl_t, n_t = t_ransac.ransac_fundamental_sets(
        _t(idx), _t(uv1), _t(uv2), _t(valid))
    th = 3.84 * 2.0
    dj = np.asarray(j_ransac.sampson_epipolar_chi2(
        Fj[None], jnp.asarray(uv1), jnp.asarray(uv2)))[0]
    flip = inl_t.numpy() != np.asarray(inl_j)
    assert flip.sum() <= 2 and np.all(np.abs(dj[flip] - th) < 0.1 * th)
    assert abs(int(n_t) - int(n_j)) <= 2 and int(n_j) > 100
    # the port's own sampler: k distinct valid indices per trial, and the
    # RANSAC that draws from it finds the same consensus
    gen = torch.Generator().manual_seed(0)
    own = t_ransac.sample_minimal_sets(gen, uv1.shape[0], _t(valid), 64, 8)
    assert bool(torch.all(_t(valid)[own]))
    assert all(len(set(r.tolist())) == 8 for r in own)
    _, inl_o, n_o = t_ransac.ransac_fundamental(gen, _t(uv1), _t(uv2),
                                                _t(valid))
    assert abs(int(n_o) - int(n_j)) <= 0.1 * int(n_j)


def _rot_deg(Ra, Rb):
    c = np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def _match_sets(Rt, tt, Rj, tj, atol=1e-4):
    """Every reference candidate (R, t) has a port candidate within atol,
    one to one."""
    free = list(range(len(Rt)))
    for R, t in zip(Rj, tj):
        hit = [i for i in free
               if np.abs(Rt[i] - R).max() < atol
               and np.abs(tt[i] - t).max() < atol]
        assert hit, (R, t)
        free.remove(hit[0])


def test_decompositions_as_sets():
    """E and H decompositions of a known motion: the candidate sets agree;
    the true motion is among the E candidates."""
    uv1, uv2, ok, T2 = _two_view(0, [0.5, 0.05, 0.02, 0.01, 0.1, 0.0])
    Km = np.array([[JK.fx, 0, JK.cx], [0, JK.fy, JK.cy], [0, 0, 1.0]],
                  np.float32)
    t = T2[:3, 3] / np.linalg.norm(T2[:3, 3])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ T2[:3, :3]).astype(np.float32)
    Rj, tj = (np.asarray(x) for x in j_init.decompose_essential(
        jnp.asarray(E)))
    Rt, tt = (x.numpy() for x in t_init.decompose_essential(_t(E)))
    _match_sets(Rt, tt, Rj, tj)
    assert any(np.abs(R - T2[:3, :3]).max() < 1e-4
               and np.abs(tv - t).max() < 1e-4 for R, tv in zip(Rt, tt))
    # a plane's homography: every Faugeras candidate as the reference's
    n, d = np.array([0.1, 0.0, -1.0]), 5.0
    Hn = T2[:3, :3] + np.outer(T2[:3, 3], n) / d
    H = (Km @ Hn @ np.linalg.inv(Km)).astype(np.float32)
    Rj, tj = (np.asarray(x) for x in j_init.decompose_homography(
        jnp.asarray(H), jnp.asarray(Km)))
    Rt, tt = (x.numpy() for x in t_init.decompose_homography(_t(H),
                                                              _t(Km)))
    _match_sets(Rt, tt, Rj, tj)


def _near_gate(K, T21, uv1, uv2):
    """Points whose two-view gate is within 1e-3 relative of its
    threshold under T21 (the reprojection chi2 against thF in either view,
    the parallax cosine against 0.9998)."""
    from object_slam_tpu_torch.geometry.triangulation import (
        parallax_cos, triangulate_dlt)
    T1 = torch.eye(4)
    T2 = _t(T21)
    xn = [torch.stack([(u[:, 0] - K.cx) / K.fx, (u[:, 1] - K.cy) / K.fy],
                      -1) for u in (_t(uv1), _t(uv2))]
    pw = triangulate_dlt(T1[:3], T2[:3], xn[0], xn[1])
    near = torch.zeros(pw.shape[0], dtype=torch.bool)
    for T, uv in ((T1, _t(uv1)), (T2, _t(uv2))):
        pc = pw @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-6)
        e = ((K.fx * pc[:, 0] / z + K.cx - uv[:, 0]) ** 2
             + (K.fy * pc[:, 1] / z + K.cy - uv[:, 1]) ** 2)
        near |= torch.abs(e - THF) <= 1e-3 * THF
    c2 = -T2[:3, :3].T @ T2[:3, 3]
    pcos = parallax_cos(pw, torch.zeros(3), c2)
    near |= torch.abs(pcos - 0.9998) <= 1e-3 * (1 - 0.9998)
    return near.numpy()


def _hold_init(rt, rj, uv1, uv2):
    assert bool(rt.ok) == bool(rj.ok)
    flip = rt.good.numpy() != np.asarray(rj.good)
    if not bool(rj.ok):
        # a refused initialization marks nothing good; its T21 is the
        # vote's loser and means nothing
        assert not flip.any() and not bool(rt.good.any())
    else:
        np.testing.assert_allclose(rt.T21.numpy(), np.asarray(rj.T21),
                                   atol=1e-4)
        near = _near_gate(TK, np.asarray(rj.T21), uv1, uv2)
        assert not np.any(flip & ~near), np.flatnonzero(flip & ~near)


@pytest.mark.parametrize("case", ["motion", "pure_rotation"])
def test_initialize_mono_with_reference_sets(case):
    """tests/test_mono.py's two cases with the reference's index sets: the
    motion is recovered (same ok, T21, good set), pure rotation refused."""
    if case == "motion":
        seed, xi, key = 0, [0.5, 0.05, 0.02, 0.01, 0.1, 0.0], 1
    else:
        seed, xi, key = 2, [0.0, 0.0, 0.0, 0.0, 0.08, 0.0], 3
    uv1, uv2, ok, T2 = _two_view(seed, xi)
    key = jax.random.PRNGKey(key)
    k1, k2 = jax.random.split(key)
    N = uv1.shape[0]
    idxF = np.asarray(j_ransac.sample_minimal_sets(k1, N, jnp.asarray(ok),
                                                   200, 8))
    idxH = np.asarray(j_ransac.sample_minimal_sets(k2, N, jnp.asarray(ok),
                                                   200, 4))
    rj = j_init.initialize_mono(key, JK, jnp.asarray(uv1), jnp.asarray(uv2),
                                jnp.asarray(ok))
    rt = t_init.initialize_mono_sets(_t(idxF), _t(idxH), TK, _t(uv1),
                                     _t(uv2), _t(ok))
    _hold_init(rt, rj, uv1, uv2)
    if case == "motion":
        assert bool(rt.ok) and int(rt.good.sum()) > 100
        assert np.abs(rt.T21[:3, :3].numpy() - T2[:3, :3]).max() < 0.02
    else:
        assert not bool(rt.ok) and not bool(rt.good.any())


def test_initialize_mono_own_sampler_recovers_motion():
    uv1, uv2, ok, T2 = _two_view(0, [0.5, 0.05, 0.02, 0.01, 0.1, 0.0])
    gen = torch.Generator().manual_seed(3)
    rt = t_init.initialize_mono(gen, TK, _t(uv1), _t(uv2), _t(ok))
    assert bool(rt.ok)
    t_est, t_true = rt.T21[:3, 3].numpy(), T2[:3, 3]
    cos = abs(t_est @ t_true) / (np.linalg.norm(t_est)
                                 * np.linalg.norm(t_true))
    assert cos > 0.99 and np.abs(rt.T21[:3, :3].numpy()
                                 - T2[:3, :3]).max() < 0.02


def test_sim3_ransac_free_scale_with_reference_sets():
    """The Sim3 RANSAC with fix_scale=False (mono loop closing) on pairs
    whose scale is 1.7: the reference's sets injected."""
    rng = np.random.RandomState(4)
    n = 250
    p2 = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                   rng.uniform(2, 5, n)], -1).astype(np.float32)
    R = np.asarray(j_se3.exp(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.02,
                                          0.05], jnp.float32)))[:3, :3]
    p1 = (1.7 * p2 @ R.T + np.array([0.1, -0.05, 0.3])).astype(np.float32)
    p1 += rng.normal(0, 0.002, p1.shape).astype(np.float32)
    bad = rng.rand(n) < 0.3
    p1[bad] += rng.normal(0, 0.5, (bad.sum(), 3)).astype(np.float32)
    valid = rng.rand(n) < 0.9
    key = jax.random.PRNGKey(7)
    sets = np.asarray(j_ransac.sample_minimal_sets(key, n, jnp.asarray(valid),
                                                   256, 3))
    rj = j_ss.sim3_ransac(key, JK, jnp.asarray(p1), jnp.asarray(p2),
                          jnp.asarray(valid), fix_scale=False)
    rt = t_ss.sim3_ransac_sets(_t(sets), TK, _t(p1), _t(p2), _t(valid),
                               fix_scale=False)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok)
    np.testing.assert_allclose(rt.T12.numpy(), np.asarray(rj.T12), atol=1e-4)
    np.testing.assert_allclose(float(rt.s12), float(rj.s12), rtol=1e-5)
    assert abs(float(rt.s12) - 1.7) < 0.02


# ---------------------------------------------------------------------------
# the 160x120 mono system against the JAX runs (mono_small.npz)
# ---------------------------------------------------------------------------

def mono_small_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        sensor="mono",
        tracking=TrackingConfig(min_init_matches=40, min_init_inliers=25))


def mono_small_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=5, n_objects=3, plane_z=7.0)
    rngs = np.random.RandomState(9)
    for b in scene.boxes:
        b['size'] = 1.2
        b['center'] = np.array([rngs.uniform(-1.5, 1.5),
                                rngs.uniform(-1.0, 1.0),
                                rngs.uniform(2.5, 5.0)])
    return scene


def winner_sets(fx, attempt):
    """An initializer attempt's JAX draws reduced to the trials its
    argmaxes picked (chip_smoke.py::winner_sets)."""
    bF, bH = int(fx["attempt_bestF"][attempt]), int(fx["attempt_bestH"][attempt])
    return fx["sets8"][attempt][bF:bF + 1], fx["sets4"][attempt][bH:bH + 1]


def replay_sets(sys_, fx):
    """The system's RANSAC draws replaced by the reference run's, in its
    order: each initializer attempt's winning sets, then the PnP draws;
    returns the list of set sizes drawn."""
    wins = [winner_sets(fx, a) for a in range(len(fx["attempt_ok"]))]
    queues = {8: [torch.from_numpy(w[0]) for w in wins],
              4: [torch.from_numpy(w[1]) for w in wins],
              6: [torch.from_numpy(x) for x in fx["sets6"]]}
    drawn = []

    def minimal_sets(valid, n_trials=256, k=6):
        drawn.append(k)
        return queues[k].pop(0)
    sys_._minimal_sets = minimal_sets
    return drawn


def ensemble(fx):
    """The pinned JAX run's noise runs (one ulp in the initializer's pixels
    and every mapping pass's input) that kept its flags: their keyframe
    frames and the largest record distance (units, deg) from the pinned
    run's (the camera centers after the Sim(3) alignment, aligned_dist),
    and the largest good-set and T21 differences of their
    initializations."""
    kf_sets, dt, dr, flips, deg, omc = [fx["pinned.kf_frames"].tolist()], \
        0.0, 0.0, 0, 0.0, 0.0
    P = fx["pinned.rec_tcw"]
    ok = fx["pinned.tracked"]
    Pc = centers(P[ok])
    Ti = fx["pinned.init.T21"]
    k = 0
    while f"noise{k}.rec_tcw" in fx.files:
        if np.array_equal(fx[f"noise{k}.tracked"], fx["pinned.tracked"]):
            N = fx[f"noise{k}.rec_tcw"]
            kf_sets.append(fx[f"noise{k}.kf_frames"].tolist())
            dt = max(dt, float(aligned_dist(centers(N[ok]), Pc).max()))
            dr = max(dr, max(_rot_deg(a[:3, :3], b[:3, :3])
                             for a, b in zip(N, P)))
            flips = max(flips, int(np.sum(fx[f"noise{k}.init.good"]
                                          != fx["pinned.init.good"])))
            Tn = fx[f"noise{k}.init.T21"]
            deg = max(deg, _rot_deg(Tn[:3, :3], Ti[:3, :3]))
            omc = max(omc, 1 - float(_cos(Tn[:3, 3], Ti[:3, 3])))
        k += 1
    return kf_sets, dt, dr, flips, deg, omc


def centers(recs):
    return np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3]
                     for T in recs])


def aligned_dist(est, ref):
    """Per-record distances of the camera centers est [N, 3] from ref after
    the least-squares similarity (Umeyama) of est onto ref: a monocular
    map is defined up to one, and the initializer fixes it."""
    me, mr = est.mean(0), ref.mean(0)
    e, g = est - me, ref - mr
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(e * e, 1))
    return np.linalg.norm(s * e @ R.T + mr - ref, axis=1)


def _cos(a, b):
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def kf_near(kf_frames, kf_sets, shift=2):
    return any(len(s) == len(kf_frames) and max(
        abs(a - b) for a, b in zip(kf_frames, s)) <= shift for s in kf_sets)


@pytest.fixture(scope="module")
def mono_run():
    fx = np.load(os.path.join(FIXTURES, "mono_small.npz"))
    cfg = mono_small_cfg()
    scene = mono_small_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    drawn = replay_sets(sys_, fx)
    gray_sum = []
    for i, T in enumerate(orbit_poses(len(fx["tracked"]), step=0.06)):
        gray = scene.render_rgbd(T)[0].astype(np.float32)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        sys_.track_mono(gray, timestamp=i / 30.0)
    sys_.flush_mapping()
    return fx, sys_, drawn, gray_sum


def test_mono_system_matches_reference(mono_run):
    """The replayed run against the pinned JAX run: the same draws,
    initialization frame and tracked flags; keyframes within 2 frames of
    one of the JAX runs' (their own decisions move under one ulp); the
    tracked records' camera centers after the Sim(3) alignment, and their
    rotations, within 2x the noise runs' spread (or 1e-3 units / 0.1
    deg)."""
    fx, sys_, drawn, gray_sum = mono_run
    np.testing.assert_allclose(gray_sum, fx["gray_sum"], rtol=1e-12)
    assert drawn == fx["sets_k"].tolist()
    tracked = np.asarray([r.tracked for r in sys_.trajectory])
    np.testing.assert_array_equal(tracked, fx["pinned.tracked"])
    assert int(np.argmax(tracked)) == int(fx["pinned.init_frame"])
    kf_sets, bt, br, _, _, _ = ensemble(fx)
    assert len(kf_sets) >= 3
    m = sys_.map
    kf_frames = m.kf_frame_id[m.kf_valid].numpy().tolist()
    assert kf_near(kf_frames, kf_sets), (kf_frames, kf_sets)
    rec = np.stack([r.Tcw for r in sys_.trajectory])
    P = fx["pinned.rec_tcw"]
    dt = aligned_dist(centers(rec[tracked]), centers(P[tracked])).max()
    dr = max(_rot_deg(a, b) for a, b in zip(rec[:, :3, :3], P[:, :3, :3]))
    print(f"mono small: KFs {kf_frames} (JAX {kf_sets}); records within "
          f"{dt:.6f} units / {dr:.4f} deg (bands {2 * bt:.6f} / "
          f"{2 * br:.4f})")
    assert dt <= max(1e-3, 2 * bt) and dr <= max(0.1, 2 * br)


def test_mono_map_scale_is_the_initializer_baseline(mono_run):
    """The reference's median-depth normalization: jnp.median over the good
    depths with NaN elsewhere is NaN, so the scale stays 1 and the
    initialization frame's translation keeps the unit norm of the
    initializer (ROADMAP.md, queue 3)."""
    fx, sys_, _, _ = mono_run
    i = int(fx["init_frame"])
    for rec in (fx["rec_tcw"][i], fx["pinned.rec_tcw"][i],
                sys_.trajectory[i].Tcw):
        assert abs(np.linalg.norm(rec[:3, 3]) - 1.0) < 1e-5
    # the initializer's winning T21 is that pose
    np.testing.assert_allclose(fx["init.T21"][:3, 3], fx["rec_tcw"][i, :3, 3],
                               atol=1e-6)


def test_mono_keyframes_use_the_rgbd_ratio():
    """The fused chain decides keyframes with sensor_is_mono=False (the
    reference's tracking.py:624, :629): a mono frame with 80% of the
    reference keyframe's matches is not weak (0.75), although the mono
    ratio (0.9) would call it so."""
    import inspect
    from object_slam_tpu.slam import tracking as j_trk
    from object_slam_tpu_torch.slam import tracking as t_trk
    args = (80, 100, 0, 0, 2, 30)
    for mod in (j_trk, t_trk):
        assert not bool(mod.kf_decision(*args, sensor_is_mono=False))
        assert bool(mod.kf_decision(*args, sensor_is_mono=True))
    src = inspect.getsource(t_trk.track_frame_fused)
    assert src.count("sensor_is_mono=False") == 2


def test_mono_initializer_replayed_in_the_system(mono_run):
    """The initializer on the run's matched pair: with the JAX winners'
    sets, the pinned JAX run's outcome (the same ok; T21 and the good set
    within 2x the noise runs' differences, or 0.05 deg / a direction
    cosine of 0.9999 / no flip); with all 200 + 200 JAX sets, the same
    ok."""
    fx, _, _, _ = mono_run
    cfg = mono_small_cfg()
    K = t_cam.Intrinsics.from_config(cfg.camera)
    pair = [_t(fx[k]) for k in ("init.uv1", "init.uv2", "init.valid")]
    kw = dict(min_inliers=cfg.tracking.min_init_inliers)
    a = len(fx["attempt_ok"]) - 1
    rt = t_init.initialize_mono_sets(*(_t(x) for x in winner_sets(fx, a)),
                                     K, *pair, **kw)
    _, _, _, flips, deg, omc = ensemble(fx)
    T21, T21j = rt.T21.numpy(), fx["pinned.init.T21"]
    d = _rot_deg(T21[:3, :3], T21j[:3, :3])
    c = _cos(T21[:3, 3], T21j[:3, 3])
    n_flip = int(np.sum(rt.good.numpy() != fx["pinned.init.good"]))
    print(f"mono small init: {d:.5f} deg, cosine {c:.7f}, {n_flip} flips "
          f"(noise runs: {deg:.5f} deg, cosine {1 - omc:.7f}, {flips})")
    assert bool(rt.ok) == bool(fx["pinned.init.ok"] if "pinned.init.ok"
                               in fx.files else fx["init.ok"])
    assert d <= max(0.05, 2 * deg) and 1 - c <= max(1e-4, 2 * omc)
    assert n_flip <= 2 * flips
    full = t_init.initialize_mono_sets(_t(fx["init.idxF"]),
                                       _t(fx["init.idxH"]), K, *pair, **kw)
    assert bool(full.ok) == bool(fx["init.ok"])


def test_reset_clears_the_mono_reference():
    cfg = mono_small_cfg()
    s = SlamSystem(cfg, enable_objects=False, device="cpu")
    scene = mono_small_scene(cfg)
    s.track_mono(scene.render_rgbd(orbit_poses(1)[0])[0], timestamp=0.0)
    assert s._mono_ref is not None and s.state == 0
    s.reset()
    assert s._mono_ref is None and s.trajectory == []
