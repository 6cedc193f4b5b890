"""Geometry and solvers of the PyTorch port against the JAX package on the
same numpy inputs. Local BA's reference comes from the committed fixture
(tests/torch_fixtures/make_reference.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.config import CameraConfig
from object_slam_tpu.geometry import camera as j_cam
from object_slam_tpu.geometry import se3 as j_se3
from object_slam_tpu.geometry import triangulation as j_tri
from object_slam_tpu.solvers import pose_opt as j_po
from object_slam_tpu_torch import config as t_config
from object_slam_tpu_torch.geometry import camera as t_cam
from object_slam_tpu_torch.geometry import se3 as t_se3
from object_slam_tpu_torch.geometry import triangulation as t_tri
from object_slam_tpu_torch.solvers import ba as t_ba
from object_slam_tpu_torch.solvers import pose_opt as t_po
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "slice1.npz")
CAM = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7,
           dist=(0.23, -0.78, -0.003, -0.0001, 0.9), bf=40.0)


def _K():
    return (j_cam.Intrinsics.from_config(CameraConfig(**CAM)),
            t_cam.Intrinsics.from_config(t_config.CameraConfig(**CAM)))


def _poses(rng, n):
    xi = np.concatenate([rng.normal(0, 0.3, (n, 3)),
                         rng.normal(0, 0.4, (n, 3))], -1).astype(np.float32)
    return xi


def test_se3_exp_log_inverse_apply():
    """1e-5: float32 transcendental functions differ by a few ulps."""
    rng = np.random.RandomState(0)
    xi = _poses(rng, 32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-5
    Tj = np.asarray(j_se3.exp(jnp.asarray(xi)))
    Tt = t_se3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_se3.log(Tt).numpy(),
                               np.asarray(j_se3.log(jnp.asarray(Tj))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_se3.inverse(Tt).numpy(),
                               np.asarray(j_se3.inverse(jnp.asarray(Tj))),
                               atol=1e-5, rtol=0)
    p = rng.normal(0, 2, (32, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_se3.apply(Tt, torch.from_numpy(p)).numpy(),
        np.asarray(j_se3.apply(jnp.asarray(Tj), jnp.asarray(p))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        t_se3.retract(Tt, torch.from_numpy(xi * 0.1)).numpy(),
        np.asarray(j_se3.retract(jnp.asarray(Tj), jnp.asarray(xi * 0.1))),
        atol=1e-5, rtol=0)


def test_camera_project_backproject_undistort():
    """1e-5 relative: pixel coordinates are O(100) float32 values."""
    Kj, Kt = _K()
    rng = np.random.RandomState(1)
    pc = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                   rng.uniform(0.5, 5, 200)], -1).astype(np.float32)
    tp = torch.from_numpy(pc)
    for jf, tf in ((j_cam.project, t_cam.project),
                   (j_cam.project_stereo, t_cam.project_stereo)):
        np.testing.assert_allclose(tf(Kt, tp).numpy(),
                                   np.asarray(jf(Kj, jnp.asarray(pc))),
                                   rtol=1e-5, atol=1e-5)
    uv = np.asarray(j_cam.project(Kj, jnp.asarray(pc)))
    z = pc[:, 2]
    np.testing.assert_allclose(
        t_cam.backproject(Kt, torch.from_numpy(uv), torch.from_numpy(z))
        .numpy(), np.asarray(j_cam.backproject(Kj, jnp.asarray(uv),
                                               jnp.asarray(z))),
        rtol=1e-5, atol=1e-5)
    raw = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    np.testing.assert_allclose(
        t_cam.undistort_points(Kt, torch.from_numpy(raw)).numpy(),
        np.asarray(j_cam.undistort_points(Kj, jnp.asarray(raw))),
        rtol=1e-5, atol=1e-4)


def test_frustum_and_scale_level():
    Kj, Kt = _K()
    rng = np.random.RandomState(2)
    xi = _poses(rng, 1)[0] * 0.2
    T = np.asarray(j_se3.exp(jnp.asarray(xi)))
    pw = np.stack([rng.uniform(-2, 2, 300), rng.uniform(-2, 2, 300),
                   rng.uniform(0.3, 6, 300)], -1).astype(np.float32)
    nrm = rng.normal(0, 0.5, (300, 3)).astype(np.float32)
    nrm[:, 2] = np.abs(nrm[:, 2]) + 1
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mind = np.full(300, 0.5, np.float32)
    maxd = np.full(300, 4.0, np.float32)
    rj = j_cam.frustum_check(Kj, jnp.asarray(T), jnp.asarray(pw),
                             jnp.asarray(nrm), jnp.asarray(mind),
                             jnp.asarray(maxd))
    rt = t_cam.frustum_check(Kt, torch.from_numpy(T), torch.from_numpy(pw),
                             torch.from_numpy(nrm), torch.from_numpy(mind),
                             torch.from_numpy(maxd))
    assert np.array_equal(rt[0].numpy(), np.asarray(rj[0]))
    assert np.asarray(rj[0]).sum() > 10
    lj = j_cam.predict_scale_level(rj[3], jnp.asarray(maxd), np.log(1.2), 8)
    lt = t_cam.predict_scale_level(rt[3], torch.from_numpy(maxd),
                                   np.log(1.2), 8)
    assert np.array_equal(lt.numpy(), np.asarray(lj))


def test_triangulate_two_view():
    """Relative error 1e-4: batched 4x4 eigh in float32 on two backends."""
    Kj, Kt = _K()
    rng = np.random.RandomState(3)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(j_se3.exp(jnp.asarray(np.array(
        [-0.3, 0.02, 0.01, 0.01, -0.05, 0.0], np.float32))))
    pw = np.stack([rng.uniform(-1, 1, 100), rng.uniform(-1, 1, 100),
                   rng.uniform(2, 5, 100)], -1).astype(np.float32)
    uv1 = np.asarray(j_cam.project(Kj, jnp.asarray(pw)))
    uv2 = np.asarray(j_cam.project(Kj, j_se3.apply(jnp.asarray(T2),
                                                   jnp.asarray(pw))))
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape).astype(np.float32)
    pj, okj = j_tri.triangulate_two_view(Kj, jnp.asarray(T1),
                                         jnp.asarray(T2), jnp.asarray(uv1),
                                         jnp.asarray(uv2))
    pt, okt = t_tri.triangulate_two_view(Kt, torch.from_numpy(T1),
                                         torch.from_numpy(T2),
                                         torch.from_numpy(uv1),
                                         torch.from_numpy(uv2))
    pj = np.asarray(pj)
    rel = np.linalg.norm(pt.numpy() - pj, axis=1) / np.linalg.norm(pj, axis=1)
    assert rel.max() < 1e-4
    assert np.array_equal(okt.numpy(), np.asarray(okj))


def _pose_problem(seed, n=150, outliers=15):
    Kj, Kt = _K()
    rng = np.random.RandomState(seed)
    T_true = np.asarray(j_se3.exp(jnp.asarray(np.array(
        [0.05, -0.02, 0.1, 0.02, -0.03, 0.01], np.float32))))
    pw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    uvr = np.asarray(j_cam.project_stereo(Kj, jnp.asarray(pc)))
    uvr = uvr + rng.normal(0, 0.5, uvr.shape).astype(np.float32)
    uvr[:outliers, :2] += rng.uniform(20, 40, (outliers, 2)).astype(
        np.float32)
    ur = np.where(rng.rand(n) < 0.6, uvr[:, 2], -1.0).astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 4, n)).astype(np.float32)
    valid = rng.rand(n) > 0.05
    arrays = dict(uv=uvr[:, :2].copy(), ur=ur, pw=pw, inv_sigma2=inv_s2,
                  valid=valid)
    obs_j = j_po.PoseObs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    obs_t = t_po.PoseObs(**{k: torch.from_numpy(v)
                            for k, v in arrays.items()})
    T0 = np.eye(4, dtype=np.float32)
    return Kj, Kt, obs_j, obs_t, T0, T_true


@pytest.mark.parametrize("seed", [4, 5])
def test_pose_optimize(seed):
    """Translation within 1e-5 m, the same inlier set."""
    Kj, Kt, oj, ot, T0, T_true = _pose_problem(seed)
    Tj, inl_j, n_j = j_po.pose_optimize(Kj, jnp.asarray(T0), oj)
    Tt, inl_t, n_t = t_po.pose_optimize(Kt, torch.from_numpy(T0), ot)
    Tj = np.asarray(Tj)
    assert np.abs(Tt.numpy()[:3, 3] - Tj[:3, 3]).max() < 1e-5
    assert np.abs(Tt.numpy()[:3, :3] - Tj[:3, :3]).max() < 1e-5
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    assert np.abs(Tj[:3, 3] - T_true[:3, 3]).max() < 0.02


def test_pose_optimize_best_picks_same_init():
    Kj, Kt, oj, ot, T0, T_true = _pose_problem(6)
    T_alt = T_true.copy()
    T_alt[:3, 3] += 0.01
    inits = np.stack([T0, T_alt])
    Tj, inl_j, n_j = j_po.pose_optimize_best(Kj, jnp.asarray(inits), oj)
    Tt, inl_t, n_t = t_po.pose_optimize_best(Kt, torch.from_numpy(inits), ot)
    assert np.abs(Tt.numpy() - np.asarray(Tj)).max() < 1e-5
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))


def test_local_ba_matches_fixture():
    """Poses and points within 1e-4 of the JAX run (float32 LM/PCG with
    sums in another order), the same pruned observation set."""
    fx = np.load(FIXTURE)
    Kt = t_cam.Intrinsics.from_config(t_config.CameraConfig(
        width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
        dist=(0, 0, 0, 0, 0), bf=13.0, th_depth=40.0, depth_map_factor=1.0))
    prob = t_ba.BAProblem(**{f: torch.from_numpy(fx[f"ba.prob.{f}"])
                             for f in t_ba.BAProblem._fields})
    kf_pose, pt_xyz, keep = t_ba.local_ba(
        Kt, prob, 5, 10, block_n=int(fx["ba.block_n"]),
        pt_obs_slot=torch.from_numpy(fx["ba.pt_obs_slot"]))
    np.testing.assert_allclose(kf_pose.numpy(), fx["ba.kf_pose"], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(pt_xyz.numpy(), fx["ba.pt_xyz"], atol=1e-4,
                               rtol=1e-4)
    assert np.array_equal(keep.numpy(), fx["ba.keep"])
    assert (~fx["ba.keep"] & fx["ba.prob.obs_valid"]).sum() >= 3
