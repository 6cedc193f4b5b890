"""Relocalization of the PyTorch port against the JAX package on the CPU:
the RANSAC sampler, the batched DLT pose, PnP RANSAC with the reference's
own index sets injected, and the kidnap sequence (a pan, three dark
frames, a jump back to the start) replayed against the JAX run recorded
in tests/torch_fixtures/kidnap.npz (make_reference.py kidnap).

``jax.random`` streams cannot be reproduced in torch, so where the two
packages are compared the port is handed the index sets the reference
drew. Tolerances: DLT: in f64 within 1 mm of the truth, in f32 a median
scatter within 2x of the reference's (the f32 DLT is ill-conditioned);
PnP: the same inlier set and count, pose 1e-4 m / 1e-4 rad after the
polish, on data whose best hypothesis is unambiguous; kidnap: the same
tracked flags, LOST frames, staged-path frames, relocalized frame and
keyframe frames, trajectory records within 2 mm / 0.1 deg, the
relocalized pose within 5 cm of the ground truth."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.geometry.camera import Intrinsics as JIntrinsics
from object_slam_tpu.solvers import epnp as jepnp
from object_slam_tpu.solvers import ransac as jransac
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SemanticConfig,
                                          SlamConfig)
from object_slam_tpu_torch.datasets.synthetic import SyntheticScene
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.slam.system import SlamSystem
from object_slam_tpu_torch.solvers import epnp, ransac
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "kidnap.npz")
TUM = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
           bf=40.0, dist=(0.0,) * 5, width=640.0, height=480.0)
K = Intrinsics(**TUM)
JK = JIntrinsics(**TUM)


def _rot(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def correspondences(seed, n=300, inlier_frac=0.8, noise=0.3):
    """pw [n, 3], uv [n, 2], valid [n], true Tcw, inlier truth."""
    rng = np.random.RandomState(seed)
    T = np.eye(4)
    T[:3, :3] = _rot(rng.randn(3) * 0.3)
    T[:3, 3] = rng.randn(3) * 0.5
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(2, 6, n)], -1)
    Twc = np.linalg.inv(T)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    uv = np.stack([K.fx * pc[:, 0] / pc[:, 2] + K.cx,
                   K.fy * pc[:, 1] / pc[:, 2] + K.cy], -1)
    uv += rng.randn(n, 2) * noise
    good = rng.rand(n) < inlier_frac
    uv[~good] = rng.uniform([0, 0], [640, 480], ((~good).sum(), 2))
    valid = rng.rand(n) < 0.9
    return (pw.astype(np.float32), uv.astype(np.float32), valid,
            T.astype(np.float32), good)


def _pose_close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    Rd = a[:3, :3].T @ b[:3, :3]
    w = np.array([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0],
                  Rd[1, 0] - Rd[0, 1]]) / 2.0
    return np.abs(a[:3, 3] - b[:3, 3]).max() < tol and \
        np.linalg.norm(w) < tol


def test_sample_minimal_sets_distinct_valid_and_seeded():
    valid = torch.from_numpy(np.random.RandomState(0).rand(500) < 0.3)
    gen = torch.Generator().manual_seed(0)
    idx = ransac.sample_minimal_sets(gen, 500, valid, 256, 6)
    assert idx.shape == (256, 6)
    assert bool(valid[idx].all())
    srt = torch.sort(idx, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    assert len({tuple(r) for r in idx.tolist()}) > 250
    again = ransac.sample_minimal_sets(torch.Generator().manual_seed(0), 500,
                                       valid, 256, 6)
    assert torch.equal(idx, again)
    # the reference's sets have the same contract
    jidx = np.asarray(jransac.sample_minimal_sets(
        jax.random.PRNGKey(0), 500, jnp.asarray(valid.numpy()), 256, 6))
    assert valid.numpy()[jidx].all()


@pytest.mark.parametrize("seed", [1, 7])
def test_dlt_pose_matches_jax(seed):
    """The unnormalized 6-point DLT is ill-conditioned in f32: on exact
    correspondences both packages' hypotheses scatter around the solution
    by up to centimetres (the 12x12 eigensolver's rounding), so the f32
    comparison is statistical; in f64 the port's DLT recovers the pose."""
    pw, uv, _, T, _ = correspondences(seed, n=64 * 6, inlier_frac=1.0,
                                      noise=0.0)
    xn = np.stack([(uv[:, 0] - K.cx) / K.fx, (uv[:, 1] - K.cy) / K.fy], -1)
    pw_b, xn_b = pw.reshape(64, 6, 3), xn.reshape(64, 6, 2)
    got = epnp.dlt_pose(torch.from_numpy(pw_b), torch.from_numpy(xn_b))
    want = np.asarray(jepnp.dlt_pose(jnp.asarray(pw_b), jnp.asarray(xn_b)))
    assert got.shape == (64, 4, 4) and got.dtype == torch.float32
    got = got.numpy()
    g64 = epnp.dlt_pose(torch.from_numpy(pw_b).double(),
                        torch.from_numpy(xn_b).double()).numpy()
    for a in g64:
        assert _pose_close(a, T, tol=1e-3)
        assert np.allclose(a[:3, :3] @ a[:3, :3].T, np.eye(3), atol=1e-9)

    def err(A):
        return np.median(np.abs(A[:, :3, 3] - T[:3, 3]).max(1))
    assert err(got) < 2.0 * err(want) + 1e-4
    assert err(want) < 2.0 * err(got) + 1e-4
    assert np.median(np.abs(got - want).max((1, 2))) < 1e-2


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_pnp_ransac_with_injected_sets_matches_jax(seed):
    """Exact parity needs a clear winner: the f32 hypotheses of the two
    packages differ by millimetres, so where several hypotheses tie within
    that, argmax can pick different ones and the polish then gates a
    different set. 80% inliers at 0.3 px noise give every good hypothesis
    the same inlier set."""
    pw, uv, valid, T, good = correspondences(seed)
    key = jax.random.PRNGKey(seed)
    jidx = np.array(jransac.sample_minimal_sets(key, pw.shape[0],
                                                  jnp.asarray(valid), 256, 6))
    want = jepnp.pnp_ransac(key, JK, jnp.asarray(pw), jnp.asarray(uv),
                            jnp.asarray(valid), min_inliers=25)
    got = epnp.pnp_ransac_sets(torch.from_numpy(jidx), K,
                               torch.from_numpy(pw), torch.from_numpy(uv),
                               torch.from_numpy(valid), min_inliers=25)
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 100
    assert bool(got.ok) and bool(want.ok)
    assert _pose_close(got.Tcw.numpy(), np.asarray(want.Tcw))
    assert _pose_close(got.Tcw.numpy(), T, tol=1e-2)
    # the inliers are true correspondences
    assert (good | ~got.inliers.numpy()).all()


def test_pnp_ransac_own_generator_and_too_few_inliers():
    pw, uv, valid, T, _ = correspondences(5)
    res = epnp.pnp_ransac(torch.Generator().manual_seed(0), K,
                          torch.from_numpy(pw), torch.from_numpy(uv),
                          torch.from_numpy(valid))
    assert bool(res.ok) and _pose_close(res.Tcw.numpy(), T, tol=1e-2)
    # pure outliers: no hypothesis reaches the gate
    rng = np.random.RandomState(6)
    uv_bad = rng.uniform([0, 0], [640, 480], uv.shape).astype(np.float32)
    res = epnp.pnp_ransac(torch.Generator().manual_seed(0), K,
                          torch.from_numpy(pw), torch.from_numpy(uv_bad),
                          torch.from_numpy(valid), min_inliers=25)
    assert not bool(res.ok)


def small_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        semantic=SemanticConfig(mask_margin=3, min_kps_rgbd=4))


def object_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=3.0)
    for k, b in enumerate(scene.boxes):
        b["size"] = 0.8
        b["center"] = np.array([(-0.75, 0.75)[k], 0.1, 2.0])
    return scene


def run_kidnap(fx, replay: bool):
    cfg = small_cfg()
    scene = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    seen = {"staged": [], "reloc": [], "sets": 0}
    sets = [torch.from_numpy(s) for s in fx["sets"]]
    draw, staged, reloc = (sys_._minimal_sets, sys_._track_staged,
                           sys_._relocalize)

    def minimal_sets(valid, n_trials=256, k=6):
        seen["sets"] += 1
        return sets.pop(0) if replay else draw(valid, n_trials, k)

    def track_staged(frame):
        seen["staged"].append(sys_.frame_id)
        return staged(frame)

    def relocalize(frame):
        tr = reloc(frame)
        seen["reloc"].append((round(float(frame.timestamp) * 30),
                              tr is not None))
        return tr

    sys_._minimal_sets = minimal_sets
    sys_._track_staged = track_staged
    sys_._relocalize = relocalize
    H, W = cfg.camera.height, cfg.camera.width
    sums = []
    for i, (T, dark) in enumerate(zip(fx["poses"], fx["blank"])):
        if dark:
            gray = depth = np.zeros((H, W), np.float32)
            rgb = np.zeros((H, W, 3), np.float32)
        else:
            gray, depth, rgb, _ = scene.render_rgbd(T)
        sums.append(float(np.sum(gray, dtype=np.float64)))
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
    sys_.flush_mapping()
    return sys_, seen, np.asarray(sums)


@pytest.fixture(scope="module")
def kidnap():
    fx = np.load(FIXTURE)
    sys_, seen, sums = run_kidnap(fx, replay=True)
    return fx, sys_, seen, sums


def test_kidnap_inputs_match_fixture(kidnap):
    fx, _, _, sums = kidnap
    np.testing.assert_allclose(sums, fx["gray_sum"], rtol=1e-9, atol=0)


def test_kidnap_lost_staged_and_relocalized_frames_identical(kidnap):
    fx, sys_, seen, _ = kidnap
    tracked = np.asarray([r.tracked for r in sys_.trajectory])
    assert np.array_equal(tracked, fx["tracked"])
    assert np.array_equal(np.where(~tracked)[0], np.where(fx["blank"])[0])
    assert seen["staged"] == fx["staged_frames"].tolist()
    assert [f for f, _ in seen["reloc"]] == fx["reloc_frames"].tolist()
    assert [ok for _, ok in seen["reloc"]] == fx["reloc_ok"].tolist()
    assert seen["sets"] == len(fx["sets"]) >= 1
    assert sys_.n_relocalized == int(fx["reloc_ok"].sum()) >= 1
    kf = sys_.map.kf_frame_id[sys_.map.kf_valid].numpy()
    assert np.array_equal(kf, fx["kf_frames"])


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_kidnap_records_within_2mm_and_relocalized_near_truth(kidnap):
    fx, sys_, _, _ = kidnap
    recs = sys_.trajectory
    assert [r.ref_kf for r in recs] == fx["rec_ref"].tolist()
    for r, a, b in zip(recs, fx["rec_tcw"], fx["rec_tcr"]):
        assert np.linalg.norm(r.Tcw[:3, 3] - a[:3, 3]) < 2e-3
        assert _rot_deg(r.Tcw[:3, :3], a[:3, :3]) < 0.1
        assert np.linalg.norm(r.Tcr[:3, 3] - b[:3, 3]) < 2e-3
    fin = np.stack([t[1] for t in sys_.final_trajectory()])
    assert np.abs(fin[:, :3, 3] - fx["final_tcw"][:, :3, 3]).max() < 2e-3
    f = int(fx["reloc_frames"][fx["reloc_ok"]][0])
    assert np.linalg.norm(recs[f].Tcw[:3, 3] - fx["poses"][f][:3, 3]) < 0.05


def test_relocalize_refuses_a_frame_without_matches():
    cfg = small_cfg()
    scene = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    gray, depth, rgb, _ = scene.render_rgbd(np.eye(4, dtype=np.float32))
    sys_.track_rgbd(gray, depth, rgb, timestamp=0.0)
    blank = sys_.builder.build_rgbd(np.zeros_like(gray), np.zeros_like(depth),
                                    None, None, 0.1)
    state = sys_.rng.get_state()
    assert sys_._relocalize(blank) is None
    assert torch.equal(sys_.rng.get_state(), state)   # nothing drawn
    assert sys_.n_relocalized == 0
