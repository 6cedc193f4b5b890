"""Relocalization of the PyTorch port against the JAX package on the CPU:
the RANSAC sampler, the batched DLT pose, PnP RANSAC with the reference's
own index sets injected, and the kidnap sequence (a pan, three dark
frames, a jump back to the start) replayed against the JAX run recorded
in tests/torch_fixtures/kidnap.npz (make_reference.py kidnap).

``jax.random`` streams cannot be reproduced in torch, so where the two
packages are compared the port is handed the index sets the reference
drew. Tolerances: DLT: in f64 within 1 mm of the truth, in f32 a median
scatter within 2x of the reference's (the f32 DLT is ill-conditioned);
PnP (against the reference's result recorded in pnp_cases.npz): the
same inlier set and count, pose 1e-4 m / 1e-4 rad after the polish, where
both packages pick the same hypothesis, and the tie's bounds where they
do not (see the test); kidnap: the same
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
from torch_fixtures import pnp_cases
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "kidnap.npz")
PNP_FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                           "pnp_cases.npz")
TUM = pnp_cases.TUM
K = Intrinsics(**TUM)
JK = JIntrinsics(**TUM)
correspondences = pnp_cases.correspondences


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


# a tie between the packages' winning hypotheses: the two winning scores
# within this many inliers (seed 4: 215 in the port against 213)
PNP_TIE_INLIERS = 2


@pytest.mark.parametrize("seed", pnp_cases.SEEDS)
def test_pnp_ransac_with_injected_sets_matches_jax(seed):
    """The reference's index sets injected, against its result recorded
    once (pnp_cases.npz, make_reference.py pnp_cases: the sets, every
    hypothesis's score, the winner, the polished pose and inliers; a live
    XLA:CPU call rounds as the machine that compiles it does).

    Exact parity needs a clear winner. Where both packages' argmax picks
    the same hypothesis: the same inlier set and count, the pose within
    1e-4. But the 6-point DLT is ill-conditioned in f32 (no
    normalization): one set's hypothesis can part between the packages
    by far more than the millimetres that separate them elsewhere (seed
    4: the port's hypothesis of set 170 holds 215 inliers, the
    reference's 0), so the two may pick different winners. There the
    test holds what holds under the tie: the port scores the reference's
    winning set as the reference does, the two winning scores lie within
    PNP_TIE_INLIERS, the polished poses within 1 mm / 1e-3 rad of each
    other and 1 cm of the truth, the polished counts within
    PNP_TIE_INLIERS. 80% inliers at 0.3 px noise; the inliers are true
    correspondences either way.

    How far a score may part is the reference's own: every set's score
    lies within its envelope, the least and greatest score the reference
    gives that set over 1024 one-ulp perturbations of the pixels and the
    recorded run (make_reference.py pnp_cases_noise). The port's f32 DLT
    solves in its own order, as another host's XLA:CPU does, so an
    ill-conditioned set scores anywhere in that envelope; the 200-odd sets
    whose scores one ulp does not move must score exactly as the
    reference's."""
    fx = np.load(PNP_FIXTURE)
    pw, uv, valid, T, good = correspondences(seed)
    jidx = fx[f"{seed}.idx"]
    want_inl, want_n = fx[f"{seed}.inliers"], int(fx[f"{seed}.n_inliers"])
    want_T, jscores = fx[f"{seed}.Tcw"], fx[f"{seed}.scores"]
    jbest = int(fx[f"{seed}.best"])
    assert bool(fx[f"{seed}.ok"]) and want_n > 100
    args = (K, torch.from_numpy(pw), torch.from_numpy(uv),
            torch.from_numpy(valid))
    got = epnp.pnp_ransac_sets(torch.from_numpy(jidx), *args, min_inliers=25)
    scores = epnp.hypothesis_scores(torch.from_numpy(jidx), *args)[2].numpy()
    lo, hi = fx[f"{seed}.scores_lo"], fx[f"{seed}.scores_hi"]
    outside = np.flatnonzero((scores < lo) | (scores > hi))
    assert not len(outside), [(int(i), int(scores[i]), int(lo[i]),
                               int(hi[i])) for i in outside]
    assert bool(got.ok)
    assert _pose_close(got.Tcw.numpy(), T, tol=1e-2)
    assert (good | ~got.inliers.numpy()).all()
    assert (good | ~want_inl).all()
    if int(np.argmax(scores)) == jbest:
        assert np.array_equal(got.inliers.numpy(), want_inl)
        assert int(got.n_inliers) == want_n
        assert _pose_close(got.Tcw.numpy(), want_T)
        return
    assert lo[jbest] <= scores[jbest] <= hi[jbest]
    assert 0 <= scores.max() - jscores.max() <= PNP_TIE_INLIERS
    assert abs(int(got.n_inliers) - want_n) <= PNP_TIE_INLIERS
    assert _pose_close(got.Tcw.numpy(), want_T, tol=1e-3)
    assert _pose_close(want_T, T, tol=1e-2)


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
