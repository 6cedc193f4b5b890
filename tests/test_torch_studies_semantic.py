"""scripts/diag_semopt_torch.py and scripts/diag_semopt_ragged_torch.py
against the JAX package on the CPU, from the reference's runs recorded in
tests/torch_fixtures/studies.npz (make_reference.py studies).

The probes run on the object-stability scene (160x120, objects_cfg, the
first SEM_FRAMES frames of its orbit; the scripts run
SlamConfig.tum_rgbd() on a TUM directory, which chip_smoke.py runs on the
card): the staged path with objects on, each frame's pose before the
semantic refinement (SlamSystem._last_presem_Tcw) and after it; and the
ragged-mask A/B, the masks degraded by datasets/synthetic.py::
degrade_masks from RandomState(11) in the reference's draw order, both
arms through run_experiments_torch.run_tum_variant (without the 12-frame
prewarm, whose systems are thrown away).

Tolerances: the frames the probe reads, the summary's keys and its frame
count exact; each frame's poses before and after within 2 mm / 0.1 deg;
each frame's shift (its camera centre after the refinement less before
it, 0.17-4.9 mm here) against the reference's: the median over the frames
of |port - reference| / |reference| at most 0.1 (chip_smoke.py's
STUDY_SHIFT_RTOL; a refinement that hands back its input reads 1, and
faults.skip_semantic_refinement must fail it); the summary's millimetre
numbers within 2 mm (the pose band); the objects census exact. The
ragged arms: the degraded masks bit-equal; tracked flags, keyframe
frames, the result's keys, keyframe and object counts exact; records within 2 mm / 0.1 deg; map points and semantic
constraints within 10% (tests/test_torch_experiments.py's band); what
the refinement moves, each frame's on-arm record centre less the off
arm's, against the reference's by the same median rule as the shifts
(the skipped refinement must fail it). The keyframe frames are the
insertions (frame 0's initialization keyframe is not one)."""

import json
import os
import sys

import numpy as np
import pytest

from object_slam_tpu_torch.slam.system import SlamSystem
from torch_fixtures import faults
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "studies.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import diag_semopt_ragged_torch as ragged_mod  # noqa: E402
import diag_semopt_torch as semopt_mod  # noqa: E402

SEM_FRAMES = 8                 # make_reference.py SEM_SMALL_FRAMES
POSE_TOL_M = 2e-3
POSE_TOL_DEG = 0.1
SHIFT_RTOL = 0.1


class Meta:
    def __init__(self, timestamp):
        self.timestamp = timestamp


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def inputs():
    """make_reference.py sem_small_inputs in the port."""
    from object_slam_tpu_torch.datasets.synthetic import orbit_poses
    from object_slam_tpu_torch.semantic.object2d import pack_mask_bits
    from test_torch_studies import object_scene, objects_cfg
    cfg = objects_cfg(pipelined_readback=False)
    scene = object_scene(cfg)
    frames, metas, gt = [], [], {}
    for i, T in enumerate(orbit_poses(SEM_FRAMES, step=0.008)):
        _, depth, rgb, sem = scene.render_rgbd(T)
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances)
        frames.append((np.clip(rgb, 0, 255).astype(np.uint8),
                       np.asarray(depth, np.float32),
                       (pack_mask_bits(sa[0]),) + tuple(sa[1:])))
        metas.append(Meta(i / 30.0))
        gt[round(i / 30.0, 4)] = np.linalg.inv(T)[:3, 3]
    return cfg, frames, metas, gt


def _rot_deg(a, b):
    R = a[:3, :3].T.astype(np.float64) @ b[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def _centre(T):
    return np.linalg.inv(np.asarray(T, np.float64))[:3, 3]


def _misfit(got, want):
    """Per row of two [n, 3] arrays of camera-centre differences,
    |got - want| / |want|, over the rows where want is not 0
    (chip_smoke.py's misfit)."""
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    norm = np.linalg.norm(want, axis=1)
    keep = norm > 0
    return np.linalg.norm(got - want, axis=1)[keep] / norm[keep]


def _shift_misfit(poses, pre_ref, post_ref):
    """Each refined frame's shift (the camera centre after the refinement
    less the one before it) against the reference's."""
    return _misfit([_centre(post) - _centre(pre) for _, pre, post in poses],
                   [_centre(b) - _centre(a)
                    for a, b in zip(pre_ref, post_ref)][:len(poses)])


def _run_arms(inputs, n):
    """Both ragged arms on the first n frames (no prewarm): (results,
    systems)."""
    cfg, frames, metas, _ = inputs
    ragged, _ = ragged_mod.degrade(cfg, frames)
    systems = []
    out = ragged_mod.run_arms(os.path.join(ROOT, "build", "no_sequence"),
                              cfg, ragged[:n], metas[:n], device="cpu",
                              prewarm=0, systems=systems)
    return out, systems


def _arm_gap_misfit(fx, systems):
    """What the refinement moves: the on arm's record centres less the off
    arm's, against the reference's."""
    on, off = ([_centre(r.Tcw) for r in s.trajectory] for s in systems)
    n = len(on)
    jon, joff = ([_centre(T) for T in fx[f"ragged.{a}.rec_tcw"][:n]]
                 for a in ("ragged_semopt_on", "ragged_semopt_off"))
    return _misfit(np.subtract(on, off), np.subtract(jon, joff))


def _census(sys_):
    m = sys_.map
    labels = m.obj_label[m.obj_valid].numpy()
    lab, cnt = np.unique(labels, return_counts=True)
    return lab.tolist(), cnt.tolist()


def test_semopt_probe_matches_reference(fx, inputs):
    """Each frame's poses before and after the semantic refinement, the
    summary and the census as the reference's; the pose before the
    refinement is kept on the staged objects-on branch only."""
    cfg, frames, metas, gt = inputs
    systems = []
    deltas, poses, out = semopt_mod.run_probe(cfg, metas, frames, gt,
                                              device="cpu", log_every=0,
                                              systems=systems)
    want = json.loads(str(fx["semopt.summary"]))
    assert [i for i, _, _ in poses] == fx["semopt.frames"].tolist()
    assert len(poses) >= SEM_FRAMES - 1
    for (i, pre, post), wpre, wpost in zip(poses, fx["semopt.pre_tcw"],
                                           fx["semopt.post_tcw"]):
        for a, b in ((pre, wpre), (post, wpost)):
            assert np.abs(a[:3, 3] - b[:3, 3]).max() <= POSE_TOL_M, i
            assert _rot_deg(a, b) <= POSE_TOL_DEG, i
    misfit = _shift_misfit(poses, fx["semopt.pre_tcw"], fx["semopt.post_tcw"])
    assert np.median(misfit) <= SHIFT_RTOL, misfit
    assert set(out) == set(want)
    assert out["n_semopt_frames"] == want["n_semopt_frames"]
    for k, v in want.items():
        if k.endswith("_mm"):
            assert abs(out[k] - v) <= POSE_TOL_M * 1e3, (k, out[k], v)
    sys_ = systems[0]
    assert _census(sys_) == (fx["semopt.census_labels"].tolist(),
                             fx["semopt.census_counts"].tolist())
    assert [r.tracked for r in sys_.trajectory] == \
        fx["semopt.tracked"].tolist()
    assert sys_._last_presem_Tcw is not None


def test_semopt_probe_with_the_refinement_skipped_fails(fx, inputs):
    """A planted fault: the refinement hands back the pose it was given.
    The shift check must fail it (at VGA, where the refinement moves a
    frame by 0.05-0.5 mm, the 2 mm pose band cannot)."""
    cfg, frames, metas, gt = inputs
    n = 4
    undo = faults.skip_semantic_refinement()
    try:
        _, poses, _ = semopt_mod.run_probe(cfg, metas[:n], frames[:n], gt,
                                           device="cpu", log_every=0)
    finally:
        undo()
    assert len(poses) == n - 1
    for _, pre, post in poses:
        assert np.array_equal(pre, post)
    misfit = _shift_misfit(poses, fx["semopt.pre_tcw"], fx["semopt.post_tcw"])
    assert np.median(misfit) > SHIFT_RTOL, misfit


def test_ragged_arms_match_reference(fx, inputs):
    """The degraded masks bit-equal to the reference's, and both arms of
    the A/B as the reference ran them."""
    cfg, frames, metas, _ = inputs
    ragged, n_deg = ragged_mod.degrade(cfg, frames)
    got_masks = np.concatenate([r[2][0].reshape(-1) for r in ragged
                                if r[2] is not None])
    assert np.array_equal(got_masks, fx["ragged.ragged_masks"])
    assert n_deg > 0
    systems, inserts = [], []
    insert = SlamSystem._insert_impl

    def insert_impl(sys_, m, frame, Tcw, kp_pt, close_mask, frame_id):
        if not inserts or inserts[-1][0] is not sys_:
            inserts.append((sys_, []))
        inserts[-1][1].append(int(frame_id))
        return insert(sys_, m, frame, Tcw, kp_pt, close_mask, frame_id)
    SlamSystem._insert_impl = insert_impl
    try:
        out = ragged_mod.run_arms(os.path.join(ROOT, "build", "no_sequence"),
                                  cfg, ragged, metas, device="cpu",
                                  prewarm=0, systems=systems)
    finally:
        SlamSystem._insert_impl = insert
    for (name, res), sys_ in zip(out.items(), systems):
        p = f"ragged.{name}."
        want = json.loads(str(fx[p + "result"]))
        assert set(res) - {"fps", "median_track_ms"} == set(want)
        for k in ("frames", "tracked", "keyframes", "objects"):
            assert res[k] == want[k], (name, k, res[k], want[k])
        for k in ("points", "semantic_constraints"):
            assert abs(res[k] - want[k]) <= 0.1 * want[k], (name, k)
        assert [r.tracked for r in sys_.trajectory] == \
            fx[p + "tracked"].tolist()
        assert dict((id(a), b) for a, b in inserts).get(id(sys_), []) == \
            fx[p + "insert_frames"].tolist()
        for r, w in zip(sys_.trajectory, fx[p + "rec_tcw"]):
            assert np.abs(r.Tcw[:3, 3] - w[:3, 3]).max() <= POSE_TOL_M
            assert _rot_deg(r.Tcw, w) <= POSE_TOL_DEG
        assert _census(sys_) == (fx[p + "census_labels"].tolist(),
                                 fx[p + "census_counts"].tolist())
    on, off = out["ragged_semopt_on"], out["ragged_semopt_off"]
    assert off["semantic_constraints"] == 0 < on["semantic_constraints"]
    gap = _arm_gap_misfit(fx, systems)
    assert np.median(gap) <= SHIFT_RTOL, gap


def test_ragged_arms_with_the_refinement_skipped_fail(fx, inputs):
    """A planted fault: the on arm's refinement hands back the pose it was
    given, its constraints counted as before. What the refinement moves
    (the on arm less the off arm) must then miss the reference's."""
    undo = faults.skip_semantic_refinement()
    try:
        out, systems = _run_arms(inputs, 4)
    finally:
        undo()
    assert out["ragged_semopt_on"]["semantic_constraints"] > 0
    gap = _arm_gap_misfit(fx, systems)
    assert np.median(gap) > SHIFT_RTOL, gap
