"""The single-blob ingestion, the pipelined readback and the staged path of
the PyTorch port against the JAX package on the CPU.

The blob: ``pack_frame_blob`` byte-equal to the reference's, and the
blob-built frame equal to ``build_rgbd`` on the same arrays (as
tests/test_semantic.py checks the reference). The system runs (small
geometry: 160x120, 300 features, 4 levels) are held to the JAX runs in
tests/torch_fixtures/pipelined.npz (make_reference.py pipelined): slice1's
12-frame orbit objects off and the object-stability scene's 12 frames
objects on, both with the default one-frame-lagged readback, and 8 frames
of the staged path (``tracking.fused=False``) objects on.

Tolerances: tracked flags, keyframe frames, record reference keyframes and
staged frames identical; trajectory records (Tcw, Tcr) and the final
trajectory within 2 mm / 0.1 deg; census identical and semantic
constraints within 2%; the blob frame equal to the array frame exactly."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from object_slam_tpu.config import CameraConfig as JCameraConfig
from object_slam_tpu.config import CapacityConfig as JCapacityConfig
from object_slam_tpu.config import OrbConfig as JOrbConfig
from object_slam_tpu.config import SemanticConfig as JSemanticConfig
from object_slam_tpu.config import SlamConfig as JSlamConfig
from object_slam_tpu.slam.frame import FrameBuilder as JFrameBuilder
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SemanticConfig,
                                          SlamConfig, TrackingConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      orbit_poses)
from object_slam_tpu_torch.slam import frame as frame_mod
from object_slam_tpu_torch.slam import system as system_mod
from object_slam_tpu_torch.slam.system import LOST, OK, SlamSystem
from object_slam_tpu_torch.utils.metrics import MetricsStream
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "pipelined.npz")


def small_cfg(objects=False, **tracking):
    sem = dict(mask_margin=3, min_kps_rgbd=4) if objects else {}
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        semantic=SemanticConfig(**sem), tracking=TrackingConfig(**tracking))


def object_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=3.0)
    for k, b in enumerate(scene.boxes):
        b["size"] = 0.8
        b["center"] = np.array([(-0.75, 0.75)[k], 0.1, 2.0])
    return scene


def blob_inputs(cfg, scene, T, factor=5000.0):
    gray, depth, rgb, sem = scene.render_rgbd(T)
    d16 = np.clip(depth * factor, 0, 65535).astype(np.uint16)
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    return d16, rgb8, scene.sem_arrays(sem, cfg.semantic.max_instances)


# ---------------------------------------------------------------------------
# the blob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_sem", [True, False])
def test_pack_frame_blob_byte_equal_to_jax(with_sem):
    cfg = small_cfg(objects=True)
    d16, rgb8, sa = blob_inputs(cfg, object_scene(cfg), orbit_poses(1)[0])
    sa = sa if with_sem else None
    tb = frame_mod.FrameBuilder(cfg, device="cpu")
    jb = JFrameBuilder(JSlamConfig(
        camera=JCameraConfig(**dataclasses.asdict(cfg.camera)),
        orb=JOrbConfig(**dataclasses.asdict(cfg.orb)),
        caps=JCapacityConfig(**dataclasses.asdict(cfg.caps)),
        semantic=JSemanticConfig(**dataclasses.asdict(cfg.semantic))))
    got, giv = tb.pack_frame_blob(d16, rgb8, sa)
    want, wiv = jb.pack_frame_blob(d16, rgb8, sa)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert got.size == tb.blob_bytes(with_sem)
    if with_sem:
        assert np.array_equal(giv, wiv) and giv.sum() == 2
    else:
        assert giv is None and wiv is None


def _frames_equal(a, b):
    for f in frame_mod.FrameData._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "obj":
            for g in x._fields:
                assert torch.equal(getattr(x, g), getattr(y, g)), g
        else:
            assert torch.equal(x, y), f


@pytest.mark.parametrize("with_sem", [True, False])
def test_blob_frame_equals_build_rgbd(with_sem):
    cfg = small_cfg(objects=True)
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera,
                                                 depth_map_factor=5000.0))
    d16, rgb8, sa = blob_inputs(cfg, object_scene(cfg), orbit_poses(1)[0])
    b = frame_mod.FrameBuilder(cfg, device="cpu")
    want = b.build_rgbd(None, d16, rgb8, sa if with_sem else None, 0.5)
    blob, iv = b.pack_frame_blob(d16, rgb8, sa if with_sem else None)
    got = b.build_rgbd_blob(blob, iv, 0.5)
    _frames_equal(got, want)
    assert int(got.obj.valid.sum()) == (2 if with_sem else 0)
    # a uint8 tensor already on the device builds the same frame
    _frames_equal(b.build_rgbd_blob(torch.from_numpy(blob.copy()), iv, 0.5),
                  want)
    if with_sem:
        # detections present but none valid: the object-free build
        iv0 = np.zeros_like(iv)
        nob = b.build_rgbd_blob(blob, iv0, 0.5)
        _frames_equal(nob, b.build_rgbd(None, d16, rgb8, None, 0.5))


def test_unpack_blob_reinterprets_every_slice():
    cfg = small_cfg(objects=True)
    d16, rgb8, sa = blob_inputs(cfg, object_scene(cfg), orbit_poses(1)[0])
    d16[0, :3] = [0, 1, 65535]               # the sign bit stays data
    b = frame_mod.FrameBuilder(cfg, device="cpu")
    blob, _ = b.pack_frame_blob(d16, rgb8, sa)
    d, rgb, masks, labels, probs, bboxes = b._unpack_blob(
        torch.from_numpy(blob.copy()), True)
    assert d.dtype == torch.int32 and np.array_equal(d.numpy(), d16)
    assert np.array_equal(rgb.numpy(), rgb8)
    assert np.array_equal(masks.numpy(), b.pack_sem_arrays(sa)[0])
    assert np.array_equal(labels.numpy(), sa[1])
    assert np.array_equal(probs.numpy(), sa[2])
    assert np.array_equal(bboxes.numpy(), sa[3])
    with pytest.raises(ValueError, match="bytes"):
        b.build_rgbd_blob(blob[:-1], sa[4], 0.0)


def test_reinterpret_copies_a_misaligned_slice():
    vals = np.array([1, -2, 70000, 3], np.int32)
    raw = torch.from_numpy(np.frombuffer(b"\x00" + vals.tobytes(),
                                         np.uint8).copy())
    got = frame_mod._reinterpret(raw[1:], torch.int32)
    assert np.array_equal(got.numpy(), vals)
    aligned = torch.from_numpy(np.frombuffer(vals.tobytes(), np.uint8).copy())
    view = frame_mod._reinterpret(aligned, torch.int32)
    assert view.data_ptr() == aligned.data_ptr()      # no copy when aligned


# ---------------------------------------------------------------------------
# system runs against the JAX fixture
# ---------------------------------------------------------------------------

def _run(cfg, scene, poses, objects):
    sys_ = SlamSystem(cfg, enable_objects=objects, device="cpu")
    staged = []
    track_staged = sys_._track_staged

    def spy(frame):
        staged.append(sys_.frame_id)
        return track_staged(frame)
    sys_._track_staged = spy
    sums = []
    for i, T in enumerate(poses):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        sums.append(float(np.sum(gray, dtype=np.float64)))
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances) \
            if objects else None
        sys_.track_rgbd(gray, depth, rgb, sa, timestamp=i / 30.0)
    sys_.flush_mapping()
    return sys_, staged, np.asarray(sums)


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


RUNS = {
    "off": (lambda: small_cfg(), False, 12, 0.02),
    "on": (lambda: small_cfg(objects=True), True, 12, 0.008),
    "staged": (lambda: small_cfg(objects=True, fused=False), True, 8, 0.008),
}


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, fx):
    name = request.param
    make_cfg, objects, n, step = RUNS[name]
    cfg = make_cfg()
    scene = (object_scene(cfg) if objects
             else SyntheticScene.make(cfg, seed=1, n_objects=2))
    sys_, staged, sums = _run(cfg, scene, orbit_poses(n, step=step), objects)
    want = {k[len(name) + 1:]: fx[k] for k in fx.files
            if k.startswith(name + ".")}
    return name, sys_, staged, sums, want


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_run_inputs_flags_keyframes_identical(run):
    name, sys_, staged, sums, want = run
    np.testing.assert_allclose(sums, want["gray_sum"], rtol=1e-9, atol=0)
    tracked = [r.tracked for r in sys_.trajectory]
    assert tracked == want["tracked"].tolist() and all(tracked)
    kf = sys_.map.kf_frame_id[sys_.map.kf_valid].numpy()
    assert np.array_equal(kf, want["kf_frames"])
    assert [r.ref_kf for r in sys_.trajectory] == want["rec_ref"].tolist()
    assert staged == want["staged_frames"].tolist()
    assert staged == (list(range(1, 8)) if name == "staged" else [])
    assert sys_.n_relocalized == 0 == len(want["reloc_frames"])


def test_run_records_within_2mm_and_0_1deg(run):
    _, sys_, _, _, want = run
    for r, a, b in zip(sys_.trajectory, want["rec_tcw"], want["rec_tcr"]):
        assert np.linalg.norm(r.Tcw[:3, 3] - a[:3, 3]) < 2e-3
        assert _rot_deg(r.Tcw[:3, :3], a[:3, :3]) < 0.1
        assert np.linalg.norm(r.Tcr[:3, 3] - b[:3, 3]) < 2e-3
    fin = np.stack([t[1] for t in sys_.final_trajectory()])
    assert np.abs(fin[:, :3, 3] - want["final_tcw"][:, :3, 3]).max() < 2e-3
    assert abs(sys_.n_points - int(want["n_points"])) <= \
        0.02 * int(want["n_points"])


def test_run_object_map(run):
    name, sys_, _, _, want = run
    if sys_.objects is None:
        assert "census_labels" not in want
        return
    m = sys_.map
    lab, cnt = np.unique(m.obj_label[m.obj_valid].numpy(),
                         return_counts=True)
    assert np.array_equal(lab, want["census_labels"])
    assert np.array_equal(cnt, want["census_counts"])
    sem = int(want["semantic_constraints"])
    assert sem > 50
    assert abs(sys_.objects.semantic_constraints - sem) <= 0.02 * sem


# ---------------------------------------------------------------------------
# the lagged readback's contract
# ---------------------------------------------------------------------------

def test_dispatch_next_frame_before_resolving_this_one(monkeypatch):
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    order = []
    fused = system_mod.trk.track_frame_fused

    def spy_fused(*args, **kw):
        order.append(("dispatch", args[7]))
        return fused(*args, **kw)
    resolve = sys_._resolve_one

    def spy_resolve(pend, latest):
        order.append(("resolve", pend["fid"], latest))
        return resolve(pend, latest)
    monkeypatch.setattr(system_mod.trk, "track_frame_fused", spy_fused)
    sys_._resolve_one = spy_resolve
    poses = orbit_poses(4, step=0.02)
    for i, T in enumerate(poses):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        if i:
            # the returned frame is this frame's fused result, still pending
            assert torch.is_tensor(f.pose_ok)
            assert sys_._fused_pending["fid"] == i
            assert len(sys_.trajectory) == i
    assert order == [("dispatch", 1), ("dispatch", 2), ("resolve", 1, False),
                     ("dispatch", 3), ("resolve", 2, False)]
    assert sys_.get_tracking_state() == OK
    assert order[-1] == ("resolve", 3, True)
    assert sys_._fused_pending is None and len(sys_.trajectory) == 4
    assert sys_.n_keyframes >= 1


def test_strict_readback_resolves_every_frame():
    cfg = small_cfg(pipelined_readback=False)
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    for i, T in enumerate(orbit_poses(3, step=0.02)):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        assert sys_._fused_pending is None
        assert len(sys_.trajectory) == i + 1 and bool(f.pose_ok)


def test_metrics_reset_and_shutdown():
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    sink = io.StringIO()
    sys_ = SlamSystem(cfg, enable_objects=True, device="cpu",
                      metrics=MetricsStream(sink))
    frames = [scene.render_rgbd(T)[:3] for T in orbit_poses(3, step=0.02)]
    for i, (g, d, rgb) in enumerate(frames):
        sys_.track_rgbd(g, d, rgb, None, timestamp=i / 30.0)
    recs = [json.loads(x) for x in sink.getvalue().splitlines()]
    assert [r["frame"] for r in recs] == [0, 1, 2]
    assert [r["state"] for r in recs] == ["OK"] * 3
    assert recs[0]["kf_inserted"] and recs[0]["ref_kf"] == 0
    assert set(recs[0]) == {"frame", "ts", "state", "track_ms", "n_inliers",
                            "kf_inserted", "ref_kf", "frames_since_kf"}
    sys_.shutdown()
    assert sys_._fused_pending is None and len(sys_.trajectory) == 3
    sys_.reset()
    assert sys_.state == 0 and sys_.trajectory == [] and sys_.n_keyframes == 0
    assert sys_.objects.semantic_constraints == 0
    g, d, rgb = frames[0]
    f = sys_.track_rgbd(g, d, rgb, None, timestamp=1.0)
    assert bool(f.pose_ok) and sys_.n_keyframes == 1


def test_lost_frame_takes_the_staged_path():
    """A dark frame fails the fused chain; the next frame sees LOST and
    runs the staged path, which fails too (no match anywhere) and records
    it LOST without relocalizing."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    staged = []
    track_staged = sys_._track_staged

    def spy(frame):
        staged.append(sys_.frame_id)
        return track_staged(frame)
    sys_._track_staged = spy
    g, d, rgb, _ = scene.render_rgbd(orbit_poses(1)[0])
    sys_.track_rgbd(g, d, rgb, None, timestamp=0.0)
    dark = (np.zeros_like(g), np.zeros_like(d), np.zeros_like(rgb))
    for i in (1, 2, 3):
        sys_.track_rgbd(*dark, None, timestamp=i / 30.0)
    assert staged == [3]
    assert sys_.get_tracking_state() == LOST
    assert [r.tracked for r in sys_.trajectory] == [True, False, False,
                                                    False]
    assert sys_.n_relocalized == 0
    assert torch.equal(sys_.velocity, torch.eye(4))
