"""Localization mode and map checkpoints of the PyTorch port against the
JAX package on the CPU.

* ``tracking.track_motion_model_vo`` on the inputs of one VO motion call
  of the JAX run below (tests/torch_fixtures/localization_small.npz);
* tests/test_slam.py's mid-sequence switch (18 frames of the 160x120
  orbit, objects off, localization mode from frame 9) against the JAX
  run: tracked flags, keyframes, the map's counts at the switch and the
  VO calls' map-match and inlier counts;
* ``SlamSystem(enable_mapping=False)`` and the mode switches;
* checkpoint files in both directions at full ``SlamConfig.tum_rgbd()``
  caps (the map of loop_pass_tum_vga.npz: 32,768 points, 512 keyframes,
  BoW rows), the ``kf_tcp`` and ``kf_frame_id`` backfills, and a mid-run
  ``shutdown(path)`` / ``load_into_system`` round trip against a run that
  only flushes.

Tolerances: the VO call's pose 1e-4, its matches, inliers and map-match
count exact; the switch run's flags, keyframe frames, VO frames and counts
exact, its records within 1 mm / 0.1 deg; checkpoint fields exact in the
reference's dtypes; the round trip bit-identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.slam import checkpoint as j_ckpt
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SlamConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      orbit_poses)
from object_slam_tpu_torch.slam import checkpoint as t_ckpt
from object_slam_tpu_torch.slam import tracking as t_trk
from object_slam_tpu_torch.slam.map_state import MapState, init_map
from object_slam_tpu_torch.slam.system import OK, SlamSystem
from torch_fixtures.threads import share_cores

share_cores()

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")
REC_M = 1e-3
REC_DEG = 0.1


def small_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64))


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(FIXTURES, "localization_small.npz"))


def _under(fx, prefix):
    return {k[len(prefix):]: fx[k] for k in fx.files if k.startswith(prefix)}


def _rot_deg(Ra, Rb):
    c = np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)
    return float(np.degrees(np.arccos(c)))


def test_track_motion_model_vo_matches_reference(fx):
    cfg = small_cfg()
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    m = interop.map_state_from_numpy(_under(fx, "vo.m."), device="cpu")
    frame = interop.frame_from_numpy(_under(fx, "vo.frame."), cfg, "cpu")
    last = interop.frame_from_numpy(_under(fx, "vo.last."), cfg, "cpu")
    tr, n_map = t_trk.track_motion_model_vo(
        sys_.K, m, frame, last, torch.from_numpy(fx["vo.T_pred"]),
        sys_.scale_factors, sys_.inv_sigma2)
    np.testing.assert_allclose(tr.Tcw.numpy(), fx["vo.Tcw"], atol=1e-4)
    np.testing.assert_array_equal(tr.kp_pt.numpy(), fx["vo.kp_pt"])
    np.testing.assert_array_equal(tr.inlier.numpy(), fx["vo.inlier"])
    assert int(tr.n_matches) == int(fx["vo.n_matches"])
    assert int(tr.n_inliers) == int(fx["vo.n_inliers"])
    assert int(n_map) == int(fx["vo.n_map"])
    # the temporal points really carry the pose: matches beyond map points
    assert int(tr.n_inliers) > int(n_map)


@pytest.fixture(scope="module")
def switch_run(fx):
    """The 18-frame orbit with localization mode from frame 9, recording
    each VO motion call's map-match count."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    vo, counts, gray_sum = [], {}, []
    orig = t_trk.track_motion_model_vo

    def vo_rec(*args, **kw):
        tr, n_map = orig(*args, **kw)
        vo.append((sys_.frame_id, int(n_map), int(tr.n_inliers)))
        return tr, n_map
    t_trk.track_motion_model_vo = vo_rec
    try:
        for i, T in enumerate(orbit_poses(len(fx["tracked"]), step=0.015)):
            if i == int(fx["switch"][0]):
                sys_.activate_localization_mode()
                assert sys_._fused_pending is None
                counts["on"] = (sys_.n_keyframes, sys_.n_points)
            gray, depth, rgb, _ = scene.render_rgbd(T)
            gray_sum.append(float(np.sum(gray, dtype=np.float64)))
            sys_.track_rgbd(gray.astype(np.float32), depth.astype(np.float32),
                            rgb.astype(np.float32), None, timestamp=i / 30.0)
    finally:
        t_trk.track_motion_model_vo = orig
    sys_.flush_mapping()
    return sys_, vo, counts, gray_sum


def test_mid_sequence_switch_matches_reference(fx, switch_run):
    sys_, vo, counts, gray_sum = switch_run
    np.testing.assert_allclose(gray_sum, fx["gray_sum"], rtol=1e-12)
    tracked = np.asarray([r.tracked for r in sys_.trajectory])
    np.testing.assert_array_equal(tracked, fx["tracked"])
    m = sys_.map
    np.testing.assert_array_equal(m.kf_frame_id[m.kf_valid].numpy(),
                                  fx["kf_frames"])
    assert counts["on"] == (int(fx["n_kf_on"]), int(fx["n_points_on"]))
    # no keyframe and no point while the mode is on
    assert (sys_.n_keyframes, sys_.n_points) == counts["on"]
    assert int(fx["n_points"]) == sys_.n_points
    np.testing.assert_array_equal([v[0] for v in vo], fx["vo_frames"])
    np.testing.assert_array_equal([v[1] for v in vo], fx["vo_n_map"])
    np.testing.assert_array_equal([v[2] for v in vo], fx["vo_n_inliers"])
    rec = np.stack([r.Tcw for r in sys_.trajectory])
    dt = np.abs(rec[:, :3, 3] - fx["rec_tcw"][:, :3, 3]).max()
    dr = max(_rot_deg(a, b) for a, b in zip(rec[:, :3, :3],
                                             fx["rec_tcw"][:, :3, :3]))
    assert dt < REC_M and dr < REC_DEG, (dt, dr)


def test_every_localization_frame_is_staged(fx):
    """In localization mode the fused route is closed (the reference's
    enable_mapping gate): every frame goes through _track_staged."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    staged, fused = [], []
    st, fu = sys_._track_staged, sys_._track_fused
    sys_._track_staged = lambda f: (staged.append(sys_.frame_id), st(f))[1]
    sys_._track_fused = lambda f: (fused.append(sys_.frame_id), fu(f))[1]
    for i, T in enumerate(orbit_poses(6, step=0.015)):
        if i == 3:
            sys_.activate_localization_mode()
        if i == 5:
            sys_.deactivate_localization_mode()
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
    assert staged == [3, 4] and fused == [1, 2, 5]


def test_enable_mapping_false_from_the_start():
    """SlamSystem(enable_mapping=False): the first frame with depth still
    initializes the map (as the reference's), later frames only track."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_mapping=False,
                      device="cpu")
    for i, T in enumerate(orbit_poses(4, step=0.015)):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        assert bool(f.pose_ok)
    assert sys_.n_keyframes == 1 and sys_.state == OK
    assert sys_.mapping_stats["passes"] == 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_map():
    """loop_pass_tum_vga.npz's map: SlamConfig.tum_rgbd() caps with BoW
    rows, in the reference's layout."""
    d = np.load(os.path.join(FIXTURES, "loop_pass_tum_vga.npz"))
    base = interop.map_state_to_numpy(init_map(
        SlamConfig.tum_rgbd().caps, n_bow_words=d["in.kf_bow"].shape[1],
        device="cpu"))
    rows = {k[3:]: d[k] for k in d.files if k.startswith("in.")}
    return interop.overlay_rows(base, rows)


def _assert_fields_equal(got, want):
    assert set(got) == set(want) == set(MapState._fields)
    for f in MapState._fields:
        a, b = np.asarray(got[f]), np.asarray(want[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_reference_checkpoint_loads_in_the_port(tmp_path, big_map):
    path = str(tmp_path / "jax.npz")
    jm = JMapState(**{f: jnp.asarray(big_map[f]) for f in JMapState._fields})
    j_ckpt.save_map(path, jm, {"state": 1})
    m, meta = t_ckpt.load_map(path, device="cpu")
    assert meta["version"] == 1 and meta["state"] == 1
    _assert_fields_equal(interop.map_state_to_numpy(m), big_map)


def test_port_checkpoint_loads_in_the_reference(tmp_path, big_map):
    path = str(tmp_path / "port.npz")
    t_ckpt.save_map(path, interop.map_state_from_numpy(big_map, "cpu"),
                    {"state": 2})
    # the file itself, read back with numpy: the reference's layout
    d = np.load(path)
    _assert_fields_equal({f: d[f] for f in MapState._fields}, big_map)
    m, meta = j_ckpt.load_map(path)
    assert meta["fields"] == list(MapState._fields) and meta["state"] == 2
    _assert_fields_equal({f: np.asarray(getattr(m, f))
                          for f in JMapState._fields}, big_map)


def test_backfills_of_older_files(tmp_path):
    """A file without kf_tcp gets the identity in both packages; one
    without kf_frame_id gets -1 in the port, where the reference raises
    KeyError (the port's departure, ROADMAP.md queue 3)."""
    arrays = interop.map_state_to_numpy(init_map(small_cfg().caps,
                                                 device="cpu"))
    arrays["kf_pose"][:] = np.eye(4) * 2.0
    for missing in ("kf_tcp", "kf_frame_id"):
        path = str(tmp_path / f"no_{missing}.npz")
        np.savez(path, **{f: v for f, v in arrays.items() if f != missing})
        m, meta = t_ckpt.load_map(path, device="cpu")
        assert meta == {}
        got = getattr(m, missing).numpy()
        if missing == "kf_tcp":
            np.testing.assert_array_equal(got, np.broadcast_to(
                np.eye(4, dtype=np.float32), got.shape))
            jm, _ = j_ckpt.load_map(path)
            np.testing.assert_array_equal(np.asarray(jm.kf_tcp), got)
        else:
            assert got.dtype == np.int32 and np.all(got == -1)
            with pytest.raises(KeyError):
                j_ckpt.load_map(path)


def _run(cfg, scene, poses, at, action):
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    for i, T in enumerate(poses):
        if i == at:
            action(sys_)
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
    sys_.flush_mapping()
    return sys_


def test_mid_run_round_trip_is_bit_identical(tmp_path):
    """shutdown(path) then load_into_system(path) on the same system, at a
    frame whose fused readback is still pending, against a run that only
    flushes there: the same records and map, bit for bit."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    poses = orbit_poses(9, step=0.02)
    path = str(tmp_path / "mid.npz")
    seen = {}

    def round_trip(s):
        s.shutdown(path)
        seen["n_traj"] = len(s.trajectory)
        seen["meta"] = t_ckpt.load_into_system(path, s)

    a = _run(cfg, scene, poses, 5, round_trip)
    b = _run(cfg, scene, poses, 5, lambda s: s.flush_mapping())
    # the flush ran before the write: every frame so far is recorded
    assert seen["meta"]["n_trajectory"] == seen["n_traj"] == 5
    assert seen["meta"]["state"] == OK
    assert len(a.trajectory) == len(b.trajectory) == len(poses)
    for ra, rb in zip(a.trajectory, b.trajectory):
        assert ra.tracked == rb.tracked and ra.ref_kf == rb.ref_kf
        np.testing.assert_array_equal(ra.Tcw, rb.Tcw)
        np.testing.assert_array_equal(ra.Tcr, rb.Tcr)
    _assert_fields_equal(interop.map_state_to_numpy(a.map),
                         interop.map_state_to_numpy(b.map))


def test_fresh_system_cannot_resume_from_a_checkpoint(tmp_path):
    """The reference's load_into_system restores neither the last frame nor
    the trajectory (checkpoint.py:72-81): a fresh system that loads a
    checkpoint taken in state OK fails on its next frame reading the last
    frame (system.py:749). The port keeps that contract (ROADMAP.md,
    queue 3)."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    path = str(tmp_path / "ok.npz")
    _run(cfg, scene, orbit_poses(3, step=0.02), None, None).shutdown(path)
    fresh = SlamSystem(cfg, enable_objects=False, device="cpu")
    t_ckpt.load_into_system(path, fresh)
    assert fresh.state == OK and fresh.last_frame is None
    assert fresh.trajectory == [] and fresh.frame_id == 3
    gray, depth, rgb, _ = scene.render_rgbd(orbit_poses(4, step=0.02)[3])
    with pytest.raises(AttributeError):
        fresh.track_rgbd(gray, depth, rgb, None, timestamp=0.1)
