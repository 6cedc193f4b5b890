"""The slice as a whole: SlamSystem.track_rgbd of the PyTorch port (objects
off, strict readback, on the CPU) against the JAX SlamSystem on the verify
skill's 12-frame orbit, scene seed 1. The JAX run comes from the committed
fixture (tests/torch_fixtures/make_reference.py); the inputs are
re-rendered with the port's copy of synthetic.py and checked against the
fixture's checksums."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SlamConfig,
                                          TrackingConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      orbit_poses)
from object_slam_tpu_torch.eval.ate import ate_rmse
from object_slam_tpu_torch.slam.system import SlamSystem
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "slice1.npz")


def small_cfg(**tracking):
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        tracking=TrackingConfig(**{"pipelined_readback": False, **tracking}))


@pytest.fixture(scope="module")
def run():
    fx = np.load(FIXTURE)
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    poses = orbit_poses(12, step=0.02)
    tcw, oks, est, gt, sums = [], [], [], [], []
    for i, T in enumerate(poses):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sums.append((float(np.sum(gray, dtype=np.float64)),
                     float(np.sum(depth, dtype=np.float64))))
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        Tcw = f.Tcw.numpy()
        tcw.append(Tcw)
        oks.append(bool(f.pose_ok))
        est.append(np.linalg.inv(Tcw)[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
    return dict(fx=fx, sys=sys_, tcw=np.stack(tcw), oks=oks,
                ate=ate_rmse(np.array(est), np.array(gt)),
                sums=np.array(sums))


def test_inputs_match_fixture_checksums(run):
    fx = run["fx"]
    np.testing.assert_allclose(run["sums"][:, 0], fx["inputs.gray_sum"],
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(run["sums"][:, 1], fx["inputs.depth_sum"],
                               rtol=1e-9, atol=0)


def test_tracked_flags_identical(run):
    assert run["oks"] == list(run["fx"]["system.tracked"])
    assert all(run["oks"])


def test_keyframe_frames_and_count_identical(run):
    fx, sys_ = run["fx"], run["sys"]
    assert sys_.n_keyframes == int(fx["system.n_keyframes"])
    assert np.array_equal(sys_.map.kf_frame_id.numpy(),
                          fx["system.kf_frame_id"])
    assert np.array_equal(sys_.map.kf_valid.numpy(), fx["system.kf_valid"])


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_per_frame_poses_within_2mm_and_0_1deg(run):
    for a, b in zip(run["tcw"], run["fx"]["system.tcw"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 2e-3
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1


def test_final_trajectory_within_2mm(run):
    got = np.stack([t[1] for t in run["sys"].final_trajectory()])
    want = run["fx"]["system.final_tcw"]
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() < 2e-3


def test_map_point_count_within_2_percent(run):
    want = int(run["fx"]["system.n_points"])
    assert abs(run["sys"].n_points - want) <= 0.02 * want


def test_ate_matches_jax(run):
    ate_jax = float(run["fx"]["system.ate"])
    assert abs(run["ate"] - ate_jax) <= 2e-3
    assert run["ate"] < 0.05 and ate_jax < 0.05


def test_no_relocalization_needed(run):
    assert run["sys"].n_relocalized == 0


@pytest.mark.parametrize("kwargs,tracking", [
    (dict(enable_objects=False, enable_mapping=False), {}),
])
def test_options_outside_the_slice_raise(kwargs, tracking):
    """No option is outside the port any more: enable_mapping=False, the
    last one that raised NotImplementedError, builds a system in
    localization mode (slice 7; tests/test_torch_localization.py runs
    it)."""
    sys_ = SlamSystem(small_cfg(**tracking), device="cpu", **kwargs)
    assert sys_.enable_mapping is False and sys_.objects is None


def test_enable_loop_builds_the_closer():
    """Loop closing is ported: enable_loop=True builds the closer with the
    package's 10^4-word vocabulary and a [max_keyframes, n_words] kf_bow
    (f32, zero), without a vocab_path as with one."""
    cfg = small_cfg()
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cpu")
    lc = sys_.loop_closer
    assert lc is not None and lc.vocab.n_words == 10000 and lc.fix_scale
    assert sys_.map.kf_bow.shape == (cfg.caps.max_keyframes, 10000)
    assert sys_.map.kf_bow.dtype == torch.float32
    assert not bool(torch.any(sys_.map.kf_bow != 0))
    assert SlamSystem(cfg, enable_objects=False,
                      device="cpu").map.kf_bow.shape[1] == 1


def test_other_sensors_and_blob_entry_raise():
    """The mono sensor is ported (slice 7: a mono system holds its first
    frame as the initializer's reference view); the blob entry refuses a
    blob whose size is not the geometry's layout."""
    mono = SlamSystem(small_cfg().replace(sensor="mono"),
                      enable_objects=False, device="cpu")
    f = mono.track_mono(np.zeros((120, 160), np.float32), timestamp=0.0)
    assert not bool(f.pose_ok) and mono._mono_ref is not None
    sys_ = SlamSystem(small_cfg(), enable_objects=False, device="cpu")
    with pytest.raises(ValueError, match="bytes"):
        sys_.track_rgbd_blob(np.zeros(8, np.uint8), None)


@pytest.mark.parametrize("tracking", [dict(pipelined_readback=True),
                                      dict(fused=False)])
def test_blob_entry_equals_array_entry(tracking):
    """The default readback and the staged path run, and the blob entry
    tracks exactly as the array entry on the same u16 / u8 frames."""
    cfg = small_cfg(**tracking)
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera,
                                                 depth_map_factor=1000.0))
    scene = SyntheticScene.make(cfg, seed=1, n_objects=2)
    a = SlamSystem(cfg, enable_objects=False, device="cpu")
    b = SlamSystem(cfg, enable_objects=False, device="cpu")
    for i, T in enumerate(orbit_poses(3, step=0.02)):
        _, depth, rgb, _ = scene.render_rgbd(T)
        d16 = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
        a.track_rgbd(None, d16, rgb8, None, i / 30.0)
        blob, iv = b.builder.pack_frame_blob(d16, rgb8, None)
        b.track_rgbd_blob(blob, iv, i / 30.0)
    assert a.get_tracking_state() == b.get_tracking_state() == 1
    ta, tb = a.final_trajectory(), b.final_trajectory()
    assert [t[2] for t in ta] == [t[2] for t in tb] == [True] * 3
    for x, y in zip(ta, tb):
        assert np.array_equal(x[1], y[1])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamSystem(small_cfg(), enable_objects=False)
