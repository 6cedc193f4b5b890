"""The slice as a whole: SlamSystem.track_rgbd of the PyTorch port (objects
off, strict readback, on the CPU) against the JAX SlamSystem on the verify
skill's 12-frame orbit, scene seed 1. The JAX run comes from the committed
fixture (tests/torch_fixtures/make_reference.py); the inputs are
re-rendered with the port's copy of synthetic.py and checked against the
fixture's checksums."""

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
    assert run["sys"].n_reloc_skipped == 0


@pytest.mark.parametrize("kwargs,tracking", [
    (dict(enable_objects=False, enable_loop=True), {}),
    (dict(enable_objects=False, async_mapping=True), {}),
    (dict(enable_objects=False), dict(pipelined_readback=True)),
    (dict(enable_objects=False), dict(fused=False)),
])
def test_options_outside_the_slice_raise(kwargs, tracking):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSystem(small_cfg(**tracking), device="cpu", **kwargs)


def test_other_sensors_and_blob_entry_raise():
    with pytest.raises(NotImplementedError):
        SlamSystem(small_cfg().replace(sensor="stereo"),
                   enable_objects=False, device="cpu")
    sys_ = SlamSystem(small_cfg(), enable_objects=False, device="cpu")
    with pytest.raises(NotImplementedError):
        sys_.track_rgbd_blob(np.zeros(8, np.uint8), None)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamSystem(small_cfg(), enable_objects=False)
