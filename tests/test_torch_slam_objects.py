"""The objects-on path of the PyTorch port against the JAX package on the
CPU: one fused tracking step with the object hooks, and the system run of
the object-stability scene (tests/test_slam.py TestObjectStability: seed
3, two boxes of size 0.8 at fixed centres, mask_margin 3, min_kps_rgbd 4,
8 frames), objects on, strict readback. The JAX side comes from
tests/torch_fixtures/objects.npz (make_reference.py); the inputs are
re-rendered with the port's synthetic.py and checked against its
checksums.

Tolerances: fused step packed 1e-4 with obj3d and kp_pt exact and the
map's integer slabs exact; system run per-frame obj3d identical,
obj_valid / obj_label / obj_track_id identical, semantic_constraints
within 2%, poses within 2 mm / 0.1 deg. An objects-on run fed no
detections equals the objects-off run exactly."""

import math
import os

import numpy as np
import pytest
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SemanticConfig,
                                          SlamConfig, TrackingConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      orbit_poses)
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.slam import tracking as t_trk
from object_slam_tpu_torch.slam.objects import ObjectEngine
from object_slam_tpu_torch.slam.system import SlamSystem
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "objects.npz")
N_FRAMES = 8


def objects_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        semantic=SemanticConfig(mask_margin=3, min_kps_rgbd=4),
        tracking=TrackingConfig(pipelined_readback=False))


def object_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=3.0)
    for k, b in enumerate(scene.boxes):
        b["size"] = 0.8
        b["center"] = np.array([(-0.75, 0.75)[k], 0.1, 2.0])
    return scene, orbit_poses(N_FRAMES, step=0.008)


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _sub(fx, prefix):
    n = len(prefix) + 1
    return {k[n:]: fx[k] for k in fx.files if k.startswith(prefix + ".")}


def _slab(fx, prefix, width):
    s = _sub(fx, prefix)
    s["masks"] = np.unpackbits(s.pop("masks_packed"), axis=-1)[
        ..., :width].astype(bool)
    return s


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_fused_step_with_object_hooks(fx):
    cfg = objects_cfg()
    K = Intrinsics.from_config(cfg.camera)
    sf = torch.tensor([cfg.orb.scale_factor ** l
                       for l in range(cfg.orb.n_levels)], dtype=torch.float32)
    inv_s2 = torch.tensor(1.0 / np.asarray(
        [cfg.orb.scale_factor ** (2 * l) for l in range(cfg.orb.n_levels)]),
        dtype=torch.float32)
    W = cfg.camera.width
    m = interop.map_state_from_numpy(_sub(fx, "fused.m_in"), device="cpu")
    frame = interop.frame_from_numpy(_sub(fx, "fused.frame"), cfg,
                                     device="cpu",
                                     obj=_slab(fx, "fused.frame.obj", W))
    last = interop.frame_from_numpy(_sub(fx, "fused.last"), cfg,
                                    device="cpu",
                                    obj=_slab(fx, "fused.last.obj", W))
    eng = ObjectEngine(cfg, K, device="cpu")
    m2, tr2, obj3d, packed, vel, ok = t_trk.track_frame_fused(
        K, m, frame, last, torch.from_numpy(fx["fused.velocity"]),
        int(fx["fused.last_kf_id"]), int(fx["fused.frames_since_kf"]),
        int(fx["fused.frame_id"]), int(fx["fused.last_kf_inliers"]),
        sf, inv_s2, math.log(cfg.orb.scale_factor),
        motion_radius=cfg.tracking.motion_model_radius,
        close_depth=cfg.camera.th_depth * cfg.camera.baseline,
        max_frames_between_kf=cfg.tracking.max_frames_between_kf,
        local_cap=cfg.caps.local_search_pts,
        obj_hooks=(eng.assoc_impl, eng.semopt_impl, eng.update_impl))
    want = fx["fused.packed"]
    assert want[56] > 0                       # semopt engaged
    assert np.array_equal(obj3d.numpy(), fx["fused.obj3d"])
    assert np.array_equal(tr2.kp_pt.numpy(), fx["fused.kp_pt"])
    np.testing.assert_allclose(packed.numpy(), want, atol=1e-4, rtol=0)
    assert packed[56].item() == want[56]
    assert bool(ok) == bool(fx["fused.ok"])
    got = interop.map_state_to_numpy(m2)
    for f, b in _sub(fx, "fused.m_out").items():
        if b.dtype.kind in "biu":
            assert np.array_equal(got[f], b), f
        else:
            np.testing.assert_allclose(got[f], b, rtol=1e-4, atol=1e-5,
                                       err_msg=f)


def _run(cfg, enable_objects, with_dets=True, n_frames=N_FRAMES):
    scene, poses = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=enable_objects, device="cpu")
    out = {"obj3d": [], "tcw": [], "ok": [], "gray_sum": []}
    for i, T in enumerate(poses[:n_frames]):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances) \
            if with_dets else None
        f = sys_.track_rgbd(gray, depth, rgb, sa, i / 30.0)
        out["obj3d"].append(f.obj3d.numpy())
        out["tcw"].append(f.Tcw.numpy())
        out["ok"].append(bool(f.pose_ok))
        out["gray_sum"].append(float(np.sum(gray, dtype=np.float64)))
    out["sys"] = sys_
    return out


@pytest.fixture(scope="module")
def run():
    return _run(objects_cfg(), True)


def test_inputs_match_fixture_checksums(run, fx):
    np.testing.assert_allclose(run["gray_sum"], fx["inputs.gray_sum"],
                               rtol=1e-9, atol=0)


def test_per_frame_obj3d_identical(run, fx):
    assert np.array_equal(np.stack(run["obj3d"]), fx["system.obj3d"])
    # both objects keep their identity from the first frame on
    assert (fx["system.obj3d"][:, :2] >= 0).all()


def test_object_slabs_identical(run, fx):
    m = run["sys"].map
    for f in ("obj_valid", "obj_label", "obj_track_id"):
        assert np.array_equal(getattr(m, f).numpy(), fx[f"system.{f}"]), f
    assert int(fx["system.obj_valid"].sum()) == 2


def test_semantic_constraints_within_2_percent(run, fx):
    want = int(fx["system.semantic_constraints"])
    got = run["sys"].objects.semantic_constraints
    assert want > 50
    assert abs(got - want) <= 0.02 * want


def test_tracked_and_poses_within_2mm_and_0_1deg(run, fx):
    assert run["ok"] == list(fx["system.tracked"]) and all(run["ok"])
    for a, b in zip(run["tcw"], fx["system.tcw"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 2e-3
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1
    assert np.array_equal(run["sys"].map.kf_frame_id.numpy(),
                          fx["system.kf_frame_id"])
    got = np.stack([t[1] for t in run["sys"].final_trajectory()])
    assert np.abs(got[:, :3, 3] - fx["system.final_tcw"][:, :3, 3]).max() \
        < 2e-3


def test_objects_on_without_detections_equals_objects_off():
    cfg = objects_cfg()
    on = _run(cfg, True, with_dets=False, n_frames=4)
    off = _run(cfg, False, with_dets=False, n_frames=4)
    for a, b in zip(on["tcw"], off["tcw"]):
        assert np.array_equal(a, b)
    assert on["ok"] == off["ok"]
    assert on["sys"].objects.semantic_constraints == 0
    ma = interop.map_state_to_numpy(on["sys"].map)
    mb = interop.map_state_to_numpy(off["sys"].map)
    for f in ma:
        assert np.array_equal(ma[f], mb[f]), f


def test_objects_off_frame_with_detections_builds_the_slab():
    """The reference's dispatch: a frame with a valid detection builds its
    Object2D slab whether or not the system runs objects."""
    cfg = objects_cfg()
    scene, poses = object_scene(cfg)
    gray, depth, rgb, sem = scene.render_rgbd(poses[0])
    sa = scene.sem_arrays(sem, cfg.semantic.max_instances)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    f = sys_.track_rgbd(gray, depth, rgb, sa, 0.0)
    assert int(f.obj.valid.sum()) == 2
    assert (f.obj.kp2obj >= 0).sum() > 0
    assert sys_.objects is None
