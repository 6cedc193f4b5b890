"""Tracking, keyframe insertion and local mapping of the PyTorch port
against the JAX package, on one JAX map and frame carried across with
object_slam_tpu_torch.interop. The JAX side comes from the committed
fixture (tests/torch_fixtures/make_reference.py): the fused step and the
mapping pass take minutes to compile on the CPU."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.slam import map_ops as j_map_ops
from object_slam_tpu.slam import map_state as j_map_state
from object_slam_tpu.slam import tracking as j_trk
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SlamConfig,
                                          TrackingConfig)
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.slam import local_mapping, map_ops
from object_slam_tpu_torch.slam import tracking as t_trk
from object_slam_tpu_torch.slam import map_state as t_map_state
from object_slam_tpu_torch.slam.map_state import MapState
from torch_fixtures.threads import share_cores

share_cores()

FIXTURE = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                       "slice1.npz")


def small_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        tracking=TrackingConfig(pipelined_readback=False))


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _sub(fx, prefix):
    n = len(prefix) + 1
    return {k[n:]: fx[k] for k in fx.files if k.startswith(prefix + ".")}


def _consts(cfg):
    sf = torch.tensor([cfg.orb.scale_factor ** l
                       for l in range(cfg.orb.n_levels)], dtype=torch.float32)
    inv_s2 = torch.tensor(1.0 / np.asarray(
        [cfg.orb.scale_factor ** (2 * l) for l in range(cfg.orb.n_levels)]),
        dtype=torch.float32)
    return Intrinsics.from_config(cfg.camera), sf, inv_s2


INT_KINDS = "biu"


def _assert_map_close(got: MapState, want: dict, rtol=1e-4, atol=1e-5):
    """Integer and bool slabs exact; float slabs within rtol or atol."""
    g = interop.map_state_to_numpy(got)
    for f in MapState._fields:
        a, b = g[f], want[f]
        assert a.shape == b.shape, f
        if b.dtype.kind in INT_KINDS:
            bad = np.argwhere(a != b)
            assert bad.size == 0, f"{f}: {len(bad)} entries differ"
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f)


def test_fused_step_matches_jax(fx):
    """Same kp_pt and need_kf; the 58-value packed vector within 1e-4
    (float32 pose solves summing in another order)."""
    cfg = small_cfg()
    K, sf, inv_s2 = _consts(cfg)
    m = interop.map_state_from_numpy(_sub(fx, "fused.m_in"), device="cpu")
    frame = interop.frame_from_numpy(_sub(fx, "fused.frame"), cfg,
                                     device="cpu")
    last = interop.frame_from_numpy(_sub(fx, "fused.last"), cfg, device="cpu")
    m2, tr2, _, packed, vel, ok = t_trk.track_frame_fused(
        K, m, frame, last, torch.from_numpy(fx["fused.velocity"]),
        int(fx["fused.last_kf_id"]), int(fx["fused.frames_since_kf"]),
        int(fx["fused.frame_id"]), int(fx["fused.last_kf_inliers"]),
        sf, inv_s2, math.log(cfg.orb.scale_factor),
        motion_radius=cfg.tracking.motion_model_radius,
        close_depth=cfg.camera.th_depth * cfg.camera.baseline,
        max_frames_between_kf=cfg.tracking.max_frames_between_kf,
        local_cap=cfg.caps.local_search_pts)
    want = fx["fused.packed"]
    assert packed.shape == want.shape == (58,)
    assert np.array_equal(tr2.kp_pt.numpy(), fx["fused.kp_pt"])
    np.testing.assert_allclose(packed.numpy(), want, atol=1e-4, rtol=0)
    assert packed[48].item() == want[48] == 1.0
    assert packed[49].item() == want[49]
    assert packed[57].item() == want[57]
    assert bool(ok) == bool(fx["fused.ok"])
    _assert_map_close(m2, _sub(fx, "fused.m_out"))


def test_insert_keyframe_matches_jax(fx):
    """Integer fields exact (allocation, bindings, parent); floats 1e-5."""
    cfg = small_cfg()
    K, sf, _ = _consts(cfg)
    from object_slam_tpu_torch.slam.system import SlamSystem
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    m = interop.map_state_from_numpy(_sub(fx, "insert.m_in"), device="cpu")
    frame = interop.frame_from_numpy(_sub(fx, "insert.frame"), cfg,
                                     device="cpu")
    m2, kf_id = sys_._insert_impl(
        m, frame, torch.from_numpy(fx["insert.Tcw"]),
        torch.from_numpy(fx["insert.kp_pt"]),
        torch.from_numpy(fx["insert.close_mask"]),
        int(fx["insert.frame_id"]))
    assert kf_id == int(fx["insert.kf_id"])
    _assert_map_close(m2, _sub(fx, "insert.m_out"))


def test_process_new_keyframe_matches_jax(fx):
    """The whole local-mapping pass at the third keyframe: integer slabs
    exact; floats within 1e-4 relative or 1e-5 absolute."""
    cfg = small_cfg()
    K, sf, inv_s2 = _consts(cfg)
    m_in = _sub(fx, "mapping.m_in")
    kf_id = int(fx["mapping.kf_id"])
    assert kf_id >= 2
    m = interop.map_state_from_numpy(m_in, device="cpu")
    m2 = local_mapping.process_new_keyframe(K, m, kf_id, sf, inv_s2, cfg)
    want = _sub(fx, "mapping.m_out")
    # the pass did work of every kind
    assert want["pt_valid"].sum() != m_in["pt_valid"].sum()
    assert np.any(want["kf_pose"] != m_in["kf_pose"])
    _assert_map_close(m2, want)


def test_select_local_points_matches_jax(fx):
    m_np = _sub(fx, "fused.m_in")
    kp_pt = _sub(fx, "fused.last")["kp_pt"]
    jm = JMapState(**{f: jnp.asarray(m_np[f]) for f in JMapState._fields})
    jp, jok, jref = j_trk.select_local_points(jm, jnp.asarray(kp_pt),
                                              cap=512)
    tp, tok, tref = t_trk.select_local_points(
        interop.map_state_from_numpy(m_np, device="cpu"),
        torch.from_numpy(kp_pt), cap=512)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert int(tref) == int(jref)
    assert np.asarray(jok).sum() > 20


def test_cull_points_matches_jax(fx):
    m_np = _sub(fx, "mapping.m_in")
    kf_id = int(fx["mapping.kf_id"])
    jm = JMapState(**{f: jnp.asarray(m_np[f]) for f in JMapState._fields})
    want = j_map_ops.cull_points(jm, kf_id)
    got = map_ops.cull_points(
        interop.map_state_from_numpy(m_np, device="cpu"), kf_id)
    _assert_map_close(got, {f: np.asarray(getattr(want, f))
                            for f in JMapState._fields})


def _jmap(m_np):
    return JMapState(**{f: jnp.asarray(m_np[f]) for f in JMapState._fields})


def test_recompute_point_stats_matches_jax(fx):
    """The full-slab refresh: elected descriptors and observation counts
    exact, normals within 1e-5."""
    m_np = _sub(fx, "mapping.m_out")
    want = j_map_state.recompute_point_stats(_jmap(m_np))
    got = t_map_state.recompute_point_stats(
        interop.map_state_from_numpy(m_np, device="cpu"))
    _assert_map_close(got, {f: np.asarray(getattr(want, f))
                            for f in JMapState._fields})


def test_covisibility_matches_jax(fx):
    m_np = _sub(fx, "mapping.m_out")
    want = np.asarray(j_map_state.covisibility(_jmap(m_np)))
    got = t_map_state.covisibility(
        interop.map_state_from_numpy(m_np, device="cpu"))
    assert np.array_equal(got.numpy(), want)
    assert want.max() > 20


@pytest.mark.parametrize("args", [
    (120, 80, 40, 90, 3, 10), (20, 80, 150, 10, 31, 100),
    (50, 200, 90, 80, 2, 40), (16, 10, 20, 50, 0, 30)])
def test_kf_decision_matches_jax(args):
    n_inl, ref, c_trk, c_untrk, since, last_inl = args
    for min_gap in (0, 2, 10 ** 9):
        want = bool(j_trk.kf_decision(n_inl, ref, c_trk, c_untrk, since, 30,
                                      last_kf_inliers=last_inl,
                                      min_gap=min_gap))
        got = t_trk.need_new_keyframe(n_inl, ref, c_trk, c_untrk, since, 30,
                                      last_kf_inliers=last_inl,
                                      min_gap=min_gap)
        assert got == want
