"""The accuracy studies of scripts/ in the PyTorch port against the JAX
package on the CPU: SlamSystem._last_presem_Tcw, and
scripts/ab_deviations_torch.py's four mapping-policy variants replayed
against the reference's runs recorded in tests/torch_fixtures/studies.npz
(make_reference.py studies). tests/test_torch_studies_loop.py holds the
closure probe and the aliased corridor's gates, and
tests/test_torch_studies_semantic.py the two semantic-refinement probes;
the last test here runs every study script's main() in a process where
the reference cannot be imported.

The variants run the script's configuration at --scale 4 (160x120, 4
levels) with strict readback, on the first VAR_END frames of its
120-frame circuit: the port starts from the JAX system's whole state
after frame VAR_START - 1 of the variant's own run and tracks the rest.
Tolerances (the TUM checks'): tracked flags and keyframe frames exact,
the script's Horn-aligned ATE over all the frames within 0.02 mm, the
replayed frames' records within 2 mm / 0.1 deg, keyframe and point counts
exact. At this size only reelect_descriptors moves the reference's run
(recency_off and scale_cond_on equal base here, and at VGA scale_cond_on
too), so the planted fault ignores that flag and must fail."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.eval.ate import align_horn_svd
from object_slam_tpu_torch.slam.system import FrameRecord, SlamSystem
from torch_fixtures import faults
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "studies.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import ab_deviations_torch as ab  # noqa: E402

VARIANTS = ("base", "recency_off", "no_reelect", "scale_cond_on")
VAR_START, VAR_END = 1, 5          # make_reference.py VAR_SMALL_*
ATE_TOL_MM = 0.02
REC_TOL_M = 2e-3
REC_TOL_DEG = 0.1


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _sub(fx, prefix):
    return {k[len(prefix):]: fx[k] for k in fx.files if k.startswith(prefix)}


def _rot_deg(a, b):
    R = a[:3, :3].T.astype(np.float64) @ b[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def start_from(sys_, fx, prefix):
    """Set a port system (loop closing off) to a JAX system's captured
    state (make_reference.py plain_state, under prefix)."""
    base = interop.map_state_to_numpy(sys_.map)
    sys_.map = interop.map_state_from_numpy(
        interop.overlay_rows(base, _sub(fx, prefix + "m.")), device="cpu")
    sys_.last_frame = interop.frame_from_numpy(_sub(fx, prefix + "last."),
                                               sys_.cfg, device="cpu")
    sys_.velocity = torch.from_numpy(np.array(fx[prefix + "velocity"]))
    (sys_.state, sys_.last_kf_id, sys_.frames_since_kf, sys_.frame_id,
     sys_._kf_inliers, sys_._last_n_inliers) = (
        int(x) for x in fx[prefix + "counters"])
    sys_.trajectory = [
        FrameRecord(timestamp=i / 30.0, Tcw=t, ref_kf=int(r), Tcr=c,
                    tracked=bool(ok))
        for i, (t, r, c, ok) in enumerate(zip(
            fx[prefix + "rec_tcw"], fx[prefix + "rec_ref"],
            fx[prefix + "rec_tcr"], fx[prefix + "rec_tracked"]))]


def small_cfg():
    """ab_deviations.build_cfg(4) with strict readback."""
    import dataclasses
    cfg = ab.build_cfg(4)
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, pipelined_readback=False))


def objects_cfg(**tracking):
    """The object-stability scene's configuration (make_reference.py
    objects_cfg)."""
    from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                              OrbConfig, SemanticConfig,
                                              SlamConfig, TrackingConfig)
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        semantic=SemanticConfig(mask_margin=3, min_kps_rgbd=4),
        tracking=TrackingConfig(**tracking))


def object_scene(cfg):
    from object_slam_tpu_torch.datasets.synthetic import SyntheticScene
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=3.0)
    for k, b in enumerate(scene.boxes):
        b["size"] = 0.8
        b["center"] = np.array([(-0.75, 0.75)[k], 0.1, 2.0])
    return scene


def replay_variant(fx, name, cfg=None):
    """The port from the JAX run's state through frame VAR_END - 1: the
    frames' returned poses and flags, the inserted keyframes' frames and
    the system."""
    cfg = cfg if cfg is not None else ab.variant_cfg(small_cfg(), name)
    scene, poses = ab.circuit(cfg, 3, 120, 1.15)
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    start_from(sys_, fx, f"var.{name}.state.")
    inserts = []
    insert = sys_._insert_impl

    def insert_impl(m, frame, Tcw, kp_pt, close_mask, frame_id):
        inserts.append(int(frame_id))
        return insert(m, frame, Tcw, kp_pt, close_mask, frame_id)
    sys_._insert_impl = insert_impl
    ret = []
    for i in range(VAR_START, VAR_END):
        gray, depth, rgb = (np.asarray(x, np.float32)
                            for x in scene.render_rgbd(poses[i])[:3])
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        ret.append((f.Tcw.numpy(), bool(f.pose_ok)))
    return ret, inserts, sys_, poses


def variant_checks(fx, name, ret, inserts, sys_, poses):
    """[(what, port, reference, held)] of one replayed variant."""
    p = f"var.{name}."
    want = json.loads(str(fx[p + "result"]))
    est_t = np.concatenate([fx[p + "ret_tcw"][:VAR_START],
                            np.stack([t for t, _ in ret])])
    ok = np.concatenate([fx[p + "ret_ok"][:VAR_START],
                         [o for _, o in ret]]).astype(bool)
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in est_t])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[:VAR_END]])
    _, _, err = align_horn_svd(est[ok].T, gt[ok].T)
    ate_mm = float(np.sqrt((err ** 2).mean()) * 1e3)
    recs = sys_.trajectory
    d = max(float(np.abs(recs[i].Tcw[:3, 3]
                         - fx[p + "rec_tcw"][i][:3, 3]).max())
            for i in range(VAR_START, VAR_END))
    r = max(_rot_deg(recs[i].Tcw, fx[p + "rec_tcw"][i])
            for i in range(VAR_START, VAR_END))
    want_ins = [f for f in fx[p + "insert_frames"].tolist()
                if f >= VAR_START]
    tracked = [x.tracked for x in recs]
    return [
        ("returned flags", ok.tolist(), fx[p + "ret_ok"].tolist(),
         ok.tolist() == fx[p + "ret_ok"].tolist()),
        ("tracked", tracked, fx[p + "tracked"].tolist(),
         tracked == fx[p + "tracked"].tolist()),
        ("keyframes at", inserts, want_ins, inserts == want_ins),
        ("ATE mm", ate_mm, want["ate_rmse_mm"],
         abs(ate_mm - want["ate_rmse_mm"]) <= ATE_TOL_MM),
        ("records m", d, REC_TOL_M, d <= REC_TOL_M),
        ("records deg", r, REC_TOL_DEG, r <= REC_TOL_DEG),
        ("keyframes", sys_.n_keyframes, want["n_keyframes"],
         sys_.n_keyframes == want["n_keyframes"]),
        ("points", sys_.n_points, want["n_points"],
         sys_.n_points == want["n_points"]),
    ]


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_reference(fx, name):
    """One mapping-policy variant replayed against the JAX run of it."""
    checks = variant_checks(fx, name, *replay_variant(fx, name))
    failed = [c for c in checks if not c[3]]
    assert not failed, failed


def pass_checks(fx, name, cfg=None):
    """[(what, port, reference, held)] of the variant run's first
    local-mapping pass in the replayed frames, the port's pass on the JAX
    pass's input: the same points and keyframes alive, the same
    descriptors, observation counts and viewing ranges (the flags' own
    outputs: culling, re-election, keyframe culling), points and
    keyframe centres within 2 mm."""
    cfg = cfg if cfg is not None else ab.variant_cfg(small_cfg(), name)
    p = f"var.{name}.state.pass."
    sys_ = SlamSystem(cfg, enable_objects=False, device="cpu")
    base = interop.map_state_to_numpy(sys_.map)
    m_in = interop.map_state_from_numpy(
        interop.overlay_rows(base, _sub(fx, p + "in.")), device="cpu")
    want = interop.overlay_rows(base, _sub(fx, p + "out."))
    got = interop.map_state_to_numpy(sys_._mapping_pass(
        m_in, int(fx[p + "kf"]), bool(fx[p + "fast"])))
    pv = got["pt_valid"] & want["pt_valid"]
    kv = got["kf_valid"] & want["kf_valid"]
    checks = [(f, int((got[f] != want[f]).sum()), 0,
               np.array_equal(got[f], want[f]))
              for f in ("pt_valid", "kf_valid")]
    for f in ("pt_desc", "pt_n_obs"):
        n = int(np.any((got[f] != want[f])[pv].reshape(int(pv.sum()), -1),
                       axis=1).sum())
        checks.append((f"{f} rows", n, 0, n == 0))
    for f in ("pt_min_dist", "pt_max_dist"):
        d = float(np.abs(got[f] - want[f])[pv].max())
        checks.append((f, d, 1e-3, d <= 1e-3 * max(
            1.0, float(np.abs(want[f][pv]).max()))))
    d = float(np.abs(got["pt_xyz"] - want["pt_xyz"])[pv].max())
    checks.append(("pt_xyz m", d, REC_TOL_M, d <= REC_TOL_M))
    c = lambda T: np.linalg.inv(T.astype(np.float64))[:3, 3]  # noqa: E731
    d = max(float(np.abs(c(a) - c(b)).max()) for a, b in zip(
        got["kf_pose"][kv], want["kf_pose"][kv]))
    checks.append(("kf centres m", d, REC_TOL_M, d <= REC_TOL_M))
    return checks


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_mapping_pass_matches_reference(fx, name):
    """The variant's first mapping pass in the replayed frames, on the JAX
    pass's input, against the JAX pass's output."""
    failed = [c for c in pass_checks(fx, name) if not c[3]]
    assert not failed, failed


def test_variant_fault_ignored_flag_fails(fx):
    """The no_reelect variant with reelect_descriptors ignored (the
    mapping re-elects descriptors as in base) must miss a check of its
    mapping pass."""
    cfg = faults.ignore_reelect_flag(ab.variant_cfg(small_cfg(),
                                                    "no_reelect"))
    assert cfg.mapping.reelect_descriptors
    assert any(not c[3] for c in pass_checks(fx, "no_reelect", cfg))


def test_variant_list_and_cfg_are_the_reference():
    """The variants' flags and build_cfg's sizes as the reference script
    sets them (8 levels and 1000 features at scale 1, 4 levels below)."""
    assert ab.VARIANTS == {
        "base": {},
        "recency_off": {"cull_recency_scope": False},
        "no_reelect": {"reelect_descriptors": False},
        "scale_cond_on": {"kf_cull_scale_condition": True}}
    c1, c4 = ab.build_cfg(1), ab.build_cfg(4)
    assert (c1.camera.width, c1.camera.height, c1.orb.n_levels,
            c1.orb.n_features, c1.caps.n_kp) == (640, 480, 8, 1000, 1024)
    assert (c4.camera.width, c4.orb.n_levels, c4.caps.n_kp,
            c4.caps.max_points) == (160, 4, 384, 16384)


def test_last_presem_tcw_not_set_off_the_staged_objects_branch():
    """None after construction; still None after frames that take the
    fused path (objects on) and the staged path with objects off; reset()
    leaves it as it is, as the reference's reset() does."""
    from object_slam_tpu_torch.datasets.synthetic import orbit_poses
    cfg = objects_cfg(pipelined_readback=False)
    scene = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=True, device="cpu")
    assert sys_._last_presem_Tcw is None
    for i, T in enumerate(orbit_poses(2, step=0.008)):
        g, d, rgb, sem = scene.render_rgbd(T)
        sys_.track_rgbd(g, d, rgb, scene.sem_arrays(
            sem, cfg.semantic.max_instances), timestamp=i / 30.0)
        assert sys_._last_presem_Tcw is None
    marker = torch.eye(4)
    sys_._last_presem_Tcw = marker
    sys_.reset()
    assert sys_._last_presem_Tcw is marker
    off = SlamSystem(objects_cfg(fused=False, pipelined_readback=False),
                     enable_objects=False, device="cpu")
    for i, T in enumerate(orbit_poses(2, step=0.008)):
        g, d, rgb, _ = scene.render_rgbd(T)
        off.track_rgbd(g, d, rgb, None, timestamp=i / 30.0)
    assert off._last_presem_Tcw is None


def test_study_mains_run_without_the_reference(tmp_path):
    """Each of the five study scripts' main() on a tiny input, on the CPU,
    in a process where importing jax or object_slam_tpu raises."""
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()))
    seq = tmp_path / "tum"
    code = textwrap.dedent(f"""
        import builtins, json, os, sys
        real = builtins.__import__

        def guard(name, *a, **kw):
            if name == "jax" or name.startswith("jax.") or \\
                    name == "object_slam_tpu" or \\
                    name.startswith("object_slam_tpu."):
                raise ImportError("the reference is not importable: " + name)
            return real(name, *a, **kw)
        builtins.__import__ = guard
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "scripts")!r}]
        import make_synth_tum_torch
        make_synth_tum_torch.write({str(seq)!r}, frames=2)
        import ab_deviations_torch, diag_loop_torch, diag_loop_alias_torch
        import diag_semopt_torch, diag_semopt_ragged_torch
        cpu = ["--device", "cpu"]
        res = {{}}
        res["ab"] = ab_deviations_torch.main(
            ["--frames", "2", "--scale", "4", "--variants", "base"] + cpu)
        online, final, _ = diag_loop_torch.main(
            ["--frames", "2", "--scale", "4"] + cpu)
        res["loop"] = dict(online, **final)
        # the positive circuit is 2 x 120 frames: stubbed
        diag_loop_alias_torch.run_positive = lambda args, device=None: dict(
            loops_closed=0, loops_rejected=0, events=[])
        res["alias"] = diag_loop_alias_torch.main(
            ["--frames", "2", "--scale", "4",
             "--out", {str(tmp_path / "alias.json")!r}] + cpu)["alias"]
        res["semopt"] = diag_semopt_torch.main(
            ["--seq", {str(seq)!r}, "--frames", "2"] + cpu)
        res["ragged"] = diag_semopt_ragged_torch.main(
            ["--seq", {str(seq)!r}, "--frames", "1"] + cpu)
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "object_slam_tpu."))
                  or m == "object_slam_tpu"]
        print("RESULT " + json.dumps(dict(res, loaded=loaded), default=str))
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["loaded"] == []
    assert res["ab"]["base"]["frames"] == 2
    assert set(res["ab"]["base"]) == {"tracked", "frames", "ate_rmse_mm",
                                      "max_err_mm", "n_keyframes",
                                      "n_points", "wall_s"}
    assert res["loop"]["frames"] == 2 and "final_traj_ate_mm" in res["loop"]
    assert res["alias"]["frames"] == 2 and res["alias"]["tracked"] == 2
    assert res["semopt"]["n_semopt_frames"] == 1
    assert set(res["ragged"]) == {"ragged_semopt_on", "ragged_semopt_off"}
    assert res["ragged"]["ragged_semopt_on"]["frames"] == 1
