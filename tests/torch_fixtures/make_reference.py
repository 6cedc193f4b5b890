"""Write the JAX reference outputs that the PyTorch port's tests compare with.

The expensive JAX programs take minutes to compile on the CPU, so their
inputs and outputs are recorded here once and committed:

* ``slice1.npz``: the fused tracking step, keyframe insertion, the
  local-mapping pass, local BA and the 12-frame system run, objects off
  (the small verify geometry: 160x120, 300 features, 4 levels; scene
  seed 1, ``orbit_poses(12, step=0.02)``);
* ``objects.npz``: the objects-on run of the object-stability scene
  (8 frames) and one fused step with the object hooks, masks bit-packed;
* ``objects_tum_vga.npz``: the objects-on run of ``chip_smoke.py``'s 40
  TUM-VGA frames, which ``chip_smoke.py`` holds the card's run to;
* ``pipelined.npz``: the small runs with the default one-frame-lagged
  readback (slice1's orbit objects off, the object-stability scene
  objects on) and the staged path (``fused=False``), with the inputs of
  one staged semantic local-map call;
* ``kidnap.npz``: the small kidnap (a pan, dark frames, a jump back to
  the start), pipelined, objects off, with every RANSAC index set drawn;
* ``pipelined_tum_vga.npz`` and ``kidnap_tum_vga.npz``: bench.py's
  protocol on the 40 TUM-VGA frames (blobs, pipelined, objects on) and
  the VGA kidnap (blobs, objects on), for ``chip_smoke.py``;
* ``stereo.npz``: track_stereo (u8 pairs, rgb=None, objects on, the
  default fused pipelined path) on 12 frames of the small street canyon
  (street.py's 416x128 geometry), inline and async mapping, and 8 frames
  of the staged path (fused=False) async with ready() pinned to True;
* ``kitti_stereo.npz``: the same at SlamConfig.kitti_stereo() on the first
  24 frames of scripts/make_synth_kitti.py's drive, inline and async
  mapping, for ``chip_smoke.py``.
* ``mono_small.npz`` and ``mono_euroc.npz``: track_mono on
  tests/test_mono.py's 160x120 scene (8 frames) and on bench.py's room at
  the EuRoC camera (40 frames, for ``chip_smoke.py``), with every RANSAC
  draw, the initializer's inputs and winning trials; the same run with
  only the winning sets ("pinned", as the port's replay runs), 8 / 3 runs
  pinned with one-ulp noise in the initializer's pixels and every mapping
  pass's input (the reference's own spread), and, for EuRoC, the runs
  from PRNGKey(1-3) (the spread over draws);
* ``localization_small.npz``: tests/test_slam.py's 18-frame switch into
  localization mode, with one VO motion call's inputs and outputs;
  ``localization_tum_vga.npz``: chip_smoke.py's localization run (30
  frames map, 14 in the mode panning past the map and back, 8 map again);
* ``euroc_driver.npz``: scripts/run_euroc.py's stereo loop, through the
  library, on chip_smoke.py's 10-frame EuRoC directory.
* ``parallel.npz``: tests/test_parallel.py's problem
  (tests/test_solvers.py::build_ba_problem, 5 keyframes, 200 points, noise
  0.2) with the unsharded ba_iterate (5 iterations) and
  run_sharded_global_ba on a 2-device CPU mesh;
* ``batched.npz``: tests/test_batched.py's four sequences
  (make_sequence_state, seeds 0-3) through BatchedTracker.step, inputs and
  outputs;
* ``pnp_cases.npz``: jepnp.pnp_ransac on pnp_cases.correspondences (its
  sets, hypothesis scores and result; ``pnp_cases_noise`` adds every
  set's score envelope under 1024 one-ulp perturbations of the pixels);
  ``kitti_pass_noise`` adds 16
  one-ulp trials of the JAX local BA rerun on this machine to
  ``kitti_pass.npz``, ``loop_small_noise`` the closer events of four
  one-ulp noise runs of the small circuit to ``loop_small.npz``;
* the offline tools through scripts/'s own functions:
  ``experiments.npz`` and ``experiments_tiny.npz`` (run_experiments.py's
  variants on its generators' directories), ``vocab_train.npz``
  (train_vocab.py; ``vocab_counts`` adds each render's row count of the
  full harvest), ``brief.npz`` (train_brief_pattern.py's harvest, and
  its main() on brief_cases.integer_corpus with the save intercepted);
* ``studies.npz`` and ``studies_vga.npz`` (``studies``): the accuracy
  studies of scripts/ through their own functions or their loops
  verbatim: ab_deviations.py's four mapping variants (at scale 4 with
  strict readback, the state after frame 0 and the first mapping pass
  after it; at VGA on 40 frames of the circuit), diag_loop_alias.py's
  corridor at VGA (320 frames; the first pre-gated candidate's input, the
  post-gates on it with the pre-gate's absolute limits lifted, three
  pinned one-ulp noise runs over the frames chip_smoke.py replays),
  diag_loop.py's closure probe on loop_small's circuit, and
  diag_semopt.py / diag_semopt_ragged.py on the object-stability scene
  and on make_synth_tum.py's directory at tum_rgbd (24 frames);
* ``object_slam_tpu_torch/features/xla_resize.npz`` (``xla_resize``): how
  XLA:CPU computes jax.image.resize for the TUM-VGA pyramid (its weights
  and each product's summation order), which the port's pyramid executes;
* ``harvest_cpu`` (``harvest_cpu:brief`` for the second half): the port's
  two harvests on the CPU against the reference's, into vocab_train.npz
  (the rows that differ) and brief.npz (each window's hash);
* ``probes.npz`` and ``probes_vga.npz`` (``probes[:<part>]``, parts under
  build/probes/, then ``probes:merge``): the retention probes of scripts/
  (diag_poseopt, diag_retention with two dumped frames and the reference's
  replays of them, the four KITTI probes) through their loops verbatim at
  full precision, each with pinned one-ulp noise runs (level_noise and
  pinned_noise): at small_cfg and stereo_cfg's street (10 frames), and at
  TUM VGA (30 frames) and the 24-frame KITTI street (12 frames).
* ``stages.npz`` (``stages[:<part>]``, parts under build/stages/, then
  ``stages:merge``): what the stage timers of scripts/ compute, for the
  port's timers to be held to: diag_ba_profile.py's seven ba_iterate
  variants on its problem at 6 x 64 / 256 and at its own size (40 x
  2048 / 8192), diag_kitti_stages.py's eleven stages after 12 frames of
  stereo_cfg's street and of make_synth_kitti.py's drive (counts, each
  with 4 pinned one-ulp noise runs), diag_fullpipe.py's 16 frames at
  small_cfg and tum_rgbd() (flags, poses, keyframes, the bytes line, the
  profiler's spans).
* ``async_device.npz`` (``async_device[:<part>]``, parts under
  build/async_device/, then ``async_device:merge``):
  scripts/ab_async_device.py's sync and async runs through its loop
  verbatim on an 8-device CPU mesh (the async pass on the second
  device), ready() pinned to "a pass is pending", at 8, 16, 40 and 120
  frames of its 320x240 circuit, each with 4 one-ulp noise runs
  (pinned_noise: the keyframe decisions of the main run); at 120 frames
  also 4 noise runs with their own keyframe decisions (ulp_noise alone:
  ``async_device:120:free<k>``, then ``async_device:free_merge``, which
  adds them to async_device.npz as <n>.<arm>.free<k>), the spread of the
  decisions themselves;
  ``scaling.npz`` (``scaling``): scripts/bench_ba_scaling.py's problem at
  --kf 8 --pts 512 through make_sharded_ba (3 iterations) on a 4-device
  CPU mesh at sizes 1, 2 and 4, with 4 one-ulp noise runs of each.

Run from the repository root (the parts named; with no argument, the
slices' parts listed in main()):

    python tests/torch_fixtures/make_reference.py [slice1] [objects]
        [tum_vga] [pipelined] [kidnap] [pipelined_tum_vga] [kidnap_tum_vga]
        [stereo] [kitti_stereo] [mono_small] [mono_euroc]
        [localization_small] [localization_tum_vga] [euroc_driver]
        [parallel] [batched] [pnp_cases] [pnp_cases_noise]
        [kitti_pass_noise]
        [loop_small_noise[:noise<k>|:merge]] [experiments]
        [experiments_tiny] [xla_resize] [vocab] [vocab_counts] [brief]
        [harvest_cpu[:brief]] [studies[:<part>]] [probes[:<part>]]
        [stages[:<part>]] [async_device[:<part>]] [scaling]

slice1, objects and tum_vga use ``pipelined_readback=False``. The rendered
inputs' checksums are stored so that the tests can prove they re-render
the same frames.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if any(a.startswith("async_device") for a in sys.argv[1:]):
    # the async arm's second device (ab_async_device.py's 8-device mesh)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()
elif any(a.startswith("scaling") for a in sys.argv[1:]):
    # bench_ba_scaling.py's mesh sizes 1, 2 and 4
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=4").strip()
elif "parallel" in sys.argv[1:] or len(sys.argv) == 1:
    # the sharded run's 2-device mesh (before jax is imported)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..", "..")))

from object_slam_tpu.config import (CameraConfig, CapacityConfig,  # noqa: E402
                                    OrbConfig, SemanticConfig, SlamConfig,
                                    TrackingConfig)
from object_slam_tpu.datasets.synthetic import (SyntheticScene,  # noqa: E402
                                                orbit_poses)
from object_slam_tpu.eval.ate import ate_rmse  # noqa: E402
from object_slam_tpu.slam.frame import FrameData  # noqa: E402
from object_slam_tpu.slam.map_state import MapState  # noqa: E402
from object_slam_tpu.slam.system import SlamSystem  # noqa: E402
from object_slam_tpu.solvers.ba import BAProblem, local_ba  # noqa: E402
from object_slam_tpu.geometry.camera import Intrinsics  # noqa: E402
from object_slam_tpu.semantic.object2d import Object2DSlab  # noqa: E402

import street  # noqa: E402  (tests/torch_fixtures/street.py)

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "slice1.npz")
OUT_OBJECTS = os.path.join(HERE, "objects.npz")
OUT_TUM_VGA = os.path.join(HERE, "objects_tum_vga.npz")
TUM_VGA_FRAMES = 40
OBJ_FRAMES = 8
OBJ_FUSED_FRAME = 5
N_FRAMES = 12
SCENE_SEED = 1
FUSED_FRAME = 6          # which fused call to record (frame index)

FRAME_FIELDS = [f for f in FrameData._fields if f != "obj"]


def small_cfg():
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        tracking=TrackingConfig(pipelined_readback=False))


def put_map(out, prefix, m):
    for f in MapState._fields:
        out[f"{prefix}.{f}"] = np.asarray(getattr(m, f))


def put_frame(out, prefix, fr):
    for f in FRAME_FIELDS:
        out[f"{prefix}.{f}"] = np.asarray(getattr(fr, f))


def record_system(out):
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=SCENE_SEED, n_objects=2)
    poses = orbit_poses(N_FRAMES, step=0.02)
    sys_ = SlamSystem(cfg, enable_objects=False)

    captured = {"mapping": [], "fused": [], "insert": []}
    jit_mapping, jit_fused, jit_insert = (sys_._jit_mapping, sys_._jit_fused,
                                          sys_._jit_insert)

    def mapping(m, kf_id):
        res = jit_mapping(m, kf_id)
        captured["mapping"].append((m, int(kf_id), res))
        return res

    def fused(m, frame, last, velocity, last_kf_id, since, fid, kf_inl):
        res = jit_fused(m, frame, last, velocity, last_kf_id, since, fid,
                        kf_inl)
        captured["fused"].append(
            ((m, frame, last, np.asarray(velocity), int(last_kf_id),
              int(since), int(fid), int(kf_inl)), res))
        return res

    def insert(m, frame, Tcw, kp_pt, close_mask, frame_id):
        res = jit_insert(m, frame, Tcw, kp_pt, close_mask, frame_id)
        captured["insert"].append(
            ((m, frame, np.asarray(Tcw), np.asarray(kp_pt),
              np.asarray(close_mask), int(frame_id)), res))
        return res

    sys_._jit_mapping = mapping
    sys_._jit_fused = fused
    sys_._jit_insert = insert

    tcw, oks, gt, gray_sum, depth_sum, rgb_sum = [], [], [], [], [], []
    for i, T in enumerate(poses):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        depth_sum.append(float(np.sum(depth, dtype=np.float64)))
        rgb_sum.append(float(np.sum(rgb, dtype=np.float64)))
        f = sys_.track_rgbd(jnp.asarray(gray), jnp.asarray(depth),
                            jnp.asarray(rgb), None, timestamp=float(i) / 30.0)
        tcw.append(np.asarray(f.Tcw))
        oks.append(bool(f.pose_ok))
        gt.append(np.linalg.inv(T)[:3, 3])
        print(f"frame {i}: ok={oks[-1]} n_kf={int(sys_.map.n_kf)}",
              flush=True)
    tcw = np.stack(tcw).astype(np.float32)
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in tcw])
    gt = np.stack(gt)
    traj = sys_.final_trajectory()
    kf_valid = np.asarray(sys_.map.kf_valid)
    kf_frames = np.asarray(sys_.map.kf_frame_id)
    out.update({
        "system.tcw": tcw,
        "system.tracked": np.asarray(oks),
        "system.kf_frame_id": kf_frames,
        "system.kf_valid": kf_valid,
        "system.insert_frames": np.asarray(
            [c[0][5] for c in captured["insert"]], np.int32),
        "system.n_keyframes": np.int32(sys_.n_keyframes),
        "system.n_points": np.int32(sys_.n_points),
        "system.final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "system.ate": np.float64(ate_rmse(est, gt)),
        "inputs.gray_sum": np.asarray(gray_sum),
        "inputs.depth_sum": np.asarray(depth_sum),
        "inputs.rgb_sum": np.asarray(rgb_sum),
    })
    print("keyframe inserts at frames", out["system.insert_frames"],
          "mapping kf ids", [c[1] for c in captured["mapping"]],
          "ATE", out["system.ate"], flush=True)

    # the local-mapping pass: the latest one at the third keyframe or later
    maps = [c for c in captured["mapping"] if c[1] >= 2] \
        or captured["mapping"]
    m_in, kf_id, m_out = maps[-1]
    put_map(out, "mapping.m_in", m_in)
    put_map(out, "mapping.m_out", m_out)
    out["mapping.kf_id"] = np.int32(kf_id)

    # one fused tracking step
    fc = [c for c in captured["fused"] if c[0][6] == FUSED_FRAME] \
        or captured["fused"][-1:]
    (m, frame, last, vel, last_kf, since, fid, kf_inl), res = fc[0]
    put_map(out, "fused.m_in", m)
    put_frame(out, "fused.frame", frame)
    put_frame(out, "fused.last", last)
    out.update({"fused.velocity": vel, "fused.last_kf_id": np.int32(last_kf),
                "fused.frames_since_kf": np.int32(since),
                "fused.frame_id": np.int32(fid),
                "fused.last_kf_inliers": np.int32(kf_inl)})
    m2, tr2, _, packed, vel2, okd = res
    put_map(out, "fused.m_out", m2)
    out.update({"fused.packed": np.asarray(packed),
                "fused.kp_pt": np.asarray(tr2.kp_pt),
                "fused.n_inliers": np.int32(tr2.n_inliers),
                "fused.vel_out": np.asarray(vel2),
                "fused.ok": np.bool_(okd)})

    # one keyframe insertion (the last one)
    (m, frame, Tcw, kp_pt, close, fid), (m2, kf_id) = captured["insert"][-1]
    put_map(out, "insert.m_in", m)
    put_frame(out, "insert.frame", frame)
    out.update({"insert.Tcw": Tcw, "insert.kp_pt": kp_pt,
                "insert.close_mask": close, "insert.frame_id": np.int32(fid),
                "insert.kf_id": np.int32(kf_id)})
    put_map(out, "insert.m_out", m2)


def objects_cfg():
    """The object-stability scene's configuration (tests/test_slam.py
    TestObjectStability) with strict readback."""
    return small_cfg().replace(
        semantic=SemanticConfig(mask_margin=3, min_kps_rgbd=4))


def object_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=3.0)
    for k, b in enumerate(scene.boxes):
        b["size"] = 0.8
        b["center"] = np.array([(-0.75, 0.75)[k], 0.1, 2.0])
    return scene, orbit_poses(OBJ_FRAMES, step=0.008)


def put_slab(out, prefix, slab):
    """Slab fields; the masks bit-packed (np.packbits on the last axis)."""
    for f in Object2DSlab._fields:
        a = np.asarray(getattr(slab, f))
        if f == "masks":
            out[f"{prefix}.masks_packed"] = np.packbits(a, axis=-1)
        else:
            out[f"{prefix}.{f}"] = a


def record_objects(out):
    """The objects-on system run of the stability scene (8 frames) and one
    fused step with the object hooks."""
    cfg = objects_cfg()
    scene, poses = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=True)
    captured = []
    jit_fused = sys_._jit_fused

    def fused(m, frame, last, velocity, last_kf_id, since, fid, kf_inl):
        res = jit_fused(m, frame, last, velocity, last_kf_id, since, fid,
                        kf_inl)
        captured.append(((m, frame, last, np.asarray(velocity),
                          int(last_kf_id), int(since), int(fid),
                          int(kf_inl)), res))
        return res

    sys_._jit_fused = fused
    obj3d, tcw, oks, gray_sum = [], [], [], []
    for i, T in enumerate(poses):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        f = sys_.track_rgbd(jnp.asarray(gray), jnp.asarray(depth),
                            jnp.asarray(rgb), sa, i / 30.0)
        obj3d.append(np.asarray(f.obj3d))
        tcw.append(np.asarray(f.Tcw))
        oks.append(bool(f.pose_ok))
        print(f"objects frame {i}: ok={oks[-1]} obj3d={obj3d[-1][:4]} "
              f"sem={sys_.objects.semantic_constraints}", flush=True)
    traj = sys_.final_trajectory()
    m = sys_.map
    out.update({
        "system.obj3d": np.stack(obj3d), "system.tcw": np.stack(tcw),
        "system.tracked": np.asarray(oks),
        "system.obj_valid": np.asarray(m.obj_valid),
        "system.obj_label": np.asarray(m.obj_label),
        "system.obj_track_id": np.asarray(m.obj_track_id),
        "system.semantic_constraints": np.int64(
            sys_.objects.semantic_constraints),
        "system.kf_frame_id": np.asarray(m.kf_frame_id),
        "system.n_points": np.int32(sys_.n_points),
        "system.final_tcw": np.stack([t[1] for t in traj]).astype(
            np.float32),
        "inputs.gray_sum": np.asarray(gray_sum),
    })

    # one fused step whose detections engage all three object stages
    (m, frame, last, vel, last_kf, since, fid, kf_inl), res = \
        [c for c in captured if c[0][6] == OBJ_FUSED_FRAME][0]
    put_map(out, "fused.m_in", m)
    put_frame(out, "fused.frame", frame)
    put_slab(out, "fused.frame.obj", frame.obj)
    put_frame(out, "fused.last", last)
    put_slab(out, "fused.last.obj", last.obj)
    out.update({"fused.velocity": vel, "fused.last_kf_id": np.int32(last_kf),
                "fused.frames_since_kf": np.int32(since),
                "fused.frame_id": np.int32(fid),
                "fused.last_kf_inliers": np.int32(kf_inl)})
    m2, tr2, obj3d_out, packed, vel2, okd = res
    put_map(out, "fused.m_out", m2)
    out.update({"fused.packed": np.asarray(packed),
                "fused.kp_pt": np.asarray(tr2.kp_pt),
                "fused.obj3d": np.asarray(obj3d_out),
                "fused.ok": np.bool_(okd)})
    print("fused step: packed[48:58]", np.asarray(packed)[48:58], flush=True)


def record_local_ba(out):
    """local_ba in its blocked form on a small seeded problem: 4 keyframes
    15 cm apart (the first fixed), 40 points each seen by 3-4 of them, 44
    observation slots per keyframe, 3 gross outliers per keyframe."""
    rng = np.random.RandomState(5)
    cfg = small_cfg()
    K = Intrinsics.from_config(cfg.camera)
    Kk, P, Nc = 4, 40, 44
    pts = np.stack([rng.uniform(-1.0, 1.0, P), rng.uniform(-0.7, 0.7, P),
                    rng.uniform(2.0, 4.0, P)], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (Kk, 1, 1))
    for k in range(Kk):
        poses[k, 0, 3] = -0.15 * k
        poses[k, 1, 3] = 0.02 * np.sin(k)
    obs_pt = np.zeros((Kk, Nc), np.int32)
    obs_valid = np.zeros((Kk, Nc), bool)
    obs_uv = np.zeros((Kk, Nc, 2), np.float32)
    obs_ur = np.full((Kk, Nc), -1.0, np.float32)
    slot = np.full((P, Kk), -1, np.int32)
    for k in range(Kk):
        sel = rng.choice(P, Nc - 8, replace=False)
        pc = pts[sel] @ poses[k, :3, :3].T + poses[k, :3, 3]
        u = 130.0 * pc[:, 0] / pc[:, 2] + 80.0
        v = 130.0 * pc[:, 1] / pc[:, 2] + 60.0
        ur = u - 13.0 / pc[:, 2]
        noise = rng.normal(0, 0.7, (len(sel), 2)).astype(np.float32)
        noise[:3] += 25.0            # a few gross outliers to prune
        obs_pt[k, :len(sel)] = sel
        obs_valid[k, :len(sel)] = True
        obs_uv[k, :len(sel)] = np.stack([u, v], -1) + noise
        stereo = rng.uniform(size=len(sel)) < 0.7
        obs_ur[k, :len(sel)] = np.where(stereo, ur + noise[:, 0], -1.0)
        slot[sel, k] = k * Nc + np.arange(len(sel))
    # perturb the free poses and the points
    poses_in = poses.copy()
    poses_in[1:, :3, 3] += rng.normal(0, 0.01, (Kk - 1, 3)).astype(np.float32)
    pts_in = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2 * rng.randint(0, 4, (Kk, Nc)))).astype(
        np.float32)
    prob = BAProblem(
        kf_pose=jnp.asarray(poses_in),
        kf_fixed=jnp.asarray(np.arange(Kk) == 0),
        kf_valid=jnp.ones((Kk,), bool),
        pt_xyz=jnp.asarray(pts_in), pt_valid=jnp.ones((P,), bool),
        obs_kf=jnp.asarray(np.repeat(np.arange(Kk), Nc).astype(np.int32)),
        obs_pt=jnp.asarray(obs_pt.reshape(-1)),
        obs_uv=jnp.asarray(obs_uv.reshape(-1, 2)),
        obs_ur=jnp.asarray(obs_ur.reshape(-1)),
        obs_inv_sigma2=jnp.asarray(inv_s2.reshape(-1)),
        obs_valid=jnp.asarray(obs_valid.reshape(-1)))
    kf_pose, pt_xyz, keep = local_ba(K, prob, 5, 10, block_n=Nc,
                                     pt_obs_slot=jnp.asarray(slot))
    for f in BAProblem._fields:
        out[f"ba.prob.{f}"] = np.asarray(getattr(prob, f))
    out.update({"ba.block_n": np.int32(Nc), "ba.pt_obs_slot": slot,
                "ba.kf_pose": np.asarray(kf_pose),
                "ba.pt_xyz": np.asarray(pt_xyz), "ba.keep": np.asarray(keep)})


def record_tum_vga():
    """The objects-on reference for chip_smoke.py: SlamSystem on the 40
    rendered TUM-VGA frames of bench.py's scene (seed 3, 3 boxes of size
    0.9, orbit_poses(40, step=0.01)), objects on, strict readback, every
    frame passed with its detections. Writes tracked flags, keyframe
    frames, the object census, the semantic-constraint count, the ATE,
    per-frame and final poses and the inputs' checksums."""
    import time
    cfg = SlamConfig.tum_rgbd().replace(
        tracking=TrackingConfig(pipelined_readback=False))
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(TUM_VGA_FRAMES, step=0.01)
    sys_ = SlamSystem(cfg, enable_objects=True)
    t0 = time.perf_counter()
    tcw, oks, est, gt, gray_sum, n_det = [], [], [], [], [], []
    for i, T in enumerate(poses):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        gray = np.asarray(gray, np.float32)
        depth = np.asarray(depth, np.float32)
        rgb = np.asarray(rgb, np.float32)
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        n_det.append(int(np.sum(sa[4])))
        f = sys_.track_rgbd(jnp.asarray(gray), jnp.asarray(depth),
                            jnp.asarray(rgb), sa, timestamp=i / 30.0)
        Tcw = np.asarray(f.Tcw)
        tcw.append(Tcw)
        oks.append(bool(f.pose_ok))
        est.append(np.linalg.inv(Tcw)[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
        print(f"vga frame {i}: ok={oks[-1]} n_kf={int(sys_.map.n_kf)} "
              f"n_obj={int(np.sum(np.asarray(sys_.map.obj_valid)))} "
              f"sem={sys_.objects.semantic_constraints} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    seconds = time.perf_counter() - t0
    traj = sys_.final_trajectory()
    kf_valid = np.asarray(sys_.map.kf_valid)
    labels = np.asarray(sys_.map.obj_label)[np.asarray(sys_.map.obj_valid)]
    census_l, census_n = np.unique(labels, return_counts=True)
    out = {
        "tracked": np.asarray(oks),
        "kf_frames": np.asarray(sys_.map.kf_frame_id)[kf_valid],
        "census_labels": census_l.astype(np.int32),
        "census_counts": census_n.astype(np.int32),
        "semantic_constraints": np.int64(sys_.objects.semantic_constraints),
        "ate": np.float64(ate_rmse(np.array(est), np.array(gt))),
        "tcw": np.stack(tcw).astype(np.float32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "n_points": np.int32(sys_.n_points),
        "gray_sum": np.asarray(gray_sum),
        "n_detections": np.asarray(n_det, np.int32),
        "seconds": np.float64(seconds),
    }
    np.savez_compressed(OUT_TUM_VGA, **out)
    print(f"wrote {OUT_TUM_VGA}: {os.path.getsize(OUT_TUM_VGA) / 1e3:.1f} kB;"
          f" {sum(oks)}/{len(oks)} tracked, KFs at {out['kf_frames']}, census "
          f"{dict(zip(census_l.tolist(), census_n.tolist()))}, constraints "
          f"{out['semantic_constraints']}, ATE {out['ate']:.6f} m, "
          f"{seconds:.1f} s on the CPU (compiles included)", flush=True)


# ---------------------------------------------------------------------------
# the pipelined readback, the staged path and relocalization
# ---------------------------------------------------------------------------

OUT_PIPELINED = os.path.join(HERE, "pipelined.npz")
OUT_KIDNAP = os.path.join(HERE, "kidnap.npz")
OUT_PIPELINED_VGA = os.path.join(HERE, "pipelined_tum_vga.npz")
OUT_KIDNAP_VGA = os.path.join(HERE, "kidnap_tum_vga.npz")
PIPE_FRAMES = 12
STAGED_FRAMES = 8


def pan_pose(i: float, yaw_rate: float, step: float):
    """World->camera pose i of a sideways pan: the camera slides by -step
    per frame along x and turns yaw_rate rad per frame about y."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [-(i * step), 0.02 * np.sin(i * 0.3), 0.0]
    c, s = np.cos(yaw_rate * i), np.sin(yaw_rate * i)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return T


def kidnap_sequence(n_track, n_blank, n_after, yaw_rate, step):
    """A pan of n_track frames, n_blank dark frames, then a jump back to
    the start of the pan, re-run for n_after frames. Returns (poses [F, 4,
    4], blank [F] bool); a blank frame's pose is the jump target."""
    poses = [pan_pose(i, yaw_rate, step) for i in range(n_track)]
    poses += [pan_pose(0, yaw_rate, step)] * n_blank
    poses += [pan_pose(j, yaw_rate, step) for j in range(n_after)]
    blank = np.zeros(len(poses), bool)
    blank[n_track:n_track + n_blank] = True
    return np.stack(poses), blank


class Recorder:
    """Wraps a JAX SlamSystem from the outside (nothing in the package
    changes): which frames ran the staged path, every relocalization call
    with its outcome, every RANSAC index set drawn, and the inputs of every
    staged semantic local-map call."""

    def __init__(self, sys_):
        from object_slam_tpu.solvers import ransac as jransac
        self.sys = sys_
        self.staged, self.reloc, self.sets, self.semlocal = [], [], [], []
        jit_motion, relocalize = sys_._jit_motion, sys_._relocalize
        self._orig_sample = jransac.sample_minimal_sets

        def motion(*args):
            if sys_.frame_id not in self.staged:
                self.staged.append(sys_.frame_id)
            return jit_motion(*args)

        def reloc(frame):
            tr = relocalize(frame)
            self.reloc.append((float(frame.timestamp), tr is not None))
            return tr

        def sample(key, n, valid, n_trials, k):
            idx = self._orig_sample(key, n, valid, n_trials, k)
            self.sets.append(np.asarray(idx, np.int32))
            return idx

        sys_._jit_motion = motion
        sys_._relocalize = reloc
        jransac.sample_minimal_sets = sample
        if sys_.objects is not None:
            semlocal = sys_.objects.track_local_map_semantic

            def sem(m, frame, tr):
                res = semlocal(m, frame, tr)
                self.semlocal.append((m, frame, tr, res))
                return res
            sys_.objects.track_local_map_semantic = sem

    def close(self):
        from object_slam_tpu.solvers import ransac as jransac
        jransac.sample_minimal_sets = self._orig_sample


def run_pipelined(cfg, scene, poses, objects, blank=None, blob=False,
                  tag=""):
    """One JAX system run (the tracking config's readback mode) with the
    Recorder on. Frames are rendered, or dark where blank; blob=True feeds
    them as bench.py does (u16 depth, u8 rgb, one blob per frame)."""
    import time
    sys_ = SlamSystem(cfg, enable_objects=objects)
    rec = Recorder(sys_)
    H, W = cfg.camera.height, cfg.camera.width
    gray_sum, n_det = [], []
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        dark = blank is not None and blank[i]
        if dark:
            gray = depth = np.zeros((H, W), np.float32)
            rgb = np.zeros((H, W, 3), np.float32)
            sa = None
        else:
            gray, depth, rgb, sem = scene.render_rgbd(T)
            if not bench_pack:
                gray = np.asarray(gray, np.float32)
                depth = np.asarray(depth, np.float32)
                rgb = np.asarray(rgb, np.float32)
            sa = (scene.sem_arrays(sem, cfg.semantic.max_instances)
                  if objects else None)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        n_det.append(0 if sa is None else int(np.sum(sa[4])))
        if blob:
            d16 = np.clip(depth * cfg.camera.depth_map_factor, 0,
                          65535).astype(np.uint16)
            rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
            b, iv = sys_.builder.pack_frame_blob(d16, rgb8, sa)
            sys_.track_rgbd_blob(b, iv, timestamp=i / 30.0)
        else:
            sys_.track_rgbd(jnp.asarray(gray), jnp.asarray(depth),
                            jnp.asarray(rgb), sa, timestamp=i / 30.0)
        print(f"{tag} frame {i}: state={sys_.state} staged={rec.staged[-1:]}"
              f" reloc={rec.reloc[-1:]} t={time.perf_counter() - t0:.1f}s",
              flush=True)
    sys_.flush_mapping()
    seconds = time.perf_counter() - t0
    rec.close()
    traj = sys_.final_trajectory()
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    out = {
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "rec_ref": np.asarray([r.ref_kf for r in sys_.trajectory], np.int32),
        "rec_tcr": np.stack([r.Tcr for r in sys_.trajectory]).astype(
            np.float32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "gray_sum": np.asarray(gray_sum),
        "n_detections": np.asarray(n_det, np.int32),
        "staged_frames": np.asarray(rec.staged, np.int32),
        "reloc_frames": np.asarray([round(t * 30.0) for t, _ in rec.reloc],
                                   np.int32),
        "reloc_ok": np.asarray([ok for _, ok in rec.reloc], bool),
        "sets": (np.stack(rec.sets) if rec.sets
                 else np.zeros((0, 256, 6), np.int32)),
        "seconds": np.float64(seconds),
    }
    if objects:
        labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
        lab, cnt = np.unique(labels, return_counts=True)
        out.update({"census_labels": lab.astype(np.int32),
                    "census_counts": cnt.astype(np.int32),
                    "semantic_constraints": np.int64(
                        sys_.objects.semantic_constraints)})
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in out["final_tcw"]])
    ok = out["tracked"]
    out["ate"] = np.float64(ate_rmse(est[ok], gt[ok]))
    print(f"{tag}: {int(ok.sum())}/{len(ok)} tracked, KFs at "
          f"{out['kf_frames']}, staged {rec.staged}, reloc {rec.reloc}, "
          f"{len(rec.sets)} sample sets, ATE {out['ate']:.6f} m, "
          f"{seconds:.1f} s", flush=True)
    return out, rec


def put(out, prefix, d):
    out.update({f"{prefix}.{k}": v for k, v in d.items()})


def record_pipelined(out):
    """The small pipelined runs: objects off on slice1's scene (12
    frames), objects on on the object-stability scene (12 frames), and the
    staged path (fused=False, objects on, 8 frames) with the inputs and
    outputs of one staged semantic local-map call."""
    base = small_cfg().replace(tracking=TrackingConfig())
    scene = SyntheticScene.make(base, seed=SCENE_SEED, n_objects=2)
    res, _ = run_pipelined(base, scene, orbit_poses(PIPE_FRAMES, step=0.02),
                           False, tag="pipelined off")
    put(out, "off", res)

    ocfg = objects_cfg().replace(tracking=TrackingConfig())
    oscene, _ = object_scene(ocfg)
    res, _ = run_pipelined(ocfg, oscene,
                           orbit_poses(PIPE_FRAMES, step=0.008), True,
                           tag="pipelined on")
    put(out, "on", res)

    scfg = objects_cfg().replace(tracking=TrackingConfig(fused=False))
    res, rec = run_pipelined(scfg, oscene,
                             orbit_poses(STAGED_FRAMES, step=0.008), True,
                             tag="staged on")
    put(out, "staged", res)
    m, frame, tr, _ = rec.semlocal[len(rec.semlocal) // 2]
    put_map(out, "semlocal.m_in", m)
    put_frame(out, "semlocal.frame", frame)
    put_slab(out, "semlocal.frame.obj", frame.obj)
    out.update({"semlocal.tr_Tcw": np.asarray(tr.Tcw),
                "semlocal.tr_kp_pt": np.asarray(tr.kp_pt),
                "semlocal.tr_n_matches": np.int32(tr.n_matches),
                "semlocal.tr_n_inliers": np.int32(tr.n_inliers)})


# the kidnap sequences: (n_track, n_blank, n_after, yaw_rate, step)
KIDNAP_SMALL = (18, 3, 5, 0.04, 0.01)
KIDNAP_VGA = (36, 3, 10, 0.035, 0.01)


def record_kidnap(out):
    """The small kidnap: objects off, pipelined readback, on the
    object-stability scene."""
    cfg = objects_cfg().replace(tracking=TrackingConfig())
    scene, _ = object_scene(cfg)
    poses, blank = kidnap_sequence(*KIDNAP_SMALL)
    res, _ = run_pipelined(cfg, scene, poses, False, blank=blank,
                           tag="kidnap")
    check_kidnap(res)
    out.update(res)
    out.update({"poses": poses, "blank": blank})


def check_kidnap(res):
    if not res["reloc_ok"].any():
        raise SystemExit("the kidnap run never relocalized")
    if not len(res["staged_frames"]):
        raise SystemExit("no frame of the kidnap run took the staged path")


def tum_vga_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene


def record_pipelined_tum_vga():
    """chip_smoke.py's bench protocol: the 40 TUM-VGA frames of bench.py,
    packed by pack_frame_blob, objects on, the default pipelined
    readback."""
    cfg = SlamConfig.tum_rgbd()
    res, _ = run_pipelined(cfg, tum_vga_scene(cfg),
                           orbit_poses(TUM_VGA_FRAMES, step=0.01), True,
                           blob=True, tag="bench vga")
    np.savez_compressed(OUT_PIPELINED_VGA, **res)
    print(f"wrote {OUT_PIPELINED_VGA}: "
          f"{os.path.getsize(OUT_PIPELINED_VGA) / 1e3:.1f} kB", flush=True)


def record_kidnap_tum_vga():
    """chip_smoke.py's kidnap: objects on, pipelined readback, blobs, on
    bench.py's scene at TUM VGA."""
    cfg = SlamConfig.tum_rgbd()
    poses, blank = kidnap_sequence(*KIDNAP_VGA)
    res, _ = run_pipelined(cfg, tum_vga_scene(cfg), poses, True,
                           blank=blank, blob=True, tag="kidnap vga")
    check_kidnap(res)
    res.update({"poses": poses, "blank": blank})
    np.savez_compressed(OUT_KIDNAP_VGA, **res)
    print(f"wrote {OUT_KIDNAP_VGA}: "
          f"{os.path.getsize(OUT_KIDNAP_VGA) / 1e3:.1f} kB", flush=True)


# ---------------------------------------------------------------------------
# stereo: the small street canyon and KITTI at full width, sync and async
# ---------------------------------------------------------------------------

OUT_STEREO = os.path.join(HERE, "stereo.npz")
OUT_KITTI = os.path.join(HERE, "kitti_stereo.npz")
STEREO_FRAMES = 12
KITTI_FRAMES = 24
KITTI_NOISE_RUNS = 4


def stereo_cfg():
    """The small stereo geometry (street.py)."""
    from object_slam_tpu import config
    return street.stereo_cfg(config)


def street_scene(cfg, n_frames, speed=0.8, seed=5, n_objects=6):
    """scripts/make_synth_kitti.py's street canyon for an n_frames drive:
    drive_trajectory(n_frames, speed), scale 8, 24 structures, n_objects
    car boxes (label 2)."""
    from object_slam_tpu.datasets.synthetic import drive_trajectory
    poses = drive_trajectory(n_frames, speed=speed)
    centers = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    scene = SyntheticScene.make(
        cfg, seed=seed, n_objects=n_objects, plane_z=4.0, scale=8.0,
        n_structures=24, corridor_len=float(n_frames * speed + 20.0),
        path=centers)
    for b in scene.boxes:
        b["label"] = 2
    return scene, poses


_WORKER_SCENE = None


def _init_render_worker(kind, n_frames):
    global _WORKER_SCENE
    cfg = SlamConfig.kitti_stereo() if kind == "kitti" else stereo_cfg()
    _WORKER_SCENE = street_scene(cfg, n_frames)[0]


def _render_u8(T):
    """One stereo pair as the KITTI PNGs hold it (u8 gray) and the left
    view's detection lists."""
    gl, gr, _, _, sem = _WORKER_SCENE.render_stereo(T)
    return (np.clip(gl, 0, 255).astype(np.uint8),
            np.clip(gr, 0, 255).astype(np.uint8), sem)


def render_street(kind, n_frames, first=0, last=None):
    """Frames first..last-1 of the n_frames drive's stereo pairs, rendered
    by a pool of spawned workers (each builds the scene from the same
    seed)."""
    import multiprocessing as mp
    import time
    cfg = SlamConfig.kitti_stereo() if kind == "kitti" else stereo_cfg()
    scene, poses = street_scene(cfg, n_frames)
    poses = poses[first:last]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(
            min(os.cpu_count() or 1, 8), initializer=_init_render_worker,
            initargs=(kind, n_frames)) as pool:
        renders = pool.map(_render_u8, poses, chunksize=1)
    print(f"rendered {len(poses)} {kind} stereo pairs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    frames = [(gl, gr, scene.sem_arrays(sem, cfg.semantic.max_instances))
              for gl, gr, sem in renders]
    return cfg, scene, poses, frames


class AsyncRecorder:
    """Counts a JAX system's async mapping dispatches (and how many ran the
    abbreviated schedule) and its merges."""

    def __init__(self, sys_):
        self.dispatches, self.fast, self.merges = 0, 0, 0
        am = sys_._async
        if am is None:
            return
        dispatch, merge = am.dispatch, am.merge

        def disp(m, kf_id, fast=False):
            self.dispatches += 1
            self.fast += int(fast)
            return dispatch(m, kf_id, fast=fast)

        def mrg(m_now):
            self.merges += int(am.pending is not None)
            return merge(m_now)
        am.dispatch, am.merge = disp, mrg


def ulp_noise(sys_, seed):
    """Scale the map's point coordinates by (1 + u), u uniform in +-6e-8
    (at most one float32 ulp, drawn from ``seed``), at the input of every
    local-mapping pass: the JAX run under another rounding of the same
    arithmetic."""
    rng = np.random.RandomState(seed)
    for attr in ("_jit_mapping", "_jit_mapping_fast"):
        fn = getattr(sys_, attr)

        def noisy(m, kf_id, fn=fn):
            u = rng.uniform(-6e-8, 6e-8, m.pt_xyz.shape)
            xyz = (np.asarray(m.pt_xyz) * (1.0 + u)).astype(np.float32)
            return fn(m._replace(pt_xyz=jnp.asarray(xyz)), kf_id)
        setattr(sys_, attr, noisy)
    if sys_._async is not None:
        sys_._async.fn = sys_._jit_mapping
        sys_._async.fn_fast = sys_._jit_mapping_fast


def run_stereo(cfg, poses, frames, async_mapping, tag="", noise_seed=None):
    """One JAX stereo run, objects on, the default fused pipelined path,
    track_stereo(gray_l, gray_r, rgb=None, detections); flush at the end.
    With noise_seed, every mapping pass's input points carry one-ulp noise
    (ulp_noise). Returns what the port's runs are held to."""
    import time
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=async_mapping)
    if noise_seed is not None:
        ulp_noise(sys_, noise_seed)
    rec = Recorder(sys_)
    arec = AsyncRecorder(sys_)
    t0 = time.perf_counter()
    for i, (gl, gr, sa) in enumerate(frames):
        sys_.track_stereo(jnp.asarray(gl), jnp.asarray(gr), None, sa,
                          timestamp=i / 10.0)
        print(f"{tag} frame {i}: state={sys_.state} kf={sys_.last_kf_id} "
              f"staged={rec.staged[-1:]} t={time.perf_counter() - t0:.1f}s",
              flush=True)
    sys_.flush_mapping()
    seconds = time.perf_counter() - t0
    rec.close()
    traj = sys_.final_trajectory()
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
    lab, cnt = np.unique(labels, return_counts=True)
    out = {
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "staged_frames": np.asarray(rec.staged, np.int32),
        "census_labels": lab.astype(np.int32),
        "census_counts": cnt.astype(np.int32),
        "semantic_constraints": np.int64(sys_.objects.semantic_constraints),
        "dispatches": np.int32(arec.dispatches),
        "fast_dispatches": np.int32(arec.fast),
        "merges": np.int32(arec.merges),
        "seconds": np.float64(seconds),
    }
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in out["final_tcw"]])
    ok = out["tracked"]
    out["ate"] = np.float64(ate_rmse(est[ok], gt[ok]))
    print(f"{tag}: {int(ok.sum())}/{len(ok)} tracked, KFs at "
          f"{out['kf_frames']}, staged {rec.staged}, census "
          f"{dict(zip(lab.tolist(), cnt.tolist()))}, constraints "
          f"{out['semantic_constraints']}, dispatches {arec.dispatches} "
          f"({arec.fast} abbreviated), merges {arec.merges}, ATE "
          f"{out['ate']:.6f} m, {seconds:.1f} s", flush=True)
    return out


STAGED_STEREO_FRAMES = 8


def run_staged_ready(cfg, poses, frames):
    """The staged path (fused=False) with async mapping and ready() pinned
    to True whenever a pass is pending, so every staged frame that tracks
    merges the pass in flight (the reference's ready() depends on timing)."""
    from object_slam_tpu.slam import system as jsys
    ready = jsys._AsyncMapping.ready
    jsys._AsyncMapping.ready = lambda self: self.pending is not None
    try:
        return run_stereo(cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, fused=False)), poses, frames, True,
            tag="stereo staged")
    finally:
        jsys._AsyncMapping.ready = ready


def record_street(kind, n_frames, path):
    """The drive's sync and async runs, with the inputs' checksums (and,
    for the small drive, the staged run with ready() pinned)."""
    cfg, _, poses, frames = render_street(kind, n_frames)
    out = {"gray_sum": np.asarray([float(np.sum(gl, dtype=np.float64))
                                   for gl, _, _ in frames]),
           "gray_r_sum": np.asarray([float(np.sum(gr, dtype=np.float64))
                                     for _, gr, _ in frames]),
           "n_detections": np.asarray([int(np.sum(sa[4]))
                                       for _, _, sa in frames], np.int32)}
    for mode, async_mapping in (("sync", False), ("async", True)):
        put(out, mode, run_stereo(cfg, poses, frames, async_mapping,
                                  tag=f"{kind} {mode}"))
    if kind == "stereo":
        n = STAGED_STEREO_FRAMES
        put(out, "staged", run_staged_ready(cfg, poses[:n], frames[:n]))
    else:
        # the reference against itself under one-ulp noise in the mapping
        # passes' inputs: how far its keyframes, records and ATE move
        for mode, async_mapping in (("sync", False), ("async", True)):
            for k in range(KITTI_NOISE_RUNS):
                res = run_stereo(cfg, poses, frames, async_mapping,
                                 tag=f"{kind} {mode} ulp noise {k}",
                                 noise_seed=k)
                put(out, f"noise.{mode}.{k}",
                    {f: res[f] for f in ("tracked", "rec_tcw", "final_tcw",
                                         "kf_frames", "ate")})
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path) / 1e3:.1f} kB", flush=True)


OUT_KITTI_PASS = os.path.join(HERE, "kitti_pass.npz")
KITTI_PASS = 2                 # the third pass of the sync drive (keyframe 3)
KITTI_PASS_TRIALS = 4


def compact_map(m, base):
    """A MapState's numpy fields without their trailing rows that equal
    base's (the map as init_map leaves it): {field: rows}.
    interop.overlay_rows restores the full arrays from the port's
    init_map."""
    out = {}
    for f, v in m.items():
        b = base[f]
        if v.ndim == 0 or v.shape[0] != b.shape[0]:
            out[f] = v
            continue
        same = np.all((v == b).reshape(v.shape[0], -1), axis=1)
        used = np.flatnonzero(~same)
        out[f] = v[:int(used[-1]) + 1 if used.size else 0]
    return out


def record_kitti_pass():
    """One local-mapping pass of the KITTI sync drive (the pass on keyframe
    3), stage by stage in the JAX package: the pass's input map as the JAX
    run built it, then each stage's output on the previous stage's output
    (only the rows that stage changed), the abbreviated BA schedule as the
    run used it. Then the JAX local BA again KITTI_PASS_TRIALS times on
    its input with the points scaled by (1 + u), u uniform in +-6e-8 (one
    float32 ulp): how far the reference's own BA moves the keyframes."""
    from object_slam_tpu.slam import local_mapping as jlm
    from object_slam_tpu.slam import map_ops as jmo
    cfg, _, _, frames = render_street("kitti", KITTI_FRAMES, 0, 5)
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=False)
    base = {f: np.asarray(getattr(sys_.map, f)) for f in MapState._fields}
    captured = []
    for attr, fast in (("_jit_mapping", False), ("_jit_mapping_fast", True)):
        fn = getattr(sys_, attr)

        def wrap(m, kf, fn=fn, fast=fast):
            captured.append(({f: np.asarray(getattr(m, f))
                              for f in MapState._fields}, int(kf), fast))
            return fn(m, kf)
        setattr(sys_, attr, wrap)
    for i, (gl, gr, sa) in enumerate(frames):
        sys_.track_stereo(jnp.asarray(gl), jnp.asarray(gr), None, sa,
                          timestamp=i / 10.0)
        if len(captured) > KITTI_PASS:
            break
    m_in, kf, fast = captured[KITTI_PASS]
    K, sf, is2 = sys_.K, sys_.scale_factors, sys_.inv_sigma2
    J = lambda d: MapState(**{f: jnp.asarray(v) for f, v in d.items()})  # noqa: E731
    npy = lambda jm: {f: np.asarray(getattr(jm, f)) for f in MapState._fields}  # noqa: E731
    W = jlm.covisibility(J(m_in))[kf]
    kfj = jnp.int32(kf)
    it1, it2 = cfg.mapping.ba_abort_iters if fast else (5, 10)

    def stats(m):
        Kcap = m.kf_kp_pt.shape[0]
        Wn = jnp.where(m.kf_valid & (jnp.arange(Kcap) != kf), W, -1)
        nbrs = jax.lax.top_k(Wn, min(15, Kcap))[1]
        return jlm.recompute_point_stats_windowed(
            m, jnp.concatenate([kfj[None], nbrs]), cap=cfg.caps.local_pt_cap)

    def ba(m):
        return jlm.run_local_ba(
            m=m, K=K, kf_id=kfj, window=cfg.caps.local_window_kf, n_fixed=8,
            inv_sigma2_lvl=is2, iters1=it1, iters2=it2,
            pt_cap=cfg.caps.local_pt_cap, W_row=W,
            obs_cap=cfg.caps.local_obs_per_kf)
    assert cfg.mapping.reelect_descriptors
    stages = [
        ("cull_points", lambda m: jmo.cull_points(
            m, kfj, recency_scope=cfg.mapping.cull_recency_scope)),
        ("triangulate", lambda m: jmo.triangulate_new_points(
            m, kfj, n_neighbors=5, K=K, inv_sigma2_lvl=is2,
            scale_factors=sf, W_row=W)),
        ("fuse", lambda m: jmo.fuse_into_neighbors(
            m, kfj, n_neighbors=5, K=K, scale_factors=sf,
            inv_sigma2_lvl=is2, W_row=W)),
        ("point_stats", stats),
        ("local_ba", ba),
        ("cull_keyframes", lambda m: jmo.cull_keyframes(
            m, kfj, scale_condition=cfg.mapping.kf_cull_scale_condition,
            n_levels=cfg.orb.n_levels, W_row=W)),
    ]
    out = {"kf": np.int32(kf), "fast": np.bool_(fast),
           "stages": np.asarray([n for n, _ in stages])}
    for f, v in compact_map(m_in, base).items():
        out[f"in.{f}"] = v
    prev = m_in
    for name, fn in stages:
        cur = npy(fn(J(prev)))
        changed = {f: v for f, v in cur.items()
                   if not np.array_equal(v, prev[f])}
        for f, v in changed.items():
            # the rows the stage changed (interop.stage_maps reads them)
            if v.ndim == 0:
                out[f"{name}.{f}"] = v
                continue
            idx = np.flatnonzero(np.any(
                (v != prev[f]).reshape(v.shape[0], -1), axis=1))
            out[f"{name}.{f}@idx"] = idx.astype(np.int32)
            out[f"{name}.{f}@rows"] = v[idx]
        print(f"kitti pass {KITTI_PASS} (keyframe {kf}, abbreviated {fast})"
              f" {name}: changed {sorted(changed)}", flush=True)
        if name == "point_stats":
            ba_in = cur
        if name == "local_ba":
            ba_out = cur
        prev = cur
    kv = ba_out["kf_valid"]
    rng = np.random.RandomState(0)
    moves = []
    for _ in range(KITTI_PASS_TRIALS):
        d = dict(ba_in)
        d["pt_xyz"] = (ba_in["pt_xyz"] * (1.0 + rng.uniform(
            -6e-8, 6e-8, ba_in["pt_xyz"].shape))).astype(np.float32)
        t = npy(ba(J(d)))
        moves.append(float(np.max(np.linalg.norm(
            t["kf_pose"][kv][:, :3, 3] - ba_out["kf_pose"][kv][:, :3, 3],
            axis=1))))
    out["ba_ulp_kf_move"] = np.asarray(moves)
    out["ba_kf_move"] = np.float64(np.max(np.linalg.norm(
        ba_out["kf_pose"][kv][:, :3, 3] - ba_in["kf_pose"][kv][:, :3, 3],
        axis=1)))
    print(f"kitti pass: the JAX BA moves the keyframes by up to "
          f"{out['ba_kf_move'] * 1e3:.3f} mm; under one-ulp input noise it "
          f"lands {[round(x * 1e3, 3) for x in moves]} mm from itself",
          flush=True)
    np.savez_compressed(OUT_KITTI_PASS, **out)
    print(f"wrote {OUT_KITTI_PASS}: "
          f"{os.path.getsize(OUT_KITTI_PASS) / 1e3:.1f} kB", flush=True)


OUT_KITTI_OBJECTS = os.path.join(HERE, "kitti_objects.npz")
KITTI_OBJ_DRIVE = 40           # the drive whose scene is built
KITTI_OBJ_FIRST = 8            # its frames 8..39: cars pass within ThDepth


def record_kitti_objects():
    """The KITTI drive on which objects form: frames 8..39 of the 40-frame
    street canyon (two to four cars detected per frame from frame 8 to 32,
    passing within ThDepth x baseline), SlamConfig.kitti_stereo(), objects
    on, async mapping (the KITTI driver's default)."""
    cfg, _, poses, frames = render_street("kitti", KITTI_OBJ_DRIVE,
                                          KITTI_OBJ_FIRST)
    out = {"gray_sum": np.asarray([float(np.sum(gl, dtype=np.float64))
                                   for gl, _, _ in frames]),
           "n_detections": np.asarray([int(np.sum(sa[4]))
                                       for _, _, sa in frames], np.int32)}
    res = run_stereo(cfg, poses, frames, True, tag="kitti objects async")
    if not len(res["census_labels"]) or not res["semantic_constraints"]:
        raise SystemExit("kitti_objects: no object formed")
    put(out, "async", res)
    np.savez_compressed(OUT_KITTI_OBJECTS, **out)
    print(f"wrote {OUT_KITTI_OBJECTS}: "
          f"{os.path.getsize(OUT_KITTI_OBJECTS) / 1e3:.1f} kB", flush=True)


# ---------------------------------------------------------------------------
# loop closing: the VGA circuit (its closure stage by stage, the noise
# runs, loop off), the VGA kidnap through the BoW relocalization, and the
# small circuit the CPU tests replay from a captured system state
# ---------------------------------------------------------------------------

OUT_LOOP_PASS_VGA = os.path.join(HERE, "loop_pass_tum_vga.npz")
OUT_LOOP_CIRCUIT_VGA = os.path.join(HERE, "loop_circuit_tum_vga.npz")
OUT_KIDNAP_LOOP_VGA = os.path.join(HERE, "kidnap_loop_tum_vga.npz")
OUT_LOOP_SMALL = os.path.join(HERE, "loop_small.npz")
# the circuit: loop_trajectory(LOOP_FRAMES, sweep=2 pi LOOP_TURNS) in
# bench.py's room; the JAX CPU run closes exactly one loop and accepts it
LOOP_FRAMES = 120
LOOP_TURNS = 1.15
LOOP_NOISE_RUNS = 5
LOOP_PASS_TRIALS = 3
# the small circuit (scripts/diag_loop_alias.py's positive circuit, 320x240)
# and the frames before its closing keyframe the port replays
LOOP_SMALL_FRAMES = 120
LOOP_SMALL_REPLAY = 8

# the index sets every jax sampler call draws, jitted or not: (k, [T, k])
_SETS: list = []
# Sim3 index sets handed to the sampler's next k=3 draws in place of its
# own (a noise run with the unperturbed run's draws pinned)
_PIN3: list = []


def tap_sampler():
    """Record every ransac.sample_minimal_sets draw through a debug
    callback, so the draws inside jitted programs (relocalize_try's PnP)
    are recorded too. Installed before anything is traced."""
    from object_slam_tpu.solvers import ransac as jransac
    if getattr(jransac, "_tapped", False):
        return
    orig = jransac.sample_minimal_sets

    def sample(key, n, valid, n_trials, k):
        idx = orig(key, n, valid, n_trials, k)
        if k == 3 and _PIN3:
            idx = jnp.asarray(_PIN3.pop(0))
        jax.debug.callback(
            lambda x, k=k: _SETS.append((k, np.asarray(x, np.int32))), idx)
        return idx
    jransac.sample_minimal_sets = sample
    jransac._tapped = True


def loop_state(lc):
    """The closer's host state in the layout the port reads back."""
    from object_slam_tpu_torch.interop import loop_state_to_numpy
    return loop_state_to_numpy(lc)


def _noisy(m, rng):
    u = rng.uniform(-6e-8, 6e-8, m.pt_xyz.shape)
    return m._replace(pt_xyz=jnp.asarray(
        (np.asarray(m.pt_xyz) * (1.0 + u)).astype(np.float32)))


def run_loop(cfg, scene, poses, objects=True, loop=True, blob=True,
             blank=None, noise_seed=None, capture=None, on_capture=None,
             bench_pack=False, pin=None, tag=""):
    """One JAX run with loop closing: every frame as run_pipelined feeds it,
    with the frames a keyframe was inserted on, every on_keyframe call
    (keyframe, closed), the closer's events, every relocalization attempt
    (frame, candidate, inliers), the sampler's draws (Sim3 k=3, PnP k=6).
    noise_seed: one-ulp noise in every mapping pass's and closure's input
    points. capture: "closure" keeps the map and closer state at the input
    of the on_keyframe call that accepts a closure; an int keeps the whole
    system state after that frame, and what on_capture(sys_) returns.
    bench_pack: the blob is packed from the renderer's float64 depth and
    rgb, as bench.py packs it (run_pipelined and the kidnap runs cast the
    frame to float32 first, which moves ~150 depth pixels of a VGA frame
    by one u16 step). pin: (frames, sim3 sets) of another run: its
    keyframe decisions (every fused resolve inserts exactly on those
    frames) and its Sim3 draws replace this run's, as the port's replay
    does."""
    import time
    tap_sampler()
    del _SETS[:]
    del _PIN3[:]
    sys_ = SlamSystem(cfg, enable_objects=objects, enable_loop=loop)
    lc = sys_.loop_closer
    rng = np.random.RandomState(noise_seed) if noise_seed is not None \
        else None
    if rng is not None:
        ulp_noise(sys_, noise_seed)
    inserts, okf, tries, reloc, staged, held = [], [], [], [], [], {}
    cur = {"i": 0}
    jit_insert, jit_motion = sys_._jit_insert, sys_._jit_motion
    relocalize = sys_._relocalize

    def insert(m, frame, Tcw, kp_pt, spawn, fid):
        inserts.append(int(fid))
        return jit_insert(m, frame, Tcw, kp_pt, spawn, fid)

    def motion(*args):
        if sys_.frame_id not in staged:
            staged.append(sys_.frame_id)
        return jit_motion(*args)

    def reloc_fn(frame):
        tr = relocalize(frame)
        reloc.append((round(float(frame.timestamp) * 30), tr is not None))
        return tr
    sys_._jit_insert, sys_._jit_motion = insert, motion
    sys_._relocalize = reloc_fn
    if pin is not None:
        pin_frames, pin_sets = set(int(f) for f in pin[0]), pin[1]
        _PIN3.extend(np.asarray(x) for x in pin_sets)
        resolve_one = sys_._resolve_one

        def resolve(pend, latest):
            p = np.array(np.asarray(pend["packed"]))
            p[49], p[57] = 0.0, float(pend["fid"] in pin_frames)
            return resolve_one(dict(pend, packed=p), latest)
        sys_._resolve_one = resolve
    if lc is not None:
        on_kf, reloc_try = lc.on_keyframe, sys_._jit_reloc_try

        def on_keyframe(m, kf):
            if rng is not None:
                m = _noisy(m, rng)
            n_ev, state, key = len(lc.events), loop_state(lc), lc.rng
            out = on_kf(m, kf)
            okf.append((cur["i"], int(kf), bool(out[1])))
            if (capture == "closure" and "m" not in held
                    and len(lc.events) > n_ev
                    and lc.events[-1].get("accepted")):
                held.update(m=m, kf=int(kf), state=state, rng=key)
            return out

        def try_fn(m, frame, kf, key):
            tr = reloc_try(m, frame, kf, key)
            tries.append((round(float(frame.timestamp) * 30), int(kf),
                          int(tr.n_inliers)))
            return tr
        lc.on_keyframe = on_keyframe
        sys_._jit_reloc_try = try_fn
    H, W = cfg.camera.height, cfg.camera.width
    gray_sum, n_det = [], []
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        cur["i"] = i
        if blank is not None and blank[i]:
            gray = depth = np.zeros((H, W), np.float32)
            rgb = np.zeros((H, W, 3), np.float32)
            sa = None
        else:
            gray, depth, rgb, sem = scene.render_rgbd(T)
            if not bench_pack:
                gray = np.asarray(gray, np.float32)
                depth = np.asarray(depth, np.float32)
                rgb = np.asarray(rgb, np.float32)
            sa = (scene.sem_arrays(sem, cfg.semantic.max_instances)
                  if objects else None)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        n_det.append(0 if sa is None else int(np.sum(sa[4])))
        if blob:
            d16 = np.clip(depth * cfg.camera.depth_map_factor, 0,
                          65535).astype(np.uint16)
            rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
            b, iv = sys_.builder.pack_frame_blob(d16, rgb8, sa)
            sys_.track_rgbd_blob(b, iv, timestamp=i / 30.0)
        else:
            sys_.track_rgbd(jnp.asarray(gray), jnp.asarray(depth),
                            jnp.asarray(rgb), sa, timestamp=i / 30.0)
        if capture == i:
            jax.effects_barrier()
            held.update(system_state(sys_))
            held["sim3_sets_before"] = np.int32(
                sum(1 for k, _ in _SETS if k == 3))
            if on_capture is not None:
                held.update(on_capture(sys_))
        print(f"{tag} frame {i}: state={sys_.state} kf={sys_.last_kf_id} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    sys_.flush_mapping()
    jax.effects_barrier()
    seconds = time.perf_counter() - t0
    traj = sys_.final_trajectory()
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    sets3 = [s for k, s in _SETS if k == 3]
    sets6 = [s for k, s in _SETS if k == 6]
    out = {
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "insert_frames": np.asarray(inserts, np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "gray_sum": np.asarray(gray_sum),
        "n_detections": np.asarray(n_det, np.int32),
        "staged_frames": np.asarray(staged, np.int32),
        "reloc_frames": np.asarray([f for f, _ in reloc], np.int32),
        "reloc_ok": np.asarray([ok for _, ok in reloc], bool),
        "reloc_tries": np.asarray(tries, np.int32).reshape(-1, 3),
        "sim3_sets": (np.stack(sets3) if sets3
                      else np.zeros((0, 256, 3), np.int32)),
        "pnp_sets": (np.stack(sets6) if sets6
                     else np.zeros((0, 256, 6), np.int32)),
        "seconds": np.float64(seconds),
    }
    if lc is not None:
        out.update({
            "on_keyframe": np.asarray(okf, np.int32).reshape(-1, 3),
            "events": np.asarray(json.dumps(lc.events)),
            "loops_closed": np.int32(lc.n_loops_closed),
            "loops_rejected": np.int32(lc.n_loops_rejected)})
    if objects:
        labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
        lab, cnt = np.unique(labels, return_counts=True)
        out.update({"census_labels": lab.astype(np.int32),
                    "census_counts": cnt.astype(np.int32),
                    "semantic_constraints": np.int64(
                        sys_.objects.semantic_constraints)})
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in out["final_tcw"]])
    ok = out["tracked"]
    out["ate"] = np.float64(ate_rmse(est[ok], gt[ok]))
    print(f"{tag}: {int(ok.sum())}/{len(ok)} tracked, KFs inserted at "
          f"{inserts}, staged {staged}, reloc {reloc}, tries {tries}, "
          f"{len(sets3)} Sim3 / {len(sets6)} PnP draws, events "
          f"{lc.events if lc is not None else None}, ATE "
          f"{out['ate']:.6f} m, {seconds:.1f} s", flush=True)
    return out, sys_, held


def system_state(sys_):
    """A JAX system's whole state after a frame (strict readback, sync
    mapping, objects off): the map, the last frame, the tracker's counters,
    the records so far and the closer's host state."""
    assert sys_._fused_pending is None and sys_._async is None
    fr = sys_.last_frame
    st = {f"m.{k}": v for k, v in compact_map(
        {f: np.asarray(getattr(sys_.map, f)) for f in MapState._fields},
        {f: np.asarray(getattr(init_loop_map(sys_), f))
         for f in MapState._fields}).items()}
    st.update({f"last.{f}": np.asarray(getattr(fr, f)) for f in FRAME_FIELDS})
    st.update({f"loop.{k}": v for k, v in loop_state(
        sys_.loop_closer).items()})
    st.update({
        "velocity": np.asarray(sys_.velocity, np.float32),
        "counters": np.asarray([sys_.state, sys_.last_kf_id,
                                sys_.frames_since_kf, sys_.frame_id,
                                getattr(sys_, "_kf_inliers", 0),
                                getattr(sys_, "_last_n_inliers", -1)],
                               np.int64),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "rec_ref": np.asarray([r.ref_kf for r in sys_.trajectory], np.int32),
        "rec_tcr": np.stack([r.Tcr for r in sys_.trajectory]).astype(
            np.float32),
        "rec_tracked": np.asarray([r.tracked for r in sys_.trajectory])})
    return st


def init_loop_map(sys_):
    from object_slam_tpu.slam.map_state import init_map
    return init_map(sys_.cfg.caps, sys_.cfg.objects.history_capacity,
                    n_bow_words=sys_.loop_closer.vocab.n_words)


def loop_scene(cfg):
    """bench.py's room (seed 3, three boxes of 0.9)."""
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3, plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene


def loop_poses(frames=LOOP_FRAMES, turns=LOOP_TURNS):
    from object_slam_tpu.datasets.synthetic import loop_trajectory
    return np.stack(loop_trajectory(frames, sweep=2 * np.pi * turns))


def check_one_closure(res, tag):
    ev = json.loads(str(res["events"]))
    acc = [e for e in ev if e.get("accepted")]
    if len(ev) != 1 or len(acc) != 1:
        raise SystemExit(f"{tag}: events {ev}; the circuit must close "
                         "exactly one loop and accept it")


def _rows(out, name, prev, cur):
    """The rows of each field stage ``name`` changed (interop.stage_maps
    reads them); returns the changed fields."""
    changed = []
    for f, v in cur.items():
        if np.array_equal(v, prev[f]):
            continue
        changed.append(f)
        if v.ndim == 0:
            out[f"{name}.{f}"] = v
            continue
        idx = np.flatnonzero(np.any(
            (v != prev[f]).reshape(v.shape[0], -1), axis=1))
        out[f"{name}.{f}@idx"] = idx.astype(np.int32)
        out[f"{name}.{f}@rows"] = v[idx]
    return changed


LOOP_STAGES = ("bow", "propagate", "fuse", "pose_graph", "gba")


@jax.jit
def _match_idx(m, q, l):
    """The match index of LoopCloser._match_pairs_impl's brute match."""
    from object_slam_tpu.features import matching as jmatch
    P = m.pt_xyz.shape[0]
    okq = m.kf_kp_valid[q] & (m.kf_kp_pt[q] >= 0) \
        & m.pt_valid[jnp.clip(m.kf_kp_pt[q], 0, P - 1)]
    okl = m.kf_kp_valid[l] & (m.kf_kp_pt[l] >= 0) \
        & m.pt_valid[jnp.clip(m.kf_kp_pt[l], 0, P - 1)]
    midx, _ = jmatch.brute_match(
        m.kf_kp_desc[q], okq, m.kf_kp_desc[l], okl, th_dist=50,
        nn_ratio=0.75, angle_a=m.kf_kp_angle[q], angle_b=m.kf_kp_angle[l])
    return midx


def record_loop_pass(sys_, held):
    """The accepted closure of the circuit stage by stage: on_keyframe run
    again on the map and closer state it had as input (the same programs
    on the same input give the same closure), with every stage's input and
    output kept: the BoW row and its words, the candidates, the groups,
    the match pairs, the Sim3 draw and RANSAC winner, the Gauss-Newton
    result, the guided count, the gate numbers and q before / after, and
    the maps after bow, propagate, fuse, pose graph and GBA (only the rows
    each changed). Then the GBA again LOOP_PASS_TRIALS times on its input
    with the points scaled by (1 + u), u uniform in +-6e-8: how far the
    reference's own GBA moves the keyframes."""
    from object_slam_tpu.loop import loop_closing as jlc
    lc = sys_.loop_closer
    m_in, q = held["m"], held["kf"]
    st = held["state"]
    members = st["group_members"].tolist()
    groups, at = [], 0
    for size, cnt in zip(st["group_sizes"].tolist(),
                         st["group_counts"].tolist()):
        groups.append((set(members[at:at + size]), int(cnt)))
        at += size
    lc.consistent_groups, lc.last_loop_kf = groups, int(st["last_loop_kf"])
    lc._cooldown, lc.rng = int(st["cooldown"]), held["rng"]
    n_ev = len(lc.events)
    rec = {}
    npy = lambda jm: {f: np.asarray(getattr(jm, f)) for f in MapState._fields}  # noqa: E731

    def wrap(attr, name, keep):
        fn = getattr(lc, attr)

        def run(*a):
            r = fn(*a)
            rec.setdefault(name, []).append(keep(a, r))
            return r
        setattr(lc, attr, run)
    wrap("_jit_bow", "bow", lambda a, r: npy(r))
    wrap("_jit_detect", "detect", lambda a, r: (np.asarray(r[0]),
                                                np.asarray(r[1])))
    wrap("_jit_match_pairs", "match", lambda a, r: (
        int(a[2]), [np.asarray(x) for x in r]))
    wrap("_jit_sim3_gn", "gn", lambda a, r: [np.asarray(x) for x in r])
    wrap("_guided_matches", "guided", lambda a, r: int(r))
    wrap("_jit_quality", "quality", lambda a, r: float(r))
    wrap("_jit_propagate", "propagate", lambda a, r: (
        npy(r[0]), np.asarray(r[1]), np.asarray(r[3])))
    wrap("_jit_fuse", "fuse", lambda a, r: npy(r))
    wrap("_jit_pose_graph", "pose_graph", lambda a, r: npy(r))
    wrap("_jit_gba", "gba", lambda a, r: npy(r))
    ransac_fn = jlc.sim3_solver.sim3_ransac

    def ransac(*a, **kw):
        r = ransac_fn(*a, **kw)
        rec.setdefault("ransac", []).append(
            [np.asarray(x) for x in (r.T12, r.s12, r.inliers, r.n_inliers,
                                     r.ok)])
        return r
    jlc.sim3_solver.sim3_ransac = ransac
    del _SETS[:]
    try:
        m_out, closed = lc.on_keyframe(m_in, q)
    finally:
        jlc.sim3_solver.sim3_ransac = ransac_fn
    jax.effects_barrier()
    if not closed:
        raise SystemExit("loop pass: the closure did not repeat")
    ev = lc.events[n_ev:]
    base = npy(init_loop_map(sys_))
    m_np = npy(m_in)
    out = {"q": np.int32(q), "events": np.asarray(json.dumps(ev)),
           "stages": np.asarray(LOOP_STAGES)}
    for k, v in held["state"].items():
        out[f"state_in.{k}"] = v
    for k, v in loop_state(lc).items():
        out[f"state_out.{k}"] = v
    for f, v in compact_map(m_np, base).items():
        out[f"in.{f}"] = v
    word, bow = lc.vocab.transform(m_in.kf_kp_desc[q], m_in.kf_kp_valid[q])
    out["bow_word"], out["bow_row"] = np.asarray(word), np.asarray(bow)
    cand, W = rec["detect"][0]
    out["cand"] = cand
    # every Sim3 attempt of the call: its candidate, matches, draw, RANSAC
    # and (when it got there) Gauss-Newton and guided count
    out["attempt_l"] = np.asarray([l for l, _ in rec["match"]], np.int32)
    for i, (l, (pc_q, pc_l, mok)) in enumerate(rec["match"]):
        out[f"match{i}.pc_q"], out[f"match{i}.pc_l"] = pc_q, pc_l
        out[f"match{i}.ok"] = mok
        out[f"match{i}.idx"] = np.asarray(_match_idx(m_in, q, l))
    sets3 = [s for k, s in _SETS if k == 3]
    out["sim3_sets"] = (np.stack(sets3) if sets3
                        else np.zeros((0, 256, 3), np.int32))
    for i, r in enumerate(rec.get("ransac", [])):
        for n, v in zip(("T12", "s12", "inliers", "n_inliers", "ok"), r):
            out[f"ransac{i}.{n}"] = v
    for i, r in enumerate(rec.get("gn", [])):
        for n, v in zip(("T12", "s12", "inliers", "n_inliers"), r):
            out[f"gn{i}.{n}"] = v
    out["guided"] = np.asarray(rec.get("guided", []), np.int32)
    out["quality"] = np.asarray(rec["quality"])
    prop, T_old, s_init = rec["propagate"][0]
    out["propagate.T_old"], out["propagate.s_init"] = T_old, s_init
    stage_out = {"bow": rec["bow"][0], "propagate": prop,
                 "fuse": rec["fuse"][0], "pose_graph": rec["pose_graph"][0],
                 "gba": rec["gba"][0]}
    prev = m_np
    for name in LOOP_STAGES:
        changed = _rows(out, name, prev, stage_out[name])
        print(f"loop pass (q={q}) {name}: changed {sorted(changed)}",
              flush=True)
        prev = stage_out[name]
    if not all(np.array_equal(npy(m_out)[f], prev[f])
               for f in ("kf_pose", "pt_xyz", "kf_kp_pt")):
        raise SystemExit("loop pass: the stages do not chain to the output")
    # the GBA's own spread under one-ulp noise in its input points
    pg = stage_out["pose_graph"]
    gba_ref = stage_out["gba"]
    kv = gba_ref["kf_valid"]
    rng = np.random.RandomState(0)
    moves = []
    J = lambda d: MapState(**{f: jnp.asarray(v) for f, v in d.items()})  # noqa: E731
    for _ in range(LOOP_PASS_TRIALS):
        d = dict(pg)
        d["pt_xyz"] = (pg["pt_xyz"] * (1.0 + rng.uniform(
            -6e-8, 6e-8, pg["pt_xyz"].shape))).astype(np.float32)
        t = npy(lc._jit_gba(J(d)))
        moves.append(float(np.max(np.linalg.norm(
            t["kf_pose"][kv][:, :3, 3] - gba_ref["kf_pose"][kv][:, :3, 3],
            axis=1))))
    out["gba_ulp_kf_move"] = np.asarray(moves)
    out["gba_kf_move"] = np.float64(np.max(np.linalg.norm(
        gba_ref["kf_pose"][kv][:, :3, 3] - pg["kf_pose"][kv][:, :3, 3],
        axis=1)))
    print(f"loop pass: events {ev}; the GBA moves the keyframes by up to "
          f"{out['gba_kf_move'] * 1e3:.3f} mm; under one-ulp input noise it "
          f"lands {[round(x * 1e3, 4) for x in moves]} mm from itself",
          flush=True)
    np.savez_compressed(OUT_LOOP_PASS_VGA, **out)
    print(f"wrote {OUT_LOOP_PASS_VGA}: "
          f"{os.path.getsize(OUT_LOOP_PASS_VGA) / 1e3:.1f} kB", flush=True)


_CIRCUIT_KEEP = ("tracked", "rec_tcw", "final_tcw", "kf_frames",
                 "insert_frames", "on_keyframe", "events", "ate")


def record_loop_circuit(part):
    """part "main": the circuit with loop closing (its accepted closure
    recorded stage by stage into loop_pass_tum_vga.npz); "off": loop
    closing off; "noise<k>": the loop-on run under one-ulp noise (seed k);
    "pin<k>": the same with main's keyframe decisions and Sim3 draws
    pinned. Each part writes build/loop_circuit/<part>.npz; part "merge"
    gathers them into loop_circuit_tum_vga.npz."""
    cfg = SlamConfig.tum_rgbd()
    parts_dir = os.path.join(HERE, "..", "..", "build", "loop_circuit")
    os.makedirs(parts_dir, exist_ok=True)
    if part == "merge":
        return merge_loop_circuit(parts_dir)
    scene, poses = loop_scene(cfg), loop_poses()
    if part == "main":
        res, sys_, held = run_loop(cfg, scene, poses, capture="closure",
                                   bench_pack=True, tag="loop circuit")
        check_one_closure(res, "loop circuit")
        record_loop_pass(sys_, held)
    elif part == "off":
        res, _, _ = run_loop(cfg, scene, poses, loop=False, bench_pack=True,
                             tag="loop circuit, loop off")
    elif part.startswith("pin"):
        # one-ulp noise with the unperturbed run's keyframe decisions and
        # Sim3 draws pinned: the condition the port's replay runs under
        k = int(part[len("pin"):])
        main = np.load(os.path.join(parts_dir, "main.npz"))
        res, _, _ = run_loop(cfg, scene, poses, noise_seed=k,
                             bench_pack=True,
                             pin=(main["insert_frames"], main["sim3_sets"]),
                             tag=f"loop circuit pinned ulp noise {k}")
    else:
        k = int(part[len("noise"):])
        res, _, _ = run_loop(cfg, scene, poses, noise_seed=k,
                             bench_pack=True,
                             tag=f"loop circuit ulp noise {k}")
    res["poses"] = poses
    np.savez_compressed(os.path.join(parts_dir, f"{part}.npz"), **res)


def merge_loop_circuit(parts_dir):
    """main + off + the noise runs -> loop_circuit_tum_vga.npz. The bands
    come from the pinned noise runs (pin<k>: the unperturbed run's
    keyframe decisions and Sim3 draws, as the port's replay) that kept its
    flags, keyframes and closure; the free noise runs (noise<k>) are kept
    as the closures and ATEs the JAX package reaches on its own decisions
    under one-ulp noise."""
    main = dict(np.load(os.path.join(parts_dir, "main.npz")))
    off = np.load(os.path.join(parts_dir, "off.npz"))
    out = dict(main)
    for f in ("ate", "tracked", "kf_frames", "insert_frames"):
        out[f"off.{f}"] = off[f]

    def closure(d):
        return [(e["q"], e["l"], e["accepted"])
                for e in json.loads(str(d["events"]))]
    kept, free = 0, []
    for k in range(LOOP_NOISE_RUNS):
        for kind in ("pin", "noise"):
            p = os.path.join(parts_dir, f"{kind}{k}.npz")
            if not os.path.exists(p):
                continue
            n = np.load(p)
            same = (np.array_equal(n["tracked"], main["tracked"])
                    and np.array_equal(n["insert_frames"],
                                       main["insert_frames"])
                    and closure(n) == closure(main))
            print(f"{kind} run {k}: flags, keyframes and closure "
                  f"{'kept' if same else 'changed'}; closure "
                  f"{closure(n)}, ATE {float(n['ate']):.6f}", flush=True)
            if kind == "pin" and same:
                for f in ("rec_tcw", "final_tcw", "ate"):
                    out[f"noise.{kept}.{f}"] = n[f]
                kept += 1
            if kind == "noise":
                free.append((closure(n), float(n["ate"])))
    out["n_noise"] = np.int32(kept)
    out["free_noise"] = np.asarray(json.dumps(free))
    if kept < 3:
        raise SystemExit(f"only {kept} pinned noise runs kept the "
                         "reference's decisions")
    np.savez_compressed(OUT_LOOP_CIRCUIT_VGA, **out)
    print(f"wrote {OUT_LOOP_CIRCUIT_VGA}: "
          f"{os.path.getsize(OUT_LOOP_CIRCUIT_VGA) / 1e3:.1f} kB; loop-off "
          f"ATE {float(off['ate']):.6f} m, loop-on "
          f"{float(main['ate']):.6f} m; free noise runs {free}", flush=True)


def record_kidnap_loop_tum_vga():
    """The VGA kidnap of kidnap_tum_vga with loop closing on: the LOST
    frames relocalize through the BoW candidates, one relocalize_try each
    (the attempts and their PnP draws recorded)."""
    cfg = SlamConfig.tum_rgbd()
    poses, blank = kidnap_sequence(*KIDNAP_VGA)
    res, _, _ = run_loop(cfg, tum_vga_scene(cfg), poses, blank=blank,
                         tag="kidnap loop vga")
    check_kidnap(res)
    if not len(res["reloc_tries"]):
        raise SystemExit("kidnap loop: no BoW relocalization attempt")
    res.update({"poses": poses, "blank": blank})
    np.savez_compressed(OUT_KIDNAP_LOOP_VGA, **res)
    print(f"wrote {OUT_KIDNAP_LOOP_VGA}: "
          f"{os.path.getsize(OUT_KIDNAP_LOOP_VGA) / 1e3:.1f} kB", flush=True)


def loop_small_cfg():
    """scripts/diag_loop_alias.py's positive circuit geometry (the TUM
    camera at half size, 320x240; ab_deviations.build_cfg(2)), strict
    readback."""
    return SlamConfig(
        camera=CameraConfig(width=320, height=240, fx=520.9 / 2,
                            fy=521.0 / 2, cx=325.1 / 2, cy=249.7 / 2,
                            dist=(0, 0, 0, 0, 0), bf=20.0, th_depth=40.0,
                            depth_map_factor=1.0),
        orb=OrbConfig(n_features=500, n_levels=4),
        caps=CapacityConfig(n_kp=512, max_points=16384, max_keyframes=256),
        tracking=TrackingConfig(pipelined_readback=False))


def record_loop_small():
    """The small circuit (objects off, strict readback, sync): the JAX run
    that closes one loop, with the whole system state LOOP_SMALL_REPLAY
    frames before the frame whose keyframe closes it (the port starts
    there), and the BoW relocalization of frame 2's view against the map
    of that state (its attempts and their PnP draws)."""
    cfg = loop_small_cfg()
    scene = loop_scene(cfg)
    poses = loop_poses(LOOP_SMALL_FRAMES)
    res, _, _ = run_loop(cfg, scene, poses, objects=False, blob=False,
                         tag="loop small (probe)")
    check_one_closure(res, "loop small")
    okf = res["on_keyframe"]
    close_frame = int(okf[okf[:, 2] == 1][0, 0])
    start = close_frame - LOOP_SMALL_REPLAY
    g, d, rgb, _ = scene.render_rgbd(poses[2])

    def relocalize(sys_):
        """SlamSystem._relocalize's BoW branch on the captured system (it
        only reads the map and draws from the system's key)."""
        frame = sys_.builder.build_rgbd(
            jnp.asarray(np.asarray(g, np.float32)),
            jnp.asarray(np.asarray(d, np.float32)),
            jnp.asarray(np.asarray(rgb, np.float32)), None, 0.0)
        n0 = len(_SETS)
        tries, out = [], {}
        reloc_try = sys_._jit_reloc_try

        def try_fn(m, fr, kf, key):
            tr = reloc_try(m, fr, kf, key)
            i = len(tries)
            tries.append((int(kf), int(tr.n_inliers)))
            out.update({f"reloc.try{i}.Tcw": np.asarray(tr.Tcw),
                        f"reloc.try{i}.kp_pt": np.asarray(tr.kp_pt)})
            return tr
        sys_._jit_reloc_try = try_fn
        rng = sys_.rng
        tr = SlamSystem._relocalize(sys_, frame)
        sys_._jit_reloc_try, sys_.rng = reloc_try, rng
        jax.effects_barrier()
        out.update({f"reloc.frame.{f}": np.asarray(getattr(frame, f))
                    for f in FRAME_FIELDS})
        out["reloc.tries"] = np.asarray(tries, np.int32).reshape(-1, 2)
        out["reloc.sets"] = np.stack([s for k, s in _SETS[n0:] if k == 6])
        del _SETS[n0:]
        out["reloc.ok"] = np.bool_(tr is not None)
        print(f"loop small: relocalization tries {tries}, accepted "
              f"{tr is not None}", flush=True)
        return out
    res, sys_, held = run_loop(cfg, scene, poses, objects=False, blob=False,
                               capture=start, on_capture=relocalize,
                               tag="loop small")
    out = dict(res)
    out.update({f"state.{k}": v for k, v in held.items()
                if not k.startswith("reloc.")})
    out.update({k: v for k, v in held.items() if k.startswith("reloc.")})
    out["start"] = np.int32(start)
    out["close_frame"] = np.int32(close_frame)
    out["poses"] = poses
    print(f"loop small: closure frame {close_frame}, replay from {start}",
          flush=True)
    np.savez_compressed(OUT_LOOP_SMALL, **out)
    print(f"wrote {OUT_LOOP_SMALL}: "
          f"{os.path.getsize(OUT_LOOP_SMALL) / 1e3:.1f} kB", flush=True)


# ---------------------------------------------------------------------------
# mono (the two-view initializer), localization mode, the EuRoC driver
# ---------------------------------------------------------------------------

OUT_MONO_SMALL = os.path.join(HERE, "mono_small.npz")
OUT_MONO_EUROC = os.path.join(HERE, "mono_euroc.npz")
OUT_LOC_SMALL = os.path.join(HERE, "localization_small.npz")
OUT_LOC_VGA = os.path.join(HERE, "localization_tum_vga.npz")
OUT_EUROC_DRIVER = os.path.join(HERE, "euroc_driver.npz")
MONO_SMALL_FRAMES = 8
MONO_EUROC_FRAMES = 40
MONO_EUROC_STEP = 0.03
MONO_NOISE_RUNS = 3
LOC_SMALL_FRAMES = 18
LOC_SMALL_SWITCH = 9
# localization at TUM VGA: frames that map, frames in localization mode (a
# pan past the mapped region), frames after deactivation
LOC_VGA = (30, 14, 8)
LOC_VGA_YAW = 0.09             # rad per frame of the pan
LOC_VGA_OUT = 8                # frames of the pan away
EUROC_DRIVER_FRAMES = 10
EUROC_DRIVER_STEP = 0.03


def mono_small_cfg():
    """tests/test_mono.py's 160x120 mono system."""
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        sensor="mono",
        tracking=TrackingConfig(min_init_matches=40, min_init_inliers=25))


def mono_small_scene(cfg):
    """tests/test_mono.py's scene: boxes at spread depths."""
    scene = SyntheticScene.make(cfg, seed=5, n_objects=3, plane_z=7.0)
    rngs = np.random.RandomState(9)
    for b in scene.boxes:
        b['size'] = 1.2
        b['center'] = np.array([rngs.uniform(-1.5, 1.5),
                                rngs.uniform(-1.0, 1.0),
                                rngs.uniform(2.5, 5.0)])
    return scene


def euroc_cfg(sensor):
    """scripts/run_euroc.py's configuration (the camera block of the
    settings YAML equals SlamConfig.euroc_stereo()'s)."""
    return SlamConfig.euroc_stereo().replace(sensor=sensor)


def sim3_ate(est, gt):
    """RMSE after the least-squares similarity alignment of est onto gt
    (Umeyama), [N, 3] each: the ATE of a trajectory whose scale is free."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    me, mg = est.mean(0), gt.mean(0)
    e, g = est - me, gt - mg
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max(np.mean(np.sum(e * e, 1)), 1e-30)
    aligned = s * e @ R.T + mg
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, 1))))


def split_sets(sets):
    """The sampler's draws in order -> {"sets_k": k per draw, "sets<k>":
    the draws of size k stacked}."""
    out = {"sets_k": np.asarray([s.shape[1] for s in sets], np.int32)}
    for k in (4, 6, 8):
        got = [s for s in sets if s.shape[1] == k]
        out[f"sets{k}"] = (np.stack(got) if got
                           else np.zeros((0, 0, k), np.int32))
    return out


def init_winners(uv1, uv2, valid, idxF, idxH, sigma=1.0):
    """The trials initialize_mono's argmaxes pick among the index sets
    (its F and H scores, recomputed by the same JAX functions)."""
    from object_slam_tpu.solvers import initializer as jinit
    from object_slam_tpu.solvers import ransac as jransac
    uv1, uv2, valid = (jnp.asarray(x) for x in (uv1, uv2, valid))
    F = jransac.eight_point_fundamental(uv1[idxF], uv2[idxF])
    dF = jransac.sampson_epipolar_chi2(F, uv1, uv2)
    thF = 3.841 * sigma * sigma * 2
    sF = jnp.sum(jnp.where((dF < thF) & valid[None], thF - dF, 0.0), axis=1)
    H = jinit.homography_4pt(uv1[idxH], uv2[idxH])
    dH = jinit.homography_transfer_chi2(H, uv1, uv2)
    thH = 5.991 * sigma * sigma * 2
    sH = jnp.sum(jnp.where((dH < thH) & valid[None], thH - dH, 0.0), axis=1)
    return int(jnp.argmax(sF)), int(jnp.argmax(sH))


def run_mono(cfg, scene, poses, fps, tag, noise_seed=None, keep_init=True,
             pins=None, rng_seed=None):
    """One JAX mono run (objects off, the default fused pipelined path,
    track_mono of the f32 gray render) with every RANSAC draw and every
    initializer attempt recorded (its winning F and H trials too); flush
    at the end. With noise_seed, one-ulp noise in every mapping pass's
    input points and in every initializer attempt's matched pixels; with
    pins (a list of (F set, H set) per attempt), the attempts draw those
    sets instead of their own; with rng_seed, the system's sampler starts
    from PRNGKey(rng_seed) instead of PRNGKey(0)."""
    import time
    from object_slam_tpu.solvers import initializer as jinit
    from object_slam_tpu.solvers import ransac as jransac
    sys_ = SlamSystem(cfg, enable_objects=False)
    if rng_seed is not None:
        sys_.rng = jax.random.PRNGKey(rng_seed)
    rng = None
    if noise_seed is not None:
        ulp_noise(sys_, noise_seed)
        rng = np.random.RandomState(1000 + noise_seed)
    rec = Recorder(sys_)
    attempts = []
    orig_init = jinit.initialize_mono
    pins = list(pins or [])

    def init_rec(key, K, uv1, uv2, valid, **kw):
        if rng is not None:
            uv1, uv2 = (jnp.asarray((np.asarray(u) * (1.0 + rng.uniform(
                -6e-8, 6e-8, u.shape))).astype(np.float32))
                for u in (uv1, uv2))
        n0 = len(rec.sets)
        sample = jransac.sample_minimal_sets
        if pins:
            it = iter(pins.pop(0))
            jransac.sample_minimal_sets = \
                lambda *a, **k: jnp.asarray(next(it))
        try:
            res = orig_init(key, K, uv1, uv2, valid, **kw)
        finally:
            jransac.sample_minimal_sets = sample
        a = {"frame": sys_.frame_id, "uv1": np.asarray(uv1),
             "uv2": np.asarray(uv2), "valid": np.asarray(valid),
             "ok": bool(res.ok), "T21": np.asarray(res.T21),
             "good": np.asarray(res.good), "pw": np.asarray(res.pw)}
        if len(rec.sets) >= n0 + 2:
            a["idxF"], a["idxH"] = rec.sets[n0], rec.sets[n0 + 1]
            a["bestF"], a["bestH"] = init_winners(
                uv1, uv2, valid, a["idxF"], a["idxH"])
        attempts.append(a)
        return res
    jinit.initialize_mono = init_rec
    gray_sum = []
    t0 = time.perf_counter()
    try:
        for i, T in enumerate(poses):
            gray = np.asarray(scene.render_rgbd(T)[0], np.float32)
            gray_sum.append(float(np.sum(gray, dtype=np.float64)))
            sys_.track_mono(jnp.asarray(gray), timestamp=i / fps)
            print(f"{tag} frame {i}: state={sys_.state} "
                  f"kf={sys_.last_kf_id} t={time.perf_counter() - t0:.1f}s",
                  flush=True)
        sys_.flush_mapping()
    finally:
        jinit.initialize_mono = orig_init
        rec.close()
    seconds = time.perf_counter() - t0
    traj = sys_.final_trajectory()
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    out = {
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "rec_ref": np.asarray([r.ref_kf for r in sys_.trajectory], np.int32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "gray_sum": np.asarray(gray_sum),
        "staged_frames": np.asarray(rec.staged, np.int32),
        "reloc_frames": np.asarray([round(t * fps) for t, _ in rec.reloc],
                                   np.int32),
        "attempt_frames": np.asarray([a["frame"] for a in attempts],
                                     np.int32),
        "attempt_ok": np.asarray([a["ok"] for a in attempts], bool),
        "attempt_T21": np.asarray([a["T21"] for a in attempts], np.float32
                                  ).reshape(-1, 4, 4),
        "seconds": np.float64(seconds),
    }
    if all("bestF" in a for a in attempts):
        out["attempt_bestF"] = np.asarray([a["bestF"] for a in attempts],
                                          np.int32)
        out["attempt_bestH"] = np.asarray([a["bestH"] for a in attempts],
                                          np.int32)
    out.update(split_sets(rec.sets))
    ok = out["tracked"]
    out["init_frame"] = np.int32(int(np.argmax(ok)) if ok.any() else -1)
    wins = [a for a in attempts if a["ok"]]
    if keep_init and wins:
        out.update({f"init.{k}": np.asarray(v) for k, v in wins[0].items()})
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in out["final_tcw"]])
    out["ate_sim3"] = np.float64(sim3_ate(est[ok], gt[ok]) if ok.sum() > 2
                                 else np.nan)
    print(f"{tag}: {int(ok.sum())}/{len(ok)} tracked from frame "
          f"{out['init_frame']}, attempts {out['attempt_frames']} ok "
          f"{out['attempt_ok']} winners {out.get('attempt_bestF')} "
          f"{out.get('attempt_bestH')}, KFs at {out['kf_frames']}, staged "
          f"{rec.staged}, reloc {rec.reloc}, {out['n_points']} points, "
          f"Sim(3) ATE {out['ate_sim3']:.6f}, {seconds:.1f} s", flush=True)
    return out


MONO_RUNS = {
    # kind: (fixture, frames, orbit step, the configuration, the scene,
    # noise runs)
    "small": (OUT_MONO_SMALL, MONO_SMALL_FRAMES, 0.06,
              lambda: mono_small_cfg(), mono_small_scene, 8),
    "euroc": (OUT_MONO_EUROC, MONO_EUROC_FRAMES, MONO_EUROC_STEP,
              lambda: euroc_cfg("mono"), tum_vga_scene, MONO_NOISE_RUNS),
}


def record_mono(kind, part):
    """A mono drive the port is held to: "small" is test_mono.py's 160x120
    run (orbit_poses(8, step=0.06)) for the CPU tests, "euroc" bench.py's
    room at the EuRoC camera (orbit_poses(MONO_EUROC_FRAMES,
    step=MONO_EUROC_STEP)) for chip_smoke.py; track_mono of the f32 gray
    render. part "main" (with the initializer's inputs and winning
    trials), "pinned" (each initializer attempt handed only the main run's
    winning sets, as the port's replay hands them), "noise<k>" (pinned,
    plus one-ulp noise in the initializer's matched pixels and in every
    mapping pass's input: the reference's own sensitivity, which moves
    the drive's keyframe decisions), "seed<k>" (the sampler started from
    PRNGKey(k): the spread of the outcome over draws, which the port's own
    sampler is held to), or "merge"; each part writes
    build/mono_<kind>/<part>.npz."""
    out_path, n_frames, step, make_cfg, make_scene, n_noise = MONO_RUNS[kind]
    parts_dir = os.path.join(HERE, "..", "..", "build", f"mono_{kind}")
    os.makedirs(parts_dir, exist_ok=True)
    if part == "merge":
        out = dict(np.load(os.path.join(parts_dir, "main.npz")))
        for run in ["pinned"] + [f"noise{k}" for k in range(n_noise)]:
            n = np.load(os.path.join(parts_dir, f"{run}.npz"))
            for key in ("tracked", "rec_tcw", "kf_frames", "ate_sim3",
                        "init_frame", "init.T21", "init.good", "n_points"):
                out[f"{run}.{key}"] = n[key]
        k = 1
        while os.path.exists(os.path.join(parts_dir, f"seed{k}.npz")):
            n = np.load(os.path.join(parts_dir, f"seed{k}.npz"))
            for key in ("tracked", "kf_frames", "ate_sim3", "init_frame"):
                out[f"seed{k}.{key}"] = n[key]
            k += 1
        np.savez_compressed(out_path, **out)
        print(f"wrote {out_path}: {os.path.getsize(out_path) / 1e3:.1f} kB",
              flush=True)
        return
    cfg = make_cfg()
    noise, pins, seed = None, None, None
    if part.startswith("seed"):
        seed = int(part[len("seed"):])
    elif part != "main":
        # the main run's draws reduced to its winning trials, as the
        # port's replay hands them
        if part != "pinned":
            noise = int(part[len("noise"):])
        main = np.load(os.path.join(parts_dir, "main.npz"))
        pins = [(main["sets8"][a][bF:bF + 1], main["sets4"][a][bH:bH + 1])
                for a, (bF, bH) in enumerate(zip(main["attempt_bestF"],
                                                 main["attempt_bestH"]))]
    fps = 30.0 if kind == "small" else cfg.camera.fps
    res = run_mono(cfg, make_scene(cfg), orbit_poses(n_frames, step=step),
                   fps, f"mono {kind} {part}", noise_seed=noise,
                   keep_init=True, pins=pins, rng_seed=seed)
    np.savez_compressed(os.path.join(parts_dir, f"{part}.npz"), **res)


def loc_vga_poses():
    """LOC_VGA[0] frames of bench.py's orbit; then, still sliding along it,
    the camera pans LOC_VGA_YAW rad per frame away from the mapped region
    for LOC_VGA_OUT frames and back at the same rate until it looks along
    the orbit again, for the rest of the frames."""
    n_map, n_loc, n_after = LOC_VGA
    poses = []
    for i in range(n_map + n_loc + n_after):
        j = max(0, i - n_map + 1)
        off = LOC_VGA_YAW * max(0, min(j, LOC_VGA_OUT)
                                - max(0, j - LOC_VGA_OUT))
        yaw = 0.01 * i + off
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-(i * 0.01), 0.02 * np.sin(i * 0.3), 0.0]
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(T)
    return poses


def run_localization(cfg, scene, poses, on, off, objects, blob, fps, tag,
                     capture_vo=None):
    """One JAX run that maps, activates localization mode before frame
    ``on`` and deactivates it before frame ``off`` (None: never). Records
    each VO motion call's map-match and inlier counts, and the map's
    keyframe and point counts at each switch; with capture_vo, the inputs and outputs
    of the VO motion call of that frame."""
    import time
    sys_ = SlamSystem(cfg, enable_objects=objects)
    rec = Recorder(sys_)
    vo, held = [], {}
    motion_vo = sys_._jit_motion_vo

    def vo_rec(m, frame, last, T_pred):
        tr, n_map = motion_vo(m, frame, last, T_pred)
        vo.append((sys_.frame_id, int(n_map), int(tr.n_inliers)))
        if capture_vo == sys_.frame_id:
            held.update({"vo.T_pred": np.asarray(T_pred),
                         "vo.Tcw": np.asarray(tr.Tcw),
                         "vo.kp_pt": np.asarray(tr.kp_pt),
                         "vo.inlier": np.asarray(tr.inlier),
                         "vo.n_matches": np.int32(tr.n_matches),
                         "vo.n_inliers": np.int32(tr.n_inliers),
                         "vo.n_map": np.int32(n_map)})
            put_map(held, "vo.m", m)
            put_frame(held, "vo.frame", frame)
            put_frame(held, "vo.last", last)
        return tr, n_map
    sys_._jit_motion_vo = vo_rec
    counts = {}
    gray_sum = []
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        if i == on:
            sys_.activate_localization_mode()
            counts["on"] = (sys_.n_keyframes, sys_.n_points)
        if i == off:
            counts["off"] = (sys_.n_keyframes, sys_.n_points)
            sys_.deactivate_localization_mode()
        gray, depth, rgb, sem = scene.render_rgbd(T)
        gray_sum.append(float(np.sum(gray, dtype=np.float64)))
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances) \
            if objects else None
        if blob:
            d16 = np.clip(depth * cfg.camera.depth_map_factor, 0,
                          65535).astype(np.uint16)
            rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
            b, iv = sys_.builder.pack_frame_blob(d16, rgb8, sa)
            sys_.track_rgbd_blob(b, iv, timestamp=i / fps)
        else:
            sys_.track_rgbd(jnp.asarray(np.asarray(gray, np.float32)),
                            jnp.asarray(np.asarray(depth, np.float32)),
                            jnp.asarray(np.asarray(rgb, np.float32)), sa,
                            timestamp=i / fps)
        print(f"{tag} frame {i}: state={sys_.state} mapping="
              f"{sys_.enable_mapping} vo={vo[-1:]} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    sys_.flush_mapping()
    rec.close()
    traj = sys_.final_trajectory()
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    out = {
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "final_tcw": np.stack([t[1] for t in traj]).astype(np.float32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "gray_sum": np.asarray(gray_sum),
        "staged_frames": np.asarray(rec.staged, np.int32),
        "vo_frames": np.asarray([v[0] for v in vo], np.int32),
        "vo_n_map": np.asarray([v[1] for v in vo], np.int32),
        "vo_n_inliers": np.asarray([v[2] for v in vo], np.int32),
        "switch": np.asarray([on, -1 if off is None else off], np.int32),
        "seconds": np.float64(time.perf_counter() - t0),
    }
    for k, (nk, npt) in counts.items():
        out[f"n_kf_{k}"] = np.int32(nk)
        out[f"n_points_{k}"] = np.int32(npt)
    if objects:
        labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
        lab, cnt = np.unique(labels, return_counts=True)
        out.update({"census_labels": lab.astype(np.int32),
                    "census_counts": cnt.astype(np.int32),
                    "semantic_constraints": np.int64(
                        sys_.objects.semantic_constraints)})
    out.update(held)
    vo_mode = [v[0] for v in vo if v[1] < 10]
    print(f"{tag}: {int(out['tracked'].sum())}/{len(poses)} tracked, KFs "
          f"at {out['kf_frames']}, counts at the switches {counts}, VO "
          f"calls {len(vo)}, vo_mode frames {vo_mode}, staged "
          f"{len(rec.staged)} frames, {out['seconds']:.1f} s", flush=True)
    return out


def record_localization_small():
    """tests/test_slam.py's mid-sequence switch (18 frames, activation
    before frame 9, objects off, the default pipelined readback), with one
    VO motion call's inputs and outputs."""
    cfg = small_cfg().replace(tracking=TrackingConfig())
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    out = run_localization(cfg, scene, orbit_poses(LOC_SMALL_FRAMES,
                                                   step=0.015),
                           LOC_SMALL_SWITCH, None, False, False, 30.0,
                           "localization small",
                           capture_vo=LOC_SMALL_SWITCH + 3)
    np.savez_compressed(OUT_LOC_SMALL, **out)
    print(f"wrote {OUT_LOC_SMALL}: "
          f"{os.path.getsize(OUT_LOC_SMALL) / 1e3:.1f} kB", flush=True)


def record_localization_tum_vga():
    """chip_smoke.py's localization run: SlamConfig.tum_rgbd(), objects on,
    blobs, pipelined; LOC_VGA[0] frames map, then localization mode over a
    pan past the mapped region, then mapping again."""
    cfg = SlamConfig.tum_rgbd()
    n_map, n_loc, _ = LOC_VGA
    out = run_localization(cfg, tum_vga_scene(cfg), loc_vga_poses(), n_map,
                           n_map + n_loc, True, True, 30.0,
                           "localization vga")
    np.savez_compressed(OUT_LOC_VGA, **out)
    print(f"wrote {OUT_LOC_VGA}: {os.path.getsize(OUT_LOC_VGA) / 1e3:.1f} kB",
          flush=True)


def euroc_driver_frames():
    """The EuRoC driver phase's frames: bench.py's room at the EuRoC
    camera, EUROC_DRIVER_FRAMES stereo pairs of orbit_poses(step=
    EUROC_DRIVER_STEP) as u8 images."""
    cfg = euroc_cfg("stereo")
    scene = tum_vga_scene(cfg)
    poses = orbit_poses(EUROC_DRIVER_FRAMES, step=EUROC_DRIVER_STEP)
    frames = []
    for T in poses:
        gl, gr = scene.render_stereo(T)[:2]
        frames.append((np.clip(np.asarray(gl), 0, 255).astype(np.uint8),
                       np.clip(np.asarray(gr), 0, 255).astype(np.uint8)))
    return cfg, poses, frames


def record_euroc_driver():
    """scripts/run_euroc.py's stereo loop on the driver phase's frames, run
    through the library (the reference driver decodes with the native
    loader): each u8 pair as f32, rectified by the settings YAML that
    chip_smoke.py writes (zero distortion, identity R), rgb the left image
    three times, the mav0 timestamps."""
    import time
    from object_slam_tpu.datasets import euroc as jeuroc
    cfg, poses, frames = euroc_driver_frames()
    cam = cfg.camera
    Km = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    side = jeuroc.SideCalib(K=Km, D=np.zeros(5), R=np.eye(3), P=Km,
                            width=cam.width, height=cam.height)
    rect = jeuroc.Rectifier(jeuroc.EurocCalib(left=side, right=side))
    t0_ns = 1403636579763555584
    stamps = [t0_ns + int(round(i * 1e9 / cam.fps))
              for i in range(len(frames))]
    sys_ = SlamSystem(cfg, enable_objects=False)
    t0 = time.perf_counter()
    for i, ((gl, gr), ns) in enumerate(zip(frames, stamps)):
        gl, gr = rect(gl.astype(np.float32), gr.astype(np.float32))
        sys_.track_stereo(jnp.asarray(gl), jnp.asarray(gr),
                          jnp.asarray(np.stack([gl] * 3, -1)), None,
                          timestamp=float(ns) * 1e-9)
        print(f"euroc driver frame {i}: state={sys_.state} "
              f"t={time.perf_counter() - t0:.1f}s", flush=True)
    traj = sys_.final_trajectory()
    out = {
        "tracked": np.asarray([ok for _, _, ok in traj]),
        "final_tcw": np.stack([T for _, T, _ in traj]).astype(np.float32),
        "n_keyframes": np.int32(sys_.n_keyframes),
        "n_points": np.int32(sys_.n_points),
        "gray_sum": np.asarray([float(np.sum(gl, dtype=np.float64))
                                for gl, _ in frames]),
        "stamps": np.asarray(stamps, np.int64),
    }
    np.savez_compressed(OUT_EUROC_DRIVER, **out)
    print(f"euroc driver: {int(out['tracked'].sum())}/{len(frames)} tracked, "
          f"{out['n_keyframes']} KFs, {out['n_points']} points; wrote "
          f"{OUT_EUROC_DRIVER}", flush=True)


OUT_PARALLEL = os.path.join(HERE, "parallel.npz")
OUT_BATCHED = os.path.join(HERE, "batched.npz")


def record_parallel():
    from object_slam_tpu.parallel.sharded_ba import run_sharded_global_ba
    from object_slam_tpu.solvers.ba import ba_iterate
    from tests.test_solvers import build_ba_problem
    K = Intrinsics.from_config(SlamConfig().camera)
    prob, _, _ = build_ba_problem(jax.random.PRNGKey(0), n_kf=5, n_pt=200,
                                  noise=0.2)
    out = {f"prob.{f}": np.asarray(getattr(prob, f))
           for f in BAProblem._fields}
    kf, pt = ba_iterate(K, prob, 5)
    out["ref.kf_pose"], out["ref.pt_xyz"] = np.asarray(kf), np.asarray(pt)
    kf, pt = run_sharded_global_ba(K, prob, devices=jax.devices()[:2],
                                   n_iters=5)
    out["shard2.kf_pose"], out["shard2.pt_xyz"] = (np.asarray(kf),
                                                   np.asarray(pt))
    np.savez_compressed(OUT_PARALLEL, **out)
    print(f"parallel: wrote {OUT_PARALLEL}", flush=True)


def record_batched():
    from object_slam_tpu.geometry import camera as cam_mod
    from object_slam_tpu.parallel.batched_tracking import (BatchedTracker,
                                                           stack_pytrees)
    from tests.test_batched import make_sequence_state
    cfg = SlamConfig(caps=CapacityConfig(n_kp=128, max_points=512,
                                         max_keyframes=8))
    K = cam_mod.Intrinsics.from_config(cfg.camera)
    sf = jnp.asarray([1.2 ** l for l in range(8)], jnp.float32)
    B, N = 4, cfg.caps.n_kp
    parts = [make_sequence_state(cfg, K, s) for s in range(B)]
    maps = stack_pytrees([p[0] for p in parts])
    frames = stack_pytrees([p[1] for p in parts])
    args = dict(last_uv=jnp.stack([p[2] for p in parts]),
                last_pt=jnp.stack([p[3] for p in parts]),
                last_level=jnp.zeros((B, N), jnp.int32),
                last_valid=jnp.ones((B, N), bool),
                T_pred=jnp.broadcast_to(jnp.eye(4), (B, 4, 4)))
    bt = BatchedTracker(K, sf, 1.0 / (sf * sf), float(np.log(1.2)))
    res, maps2 = bt.step(maps, frames, *args.values())
    out = {}
    put_map(out, "maps", maps)
    put_frame(out, "frames", frames)
    for f in Object2DSlab._fields:
        out[f"frames.obj.{f}"] = np.asarray(getattr(frames.obj, f))
    for k, v in args.items():
        out[k] = np.asarray(v)
    out["T_true"] = np.asarray(jnp.stack([p[4] for p in parts]))
    for f in ("Tcw", "kp_pt", "inlier", "n_matches", "n_inliers"):
        out[f"res.{f}"] = np.asarray(getattr(res, f))
    out["out.pt_visible"] = np.asarray(maps2.pt_visible)
    out["out.pt_found"] = np.asarray(maps2.pt_found)
    np.savez_compressed(OUT_BATCHED, **out)
    print(f"batched: wrote {OUT_BATCHED}; inliers "
          f"{np.asarray(res.n_inliers).tolist()}", flush=True)


# ---------------------------------------------------------------------------
# the parity tests that sit on near-ties: the JAX side recorded once, and
# the reference's own one-ulp spread from more samples
# ---------------------------------------------------------------------------

OUT_PNP = os.path.join(HERE, "pnp_cases.npz")
KITTI_PASS_NOISE_TRIALS = 16
LOOP_SMALL_NOISE_RUNS = 4


def record_pnp_cases():
    """jepnp.pnp_ransac on pnp_cases.correspondences(seed) for each seed of
    pnp_cases.SEEDS: its index sets (PRNGKey(seed)), every hypothesis's
    score as pnp_ransac computes it, the winner and the polished result."""
    from object_slam_tpu.solvers import epnp as jepnp
    from object_slam_tpu.solvers import ransac as jransac
    import pnp_cases
    K = Intrinsics(**pnp_cases.TUM)
    out = {}
    for seed in pnp_cases.SEEDS:
        pw, uv, valid, _, _ = pnp_cases.correspondences(seed)
        key = jax.random.PRNGKey(seed)
        pwj, uvj, vj = jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid)
        idx = jransac.sample_minimal_sets(key, pw.shape[0], vj, 256, 6)
        res = jepnp.pnp_ransac(key, K, pwj, uvj, vj, min_inliers=25)
        # the scores, as pnp_ransac computes them (epnp.py:80-92)
        xn = jnp.stack([(uvj[..., 0] - K.cx) / K.fx,
                        (uvj[..., 1] - K.cy) / K.fy], -1)
        T = jepnp.dlt_pose(pwj[idx], xn[idx])
        pc = jnp.einsum('tij,nj->tni', T[:, :3, :3], pwj) + T[:, None, :3, 3]
        z = pc[..., 2]
        u = K.fx * pc[..., 0] / jnp.maximum(z, 1e-6) + K.cx
        v = K.fy * pc[..., 1] / jnp.maximum(z, 1e-6) + K.cy
        chi2 = (u - uvj[None, :, 0]) ** 2 + (v - uvj[None, :, 1]) ** 2
        scores = np.asarray(jnp.sum((chi2 < 5.991) & (z > 0) & vj[None, :],
                                    axis=-1))
        out.update({f"{seed}.idx": np.asarray(idx, np.int32),
                    f"{seed}.scores": scores.astype(np.int32),
                    f"{seed}.best": np.int32(np.argmax(scores)),
                    f"{seed}.inliers": np.asarray(res.inliers),
                    f"{seed}.n_inliers": np.int32(res.n_inliers),
                    f"{seed}.ok": np.bool_(res.ok),
                    f"{seed}.Tcw": np.asarray(res.Tcw, np.float32)})
        print(f"pnp seed {seed}: best hypothesis {int(np.argmax(scores))} "
              f"({int(scores.max())} inliers), polished "
              f"{int(res.n_inliers)}", flush=True)
    np.savez_compressed(OUT_PNP, **out)
    print(f"wrote {OUT_PNP}: {os.path.getsize(OUT_PNP) / 1e3:.1f} kB",
          flush=True)


PNP_NOISE_TRIALS = 1024


def pnp_scores(K, pw, uv, valid, idx):
    """Every hypothesis's score as jepnp.pnp_ransac computes it
    (epnp.py:80-92) on the index sets ``idx``."""
    from object_slam_tpu.solvers import epnp as jepnp
    pwj, uvj, vj = jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid)
    xn = jnp.stack([(uvj[..., 0] - K.cx) / K.fx,
                    (uvj[..., 1] - K.cy) / K.fy], -1)
    T = jepnp.dlt_pose(pwj[idx], xn[idx])
    pc = jnp.einsum('tij,nj->tni', T[:, :3, :3], pwj) + T[:, None, :3, 3]
    z = pc[..., 2]
    u = K.fx * pc[..., 0] / jnp.maximum(z, 1e-6) + K.cx
    v = K.fy * pc[..., 1] / jnp.maximum(z, 1e-6) + K.cy
    chi2 = (u - uvj[None, :, 0]) ** 2 + (v - uvj[None, :, 1]) ** 2
    return np.asarray(jnp.sum((chi2 < 5.991) & (z > 0) & vj[None, :],
                              axis=-1)).astype(np.int32)


def record_pnp_cases_noise():
    """The reference's one-ulp spread of every hypothesis's score: for each
    seed, the scores of pnp_cases.npz's recorded index sets recomputed
    PNP_NOISE_TRIALS times, each with every pixel coordinate moved by one
    float32 ulp up, down or not at all (RandomState(trial)). Adds to
    pnp_cases.npz "<seed>.scores_lo" / "<seed>.scores_hi", each set's
    least and greatest score over the trials and the recorded run (the
    envelope), and "<seed>.scores_rerun", the noise-free scores on this
    machine."""
    import pnp_cases
    K = Intrinsics(**pnp_cases.TUM)
    out = dict(np.load(OUT_PNP))
    for seed in pnp_cases.SEEDS:
        pw, uv, valid, _, _ = pnp_cases.correspondences(seed)
        idx = jnp.asarray(out[f"{seed}.idx"])
        rerun = pnp_scores(K, pw, uv, valid, idx)
        trials = []
        for t in range(PNP_NOISE_TRIALS):
            step = np.random.RandomState(t).randint(-1, 2, uv.shape)
            uv_t = np.where(step > 0, np.nextafter(uv, np.float32(np.inf)),
                            np.where(step < 0,
                                     np.nextafter(uv, np.float32(-np.inf)),
                                     uv)).astype(np.float32)
            trials.append(pnp_scores(K, pw, uv_t, valid, idx))
        trials = np.stack(trials)
        rec = out[f"{seed}.scores"]
        lo = np.minimum(trials.min(0), rec)
        hi = np.maximum(trials.max(0), rec)
        out[f"{seed}.scores_lo"] = lo.astype(np.int32)
        out[f"{seed}.scores_hi"] = hi.astype(np.int32)
        out[f"{seed}.scores_rerun"] = rerun
        print(f"pnp seed {seed}: the rerun differs from the recorded scores "
              f"on {int((rerun != rec).sum())} sets; {PNP_NOISE_TRIALS} "
              f"one-ulp trials move {int((hi > lo).sum())} of {len(rec)} "
              f"sets' scores, by up to {int((hi - lo).max())}", flush=True)
    np.savez_compressed(OUT_PNP, **out)
    print(f"wrote {OUT_PNP}: {os.path.getsize(OUT_PNP) / 1e3:.1f} kB",
          flush=True)


def record_kitti_pass_noise():
    """The JAX local BA of kitti_pass.npz once more on its recorded input
    (on this machine: how far from the recorded output it lands), then
    KITTI_PASS_NOISE_TRIALS times with the points scaled by (1 + u) as
    record_kitti_pass draws them (RandomState(0): the first
    KITTI_PASS_TRIALS draws are its draws). Adds to kitti_pass.npz
    "ba_rerun_kf_move" (the noise-free rerun's keyframe move) and
    "ba_ulp_kf_move_rerun" (every trial's), both from the recorded
    output: the reference's one-ulp spread on another machine, from more
    samples; "ba_ulp_kf_move" (the recording machine's trials) stays."""
    from object_slam_tpu.slam import local_mapping as jlm
    from object_slam_tpu_torch import interop
    fx = np.load(OUT_KITTI_PASS)
    cfg = SlamConfig.kitti_stereo()
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=False)
    base = {f: np.asarray(getattr(sys_.map, f)) for f in MapState._fields}
    maps = interop.stage_maps(fx, base, fx["stages"].tolist())
    ba_in, ba_out = maps["point_stats"], maps["local_ba"]
    kf, fast = int(fx["kf"]), bool(fx["fast"])
    J = lambda d: MapState(**{f: jnp.asarray(v) for f, v in d.items()})  # noqa: E731
    W = jlm.covisibility(J(maps["in"]))[kf]
    it1, it2 = cfg.mapping.ba_abort_iters if fast else (5, 10)

    def ba(d):
        t = jlm.run_local_ba(
            m=J(d), K=sys_.K, kf_id=jnp.int32(kf),
            window=cfg.caps.local_window_kf, n_fixed=8,
            inv_sigma2_lvl=sys_.inv_sigma2, iters1=it1, iters2=it2,
            pt_cap=cfg.caps.local_pt_cap, W_row=W,
            obs_cap=cfg.caps.local_obs_per_kf)
        return np.asarray(t.kf_pose)
    kv = ba_out["kf_valid"]

    def move(pose):
        return float(np.max(np.linalg.norm(
            pose[kv][:, :3, 3] - ba_out["kf_pose"][kv][:, :3, 3], axis=1)))
    again = move(ba(ba_in))
    rng = np.random.RandomState(0)
    moves = []
    for _ in range(KITTI_PASS_NOISE_TRIALS):
        d = dict(ba_in)
        d["pt_xyz"] = (ba_in["pt_xyz"] * (1.0 + rng.uniform(
            -6e-8, 6e-8, ba_in["pt_xyz"].shape))).astype(np.float32)
        moves.append(move(ba(d)))
        print(f"kitti pass noise trial {len(moves)}: {moves[-1] * 1e3:.4f} "
              f"mm", flush=True)
    old = fx["ba_ulp_kf_move"]
    print(f"kitti pass: the JAX BA on its recorded input lands "
          f"{again * 1e3:.4f} mm from the recorded output on this machine; "
          f"its first {len(old)} noise trials read "
          f"{[round(x * 1e3, 4) for x in moves[:len(old)]]} mm (recorded "
          f"{[round(x * 1e3, 4) for x in old]}); all "
          f"{[round(x * 1e3, 4) for x in moves]} mm", flush=True)
    out = {k: fx[k] for k in fx.files}
    out["ba_ulp_kf_move_rerun"] = np.asarray(moves)
    out["ba_rerun_kf_move"] = np.float64(again)
    np.savez_compressed(OUT_KITTI_PASS, **out)
    print(f"wrote {OUT_KITTI_PASS}: "
          f"{os.path.getsize(OUT_KITTI_PASS) / 1e3:.1f} kB", flush=True)


def record_loop_small_noise(part):
    """part "noise<k>": the small circuit as record_loop_small runs it,
    with one-ulp noise (seed k) in every local-mapping pass's and every
    closure's input points from the frame after the replay's start
    (loop_small.npz "start") on: the reference under another rounding of
    the frames the port replays. Writes build/loop_small_noise/<part>.npz.
    Part "merge" adds their closer events to loop_small.npz as
    "noise_events" (a JSON list, one event list per run)."""
    parts_dir = os.path.join(HERE, "..", "..", "build", "loop_small_noise")
    if part == "merge":
        fx = np.load(OUT_LOOP_SMALL)
        runs = [json.loads(str(np.load(os.path.join(
            parts_dir, f"noise{k}.npz"))["events"]))
            for k in range(LOOP_SMALL_NOISE_RUNS)]
        out = {k: fx[k] for k in fx.files}
        out["noise_events"] = np.asarray(json.dumps(runs))
        np.savez_compressed(OUT_LOOP_SMALL, **out)
        print(f"loop small noise events {runs}; wrote {OUT_LOOP_SMALL}: "
              f"{os.path.getsize(OUT_LOOP_SMALL) / 1e3:.1f} kB", flush=True)
        return
    seed = int(part[len("noise"):])
    start = int(np.load(OUT_LOOP_SMALL)["start"])
    cfg = loop_small_cfg()

    def add_noise(sys_):
        ulp_noise(sys_, 100 + seed)
        rng = np.random.RandomState(200 + seed)
        lc = sys_.loop_closer
        on_kf = lc.on_keyframe
        lc.on_keyframe = lambda m, kf: on_kf(_noisy(m, rng), kf)
        return {}
    res, _, _ = run_loop(cfg, loop_scene(cfg), loop_poses(LOOP_SMALL_FRAMES),
                         objects=False, blob=False, capture=start,
                         on_capture=add_noise, tag=f"loop small {part}")
    os.makedirs(parts_dir, exist_ok=True)
    np.savez_compressed(os.path.join(parts_dir, part + ".npz"),
                        events=res["events"],
                        insert_frames=res["insert_frames"])


# ---------------------------------------------------------------------------
# the offline tools: the experiment battery, the vocabulary trainer and the
# BRIEF-pattern learner of scripts/, run through their own functions
# ---------------------------------------------------------------------------

OUT_EXPERIMENTS = os.path.join(HERE, "experiments.npz")
# the battery's directories (chip_smoke.py writes the same with the port's
# generators) and its depth
EXP_TUM_FRAMES = 40
EXP_KITTI_FRAMES = 24
EXP_DEPTH = 24


def load_script(name):
    """scripts/<name>.py as a module (its main() is not run)."""
    import importlib.util
    path = os.path.join(HERE, "..", "..", "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("ref_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_dirs(root, n_tum=EXP_TUM_FRAMES, n_kitti=EXP_KITTI_FRAMES):
    """scripts/make_synth_tum.py --frames n_tum and make_synth_kitti.py
    --frames n_kitti under root (tum/, kitti/)."""
    import subprocess
    for script, sub, n in (("make_synth_tum", "tum", n_tum),
                           ("make_synth_kitti", "kitti", n_kitti)):
        subprocess.run([sys.executable, os.path.join(
            HERE, "..", "..", "scripts", script + ".py"), "--out",
            os.path.join(root, sub), "--frames", str(n)], check=True)


def synth_digests(root):
    """{path under root: sha256} of every file the generators wrote under
    root: a PNG's decoded array (PIL; dtype, shape and bytes), any other
    file's bytes."""
    import hashlib
    from PIL import Image
    out = {}
    for sub in ("tum", "kitti"):
        for dirpath, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                path = os.path.join(dirpath, f)
                if f.endswith(".png"):
                    a = np.asarray(Image.open(path))
                    data = f"{a.dtype.str}{a.shape}".encode() + a.tobytes()
                else:
                    data = open(path, "rb").read()
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    data).hexdigest()
    return out


def record_runs(runs):
    """Each (name, fn) of runs: fn() runs one of scripts/run_experiments.py's
    variants and returns its result JSON; kept with every frame's tracked
    flag and the frames of the valid keyframes of the last SlamSystem it
    built (the class is wrapped while they run)."""
    import object_slam_tpu.slam.system as jsys
    made, out = [], {}

    class Recorded(SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    jsys.SlamSystem = Recorded
    try:
        for name, fn in runs:
            res = fn()
            s = made[-1]
            out[f"{name}.json"] = np.asarray(json.dumps(res))
            out[f"{name}.tracked"] = np.asarray([r.tracked
                                                 for r in s.trajectory])
            kv = np.asarray(s.map.kf_valid)
            out[f"{name}.kf_frames"] = np.asarray(
                s.map.kf_frame_id)[kv].astype(np.int32)
            print(name, json.dumps(res)[:400], flush=True)
    finally:
        jsys.SlamSystem = SlamSystem
    return out


OUT_EXPERIMENTS_TINY = os.path.join(HERE, "experiments_tiny.npz")
# tests/test_torch_experiments.py's directories and variants
TINY_TUM_FRAMES = 4
TINY_KITTI_FRAMES = 3
TINY_TUM_VARIANTS = ("t200_a", "t200_noobj_sync")


def record_experiments_tiny():
    """scripts/run_experiments.py's run_tum_variant (TINY_TUM_VARIANTS) on
    a make_synth_tum.py directory of TINY_TUM_FRAMES frames and run_kitti
    (inline mapping) on a make_synth_kitti.py one of TINY_KITTI_FRAMES,
    each kept by record_runs."""
    root = os.path.join(HERE, "..", "..", "build", "experiments_tiny")
    make_dirs(root, TINY_TUM_FRAMES, TINY_KITTI_FRAMES)
    ex = load_script("run_experiments")
    cfg = SlamConfig.tum_rgbd()
    tum_dir = os.path.join(root, "tum")
    metas, frames = ex.load_tum_frames(tum_dir, cfg)
    kw = {"t200_a": dict(enable_objects=True, async_mapping=False),
          "t200_noobj_sync": dict(enable_objects=False, async_mapping=False)}
    runs = [(name, lambda k=kw[name]: ex.run_tum_variant(
        tum_dir, cfg, frames, metas, **k)) for name in TINY_TUM_VARIANTS]
    runs.append(("kitti", lambda: ex.run_kitti(os.path.join(root, "kitti"))))
    out = record_runs(runs)
    np.savez_compressed(OUT_EXPERIMENTS_TINY, **out)
    print(f"wrote {OUT_EXPERIMENTS_TINY}: "
          f"{os.path.getsize(OUT_EXPERIMENTS_TINY) / 1e3:.1f} kB", flush=True)


def record_experiments():
    """scripts/run_experiments.py's functions on the directories its
    generators write (make_dirs, under build/experiments/): each TUM
    variant of its list over the first EXP_DEPTH frames, and run_kitti
    over EXP_DEPTH frames inline and async (after its 12-frame scratch
    prewarm, whose system is thrown away), each kept by record_runs; and
    the directories' synth_digests."""
    root = os.path.join(HERE, "..", "..", "build", "experiments")
    make_dirs(root)
    ex = load_script("run_experiments")
    cfg = SlamConfig.tum_rgbd()
    tum_dir = os.path.join(root, "tum")
    metas, frames = ex.load_tum_frames(tum_dir, cfg, EXP_DEPTH)
    cfg_semoff = cfg.replace(objects=dataclasses.replace(
        cfg.objects, semopt_enabled=False))
    # run_experiments.main()'s variant list
    variants = [
        ("t200_a", cfg, dict(enable_objects=True, async_mapping=False)),
        ("t200_b", cfg, dict(enable_objects=True, async_mapping=False)),
        ("t200_noobj_sync", cfg,
         dict(enable_objects=False, async_mapping=False)),
        ("t200_semopt_off", cfg_semoff,
         dict(enable_objects=True, async_mapping=False)),
        ("t200_async", cfg, dict(enable_objects=True, async_mapping=True)),
        ("t200_loop", cfg,
         dict(enable_objects=True, async_mapping=False, enable_loop=True))]
    runs = [(name, lambda c=vcfg, k=kw: ex.run_tum_variant(
        tum_dir, c, frames, metas, **k)) for name, vcfg, kw in variants]
    kitti_dir = os.path.join(root, "kitti")
    runs += [(name, lambda a=amap: ex.run_kitti(kitti_dir, EXP_DEPTH,
                                                async_mapping=a))
             for name, amap in (("kitti", False), ("kitti_async", True))]
    out = record_runs(runs)
    out["synth_digests"] = np.asarray(json.dumps(synth_digests(root),
                                                 sort_keys=True))
    out["tum_frames"] = np.int32(EXP_TUM_FRAMES)
    out["kitti_frames"] = np.int32(EXP_KITTI_FRAMES)
    out["depth"] = np.int32(EXP_DEPTH)
    np.savez_compressed(OUT_EXPERIMENTS, **out)
    print(f"wrote {OUT_EXPERIMENTS}: "
          f"{os.path.getsize(OUT_EXPERIMENTS) / 1e3:.1f} kB", flush=True)


OUT_VOCAB = os.path.join(HERE, "vocab_train.npz")
OUT_BRIEF = os.path.join(HERE, "brief.npz")
# the CPU test's small harvest, and the integer corpora the selection is
# held on (brief_cases.integer_corpus): the CPU test's and chip_smoke.py's
BRIEF_HARVEST = 800
BRIEF_CORPORA = (2000, 8000)
BRIEF_HEAD = 16


def sha256_file(path):
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def vocab_render_counts(full_desc):
    """[80] int64: the valid keypoints of each render of train_vocab.py's
    full harvest (10 scenes x 8 poses, in its order), so that a test can
    take one render's rows of the recorded descriptors; the renders'
    descriptors, concatenated, must be the recorded ones."""
    from object_slam_tpu.config import SlamConfig
    from object_slam_tpu.datasets.synthetic import (SyntheticScene,
                                                    loop_trajectory)
    from object_slam_tpu.features.extractor import OrbExtractor
    cfg = SlamConfig.tum_rgbd()
    ex = OrbExtractor(cfg)
    counts, descs = [], []
    for seed in range(10):
        scene = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                                    plane_z=3.2 + 0.3 * seed)
        for T in loop_trajectory(8):
            kp = ex(jnp.asarray(scene.render_rgbd(T)[0]))
            v = np.asarray(kp.valid)
            descs.append(np.asarray(kp.desc)[v])
            counts.append(int(v.sum()))
    assert np.array_equal(np.concatenate(descs, 0), full_desc)
    return np.asarray(counts, np.int64)


def record_vocab_counts():
    """Add ``full.counts`` (vocab_render_counts) to vocab_train.npz."""
    out = dict(np.load(OUT_VOCAB))
    out["full.counts"] = vocab_render_counts(out["full.desc"])
    np.savez_compressed(OUT_VOCAB, **out)
    print(f"wrote {OUT_VOCAB}: {os.path.getsize(OUT_VOCAB) / 1e3:.1f} kB",
          flush=True)


def record_vocab():
    """scripts/train_vocab.py's harvest and training (Vocabulary.train,
    k=10, L=4, seed 0, as its main() runs them) on 1 scene x 2 poses and
    at full size (10 scenes x 8 poses): the descriptors, their sha256 and
    the written file's, and whether the full file is the committed
    loop/vocab_synth.txt. The files go to build/vocab_train/, never into
    object_slam_tpu/."""
    import hashlib
    from object_slam_tpu.loop.vocabulary import Vocabulary
    tv = load_script("train_vocab")
    root = os.path.join(HERE, "..", "..", "build", "vocab_train")
    os.makedirs(root, exist_ok=True)
    out = {}
    for tag, kw in (("small", dict(n_scenes=1, n_poses=2)),
                    ("full", dict(n_scenes=10))):
        descs = tv.harvest(**kw)
        path = os.path.join(root, tag + ".txt")
        Vocabulary.train(descs, 10, 4, seed=0).save_dbow2_text(path)
        out[f"{tag}.n"] = np.int64(descs.shape[0])
        out[f"{tag}.desc_sha256"] = np.asarray(
            hashlib.sha256(np.ascontiguousarray(descs).tobytes()).hexdigest())
        out[f"{tag}.sha256"] = np.asarray(sha256_file(path))
        out[f"{tag}.desc"] = descs
    committed = os.path.join(HERE, "..", "..", "object_slam_tpu", "loop",
                             "vocab_synth.txt")
    out["committed.sha256"] = np.asarray(sha256_file(committed))
    print(f"vocabulary: small {int(out['small.n'])} descriptors, full "
          f"{int(out['full.n'])}, file {out['full.sha256']}; the committed "
          f"file {'is' if out['full.sha256'] == out['committed.sha256'] else 'is not'}"
          f" reproduced", flush=True)
    out["full.counts"] = vocab_render_counts(out["full.desc"])
    np.savez_compressed(OUT_VOCAB, **out)
    print(f"wrote {OUT_VOCAB}: {os.path.getsize(OUT_VOCAB) / 1e3:.1f} kB",
          flush=True)


def brief_quality(pattern, corpus, tb):
    """train_brief_pattern.main()'s quality numbers for a pattern over a
    corpus (its formulas, at full precision): |mean - 0.5| avg, |corr| avg
    and p95."""
    pos = tb.candidate_positions()
    index = {tuple(p): i for i, p in enumerate(pos.tolist())}
    flat = corpus.reshape(corpus.shape[0], -1)
    rows = []
    for y1, x1, y2, x2 in pattern.astype(int).tolist():
        a = (y1 + tb.HALF) * tb.PATCH + (x1 + tb.HALF)
        b = (y2 + tb.HALF) * tb.PATCH + (x2 + tb.HALF)
        assert (y1, x1) in index and (y2, x2) in index
        rows.append(flat[:, a] < flat[:, b])
    bits = np.asarray(rows, np.float32)
    mm = np.abs(bits.mean(axis=1) - 0.5)
    cc = np.abs(np.corrcoef(bits))
    np.fill_diagonal(cc, 0)
    return np.asarray([mm.mean(), cc.mean(), np.percentile(cc, 95)])


def record_brief():
    """scripts/train_brief_pattern.py through its own functions: its
    harvest at BRIEF_HARVEST patches (per-patch sums and the first
    BRIEF_HEAD patches kept) and at full size (the per-render, per-level
    patch counts and per-patch sums); then its main() with
    harvest_patches swapped for brief_cases.integer_corpus(n) and np.save
    intercepted, for each n of BRIEF_CORPORA: the pattern, its quality
    numbers and the scan order main() took (its np.argsort). Nothing is
    written into object_slam_tpu/."""
    import brief_cases
    tb = load_script("train_brief_pattern")
    out = {}
    h = tb.harvest_patches(BRIEF_HARVEST)
    out["harvest.sums"] = h.reshape(h.shape[0], -1).sum(1)
    out["harvest.head"] = h[:BRIEF_HEAD]
    # the full harvest, with the patch count of every extract call
    counts = []
    import object_slam_tpu.ops.patch_pallas as pp
    orig = pp.extract_patches_auto

    def counted(img, ys, xs, patch):
        counts.append((int(img.shape[0]), int(ys.shape[0])))
        return orig(img, ys, xs, patch)
    pp.extract_patches_auto = counted
    try:
        full = tb.harvest_patches()
    finally:
        pp.extract_patches_auto = orig
    out["full.sums"] = full.reshape(full.shape[0], -1).sum(1)
    out["full.calls"] = np.asarray(counts, np.int32)
    print(f"brief: harvest {h.shape[0]} / {full.shape[0]} patches, "
          f"{len(counts)} extract calls", flush=True)
    for n in BRIEF_CORPORA:
        corpus = brief_cases.integer_corpus(n)
        saved, orders = {}, []
        argsort, save = np.argsort, np.save

        def keep_order(a, *args, **kw):
            r = argsort(a, *args, **kw)
            orders.append(r)
            return r
        tb.harvest_patches = lambda n_target=50000, c=corpus: c
        np.argsort = keep_order
        np.save = lambda path, arr: saved.update(pattern=np.asarray(arr))
        try:
            tb.main()
        finally:
            np.argsort, np.save = argsort, save
        order = [o for o in orders if o.ndim == 1 and o.shape[0] > 50000]
        assert len(order) == 1, [o.shape for o in orders]
        out[f"corpus{n}.pattern"] = saved["pattern"]
        out[f"corpus{n}.order"] = order[0].astype(np.int32)
        out[f"corpus{n}.quality"] = brief_quality(saved["pattern"], corpus,
                                                  tb)
        print(f"brief: integer corpus {n}: quality "
              f"{out[f'corpus{n}.quality'].tolist()}", flush=True)
    np.savez_compressed(OUT_BRIEF, **out)
    print(f"wrote {OUT_BRIEF}: {os.path.getsize(OUT_BRIEF) / 1e3:.1f} kB",
          flush=True)


def record_harvest_cpu(which=("vocab", "brief")):
    """The port's two harvests on the CPU (scripts/train_vocab_torch.py's
    and train_brief_pattern_torch.py's, the reference's pyramid order)
    against the reference's recorded ones: the indices of the descriptor
    rows that differ (``cpu_port.diff_rows`` in vocab_train.npz); and each
    BRIEF window's hash (window_hashes; ``cpu_port.window_hash`` in
    brief.npz). The card's vocabulary harvest is held to the rows, its
    BRIEF windows counted against the hashes."""
    sys.path.insert(0, os.path.join(HERE, "..", "..", "scripts"))
    import train_brief_pattern_torch as tbt
    import train_vocab_torch as tvt
    from brief_cases import window_hashes
    if "vocab" in which:
        vocab = dict(np.load(OUT_VOCAB))
        descs = tvt.harvest(device="cpu")
        assert descs.shape == vocab["full.desc"].shape
        rows = np.flatnonzero(np.any(descs != vocab["full.desc"], axis=1))
        vocab["cpu_port.diff_rows"] = rows.astype(np.int64)
        np.savez_compressed(OUT_VOCAB, **vocab)
        print(f"vocabulary harvest: the CPU port parts from the reference "
              f"in rows {rows.tolist()}; wrote {OUT_VOCAB}", flush=True)
    if "brief" in which:
        brief = dict(np.load(OUT_BRIEF))
        hashes = window_hashes(tbt.harvest_patches(device="cpu").numpy())
        assert hashes.shape == brief["full.sums"].shape
        brief["cpu_port.window_hash"] = hashes
        np.savez_compressed(OUT_BRIEF, **brief)
        print(f"BRIEF harvest: {hashes.size} window hashes; wrote "
              f"{OUT_BRIEF} ({os.path.getsize(OUT_BRIEF) / 1e3:.1f} kB)",
              flush=True)


OUT_XLA_RESIZE = os.path.join(HERE, "..", "..", "object_slam_tpu_torch",
                              "features", "xla_resize.npz")
# the image sizes whose pyramids the port computes as XLA:CPU does
XLA_RESIZE_SIZES = ((480, 640),)
# the jitted reference's pyramids of renders of these train_vocab.py rooms
# (poses 0 and 1 of loop_trajectory(8)), as sha256 per level, for the CPU
# test of the port's pyramid
XLA_RESIZE_CHECK_SCENES = (1, 6)
OUT_XLA_RESIZE_CHECK = os.path.join(HERE, "xla_resize_check.npz")


def _probe_chained(dot, K, M, N):
    """Positions b in 1..K-1 where XLA:CPU's dot does NOT fuse the product
    of k = b into the running sum of k = b - 1 (an FMA chain): planted
    products 2^-24 (1 - 2^-24) at b - 1 and (1 + 2^-23)(1 - 2^-24) at b sum
    to 1 + 2^-23 in one chain and to 1 when the second product is rounded
    first or summed apart."""
    e = np.float32(2.0 ** -24)
    hi = np.float32(1 + 2.0 ** -23)
    lo = np.float32(1 - 2.0 ** -24)
    split = []
    for s0 in range(1, K, M):
        bs = list(range(s0, min(s0 + M, K)))
        w = np.zeros((K, M), np.float32)
        for i, b in enumerate(bs):
            w[b - 1, i] = e
            w[b, i] = hi
        out = dot(w, np.full((K, N), lo, np.float32))
        assert (out == out[:, :1]).all()
        out = out[:, 0]
        for i, b in enumerate(bs):
            assert out[i] in (np.float32(1.0), hi), (K, M, N, b, out[i])
            if out[i] == np.float32(1.0):
                split.append(b)
    return split


def _probe_first_pair(dot, wts, N):
    """For each output of three taps k0 < k0+1 < k0+2, which two XLA:CPU's
    dot sums first: planted (1, 2^-24, -1) in the three rotations; the one
    that cancels to 0 puts 1 and 2^-24 in the first pair."""
    v = np.array([1.0, 2.0 ** -24, -1.0], np.float32)
    K, M = wts.shape
    ones = (wts != 0).astype(np.float32)
    zero = []
    for t in range(3):
        k = np.arange(K)
        z = dot(ones, np.broadcast_to(v[(k + t) % 3][:, None],
                                      (K, N)).copy()) == 0
        assert (z.all(1) | ~z.any(1)).all()
        zero.append(z[:, 0])
    pairs = {}
    for j in range(M):
        ks = np.nonzero(wts[:, j])[0]
        if len(ks) != 3:
            continue
        t = [i for i in range(3) if zero[i][j]]
        assert len(t) == 1, (K, M, j, t)
        p1 = (-(ks[0] + t[0])) % 3          # the slot that held 1.0
        pairs[int(ks[0])] = tuple(sorted((p1, (p1 + 1) % 3)))
    return pairs


def record_xla_resize():
    """How XLA:CPU computes jax.image.resize(..., 'linear') for each level
    of the pyramids of XLA_RESIZE_SIZES (build_pyramid, 8 levels, 1.2): the
    weight matrices as the compiled program computes them (the resize of an
    identity, which copies them out exactly) and, for each of its two
    products, the order in which each output's (at most three) tap products
    are summed, found by planting values whose sum depends on the order:
    Eigen's GEMM chains products into one FMA sum and splits the depth into
    blocks (whose partial sums are then added); some shapes run a kernel
    that sums even and odd depth apart, or adds rounded products in pairs.
    Written to object_slam_tpu_torch/features/xla_resize.npz, which
    pyramid.resize_linear executes; refused unless the port's pyramid then
    equals the jitted reference's bit for bit on rendered frames, whose
    levels' sha256 go to xla_resize_check.npz."""
    import hashlib
    from object_slam_tpu.config import SlamConfig
    from object_slam_tpu.datasets.synthetic import (SyntheticScene,
                                                    loop_trajectory)
    from object_slam_tpu.features import pyramid as jpyr
    import torch
    from object_slam_tpu_torch.features import pyramid as tpyr

    # both return [M, N]: output index first
    def dot_rows(w, x):        # [K, M] weights, [K, N] image -> [M, N]
        return np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
            a, b, (((0,), (0,)), ((), ())), precision="highest"))(w, x))

    def dot_cols(w, x):        # [K, M] weights, [K, N] = image.T -> [N, M]
        return np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())), precision="highest"))(
                np.ascontiguousarray(x.T), w)).T

    def weights(n_in, n_out):  # [n_in, n_out]
        return np.asarray(jax.jit(lambda e: jax.image.resize(
            e, (n_out, n_in), "linear"))(jnp.eye(n_in, dtype=jnp.float32))).T

    out = {}
    for h, w in XLA_RESIZE_SIZES:
        shapes = jpyr.level_shapes(h, w, 8, 1.2)
        for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
            for axis, n_in, n_out, other, dot in (
                    ("rows", h0, h1, w0, dot_rows),
                    ("cols", w0, w1, h1, dot_cols)):
                wts = weights(n_in, n_out)
                split = _probe_chained(dot, n_in, n_out, other)
                start = np.zeros(n_out, np.int32)
                wk = np.zeros((n_out, 3), np.float32)
                ks = np.zeros((n_out, 3), np.int64)
                for j in range(n_out):
                    nz = np.nonzero(wts[:, j])[0]
                    assert len(nz) <= 3 and (
                        len(nz) == 0 or nz[-1] - nz[0] == len(nz) - 1)
                    start[j] = nz[0] if len(nz) else 0
                    wk[j, :len(nz)] = wts[nz, j]
                    ks[j] = start[j] + np.arange(3)
                if len(split) < n_in - 1:      # FMA chains, depth blocks
                    group = np.searchsorted(np.asarray(split), ks,
                                            side="right") % 2
                    rounded = False
                else:
                    pairs = _probe_first_pair(dot, wts, other)
                    kinds = {(k0 % 2, p) for k0, p in pairs.items()}
                    if kinds <= {(0, (0, 2)), (1, (0, 2))}:
                        group, rounded = ks % 2, False     # even / odd sums
                    elif kinds <= {(0, (0, 1)), (1, (1, 2))}:
                        group, rounded = (ks // 2) % 2, True  # rounded pairs
                    else:
                        raise RuntimeError(f"{axis} {n_in}->{n_out}: {kinds}")
                key = f"{axis}_{n_in}_{n_out}_{other}"
                out[key + ".start"] = start
                out[key + ".w"] = wk
                out[key + ".group"] = group.astype(np.int8)
                out[key + ".rounded"] = np.asarray(rounded)
                how = ("rounded pairs" if rounded else "even / odd sums"
                       if len(split) == n_in - 1 else f"depth blocks {split}")
                print(f"xla_resize {key}: {how}", flush=True)
    np.savez_compressed(OUT_XLA_RESIZE, **out)
    tpyr._plans.cache_clear()
    cfg = SlamConfig.tum_rgbd()
    jit_pyr = jax.jit(lambda im: jpyr.build_pyramid(im, 8, 1.2))
    check = {}
    for seed in XLA_RESIZE_CHECK_SCENES:
        scene = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                                    plane_z=3.2 + 0.3 * seed)
        for pose, T in enumerate(loop_trajectory(8)[:2]):
            gray = np.asarray(scene.render_rgbd(T)[0], np.float32)
            ref = [np.asarray(a) for a in jit_pyr(jnp.asarray(gray))]
            got = tpyr.build_pyramid(torch.from_numpy(gray), 8, 1.2)
            for l, (a, b) in enumerate(zip(ref, got)):
                n = int((a != b.numpy()).sum())
                if n:
                    os.remove(OUT_XLA_RESIZE)
                    raise RuntimeError(f"level {l}: {n} pixels differ")
            check[f"{seed}_{pose}.gray_sha256"] = np.asarray(
                hashlib.sha256(gray.tobytes()).hexdigest())
            check[f"{seed}_{pose}.level_sha256"] = np.asarray(
                [hashlib.sha256(a.tobytes()).hexdigest() for a in ref])
    np.savez_compressed(OUT_XLA_RESIZE_CHECK, **check)
    print(f"wrote {OUT_XLA_RESIZE}: "
          f"{os.path.getsize(OUT_XLA_RESIZE) / 1e3:.1f} kB and "
          f"{OUT_XLA_RESIZE_CHECK}", flush=True)


# ---------------------------------------------------------------------------
# the accuracy studies of scripts/ (ab_deviations.py, diag_loop.py,
# diag_loop_alias.py, diag_semopt.py, diag_semopt_ragged.py), their
# reference runs on the CPU
# ---------------------------------------------------------------------------

OUT_STUDIES = os.path.join(HERE, "studies.npz")
OUT_STUDIES_VGA = os.path.join(HERE, "studies_vga.npz")
STUDIES_DIR = os.path.join(HERE, "..", "..", "build", "studies")
STUDY_VARIANTS = ("base", "recency_off", "no_reelect", "scale_cond_on")
# the CPU tests' variant runs (scale 4, strict readback): the first
# VAR_SMALL_END frames of the 120-frame circuit, the port starting from the
# JAX system's state after frame VAR_SMALL_START - 1
VAR_SMALL_START, VAR_SMALL_END = 1, 5
# chip_smoke.py's variant runs: scale 1 (VGA), the script's default
# pipelined readback, the first VAR_VGA_FRAMES frames of the circuit
VAR_VGA_FRAMES = 40
# the VGA variants' pinned one-ulp noise runs (the circuit is chaotic:
# the card's base run parts from the JAX CPU run by 33 mm / 0.84 deg on
# the same keyframes)
VAR_NOISE_RUNS = 8
# the corridor at VGA (diag_loop_alias.py's defaults at --scale 1) and the
# pinned one-ulp noise runs over the frames chip_smoke.py replays
ALIAS_FRAMES = 320
ALIAS_NOISE_RUNS = 3
# the semantic probes: the first SEM_VGA_FRAMES frames of the 40-frame
# make_synth_tum.py directory at SlamConfig.tum_rgbd(); on the CPU the
# object-stability scene (objects_cfg, SEM_SMALL_FRAMES frames)
SEM_VGA_FRAMES = 24
SEM_SMALL_FRAMES = 8
RAGGED_SEED, RAGGED_SHIFT = 11, 2


def study_part_path(part):
    os.makedirs(STUDIES_DIR, exist_ok=True)
    return os.path.join(STUDIES_DIR, part.replace(":", "_") + ".npz")


def plain_state(sys_):
    """A JAX system's whole state after a frame, loop closing off (strict
    readback, sync mapping): system_state without the closer."""
    from object_slam_tpu.slam.map_state import init_map
    assert sys_._fused_pending is None and sys_._async is None
    base = init_map(sys_.cfg.caps, sys_.cfg.objects.history_capacity)
    fr = sys_.last_frame
    st = {f"m.{k}": v for k, v in compact_map(
        {f: np.asarray(getattr(sys_.map, f)) for f in MapState._fields},
        {f: np.asarray(getattr(base, f)) for f in MapState._fields}).items()}
    st.update({f"last.{f}": np.asarray(getattr(fr, f)) for f in FRAME_FIELDS})
    st.update({
        "velocity": np.asarray(sys_.velocity, np.float32),
        "counters": np.asarray([sys_.state, sys_.last_kf_id,
                                sys_.frames_since_kf, sys_.frame_id,
                                getattr(sys_, "_kf_inliers", 0),
                                getattr(sys_, "_last_n_inliers", -1)],
                               np.int64),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "rec_ref": np.asarray([r.ref_kf for r in sys_.trajectory], np.int32),
        "rec_tcr": np.stack([r.Tcr for r in sys_.trajectory]).astype(
            np.float32),
        "rec_tracked": np.asarray([r.tracked for r in sys_.trajectory])})
    return st


def pinned_noise(sys_, seed, pin_frames):
    """One-ulp noise (ulp_noise, seed) in every local-mapping pass's input,
    with the keyframe decisions of every fused resolve pinned to
    pin_frames (run_loop's pin): the reference's own spread on the same
    decisions."""
    ulp_noise(sys_, seed)
    pin = set(int(f) for f in pin_frames)
    resolve_one = sys_._resolve_one

    def resolve(pend, latest):
        p = np.array(np.asarray(pend["packed"]))
        p[49], p[57] = 0.0, float(pend["fid"] in pin)
        return resolve_one(dict(pend, packed=p), latest)
    sys_._resolve_one = resolve


def recording_systems(capture=None, noise=None):
    """A SlamSystem subclass that keeps every instance, the frames a
    keyframe was inserted on, the frames track_rgbd returned (pose, flag)
    and, after frame ``capture``, plain_state and the first local-mapping
    pass from frame ``capture`` + 1 on (its input and output map rows,
    keyframe and schedule); noise (seed, frames): pinned_noise on each
    instance: (class, instances)."""
    from object_slam_tpu.slam.map_state import init_map
    made = []

    class Recorded(SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            if noise is not None:
                pinned_noise(self, *noise)
            self.rec_inserts, self.rec_ret, self.rec_held = [], [], {}
            jit_insert = self._jit_insert

            def insert(m, frame, Tcw, kp_pt, spawn, fid):
                self.rec_inserts.append(int(fid))
                return jit_insert(m, frame, Tcw, kp_pt, spawn, fid)
            self._jit_insert = insert
            if capture is None:
                return
            base = {f: np.asarray(getattr(init_map(
                self.cfg.caps, self.cfg.objects.history_capacity), f))
                for f in MapState._fields}

            def rows(m):
                return compact_map({f: np.asarray(getattr(m, f))
                                    for f in MapState._fields}, base)
            for attr, fast in (("_jit_mapping", False),
                               ("_jit_mapping_fast", True)):
                fn = getattr(self, attr)

                def mapping(m, kf_id, fn=fn, fast=fast):
                    out = fn(m, kf_id)
                    if (self.frame_id > capture
                            and "pass.kf" not in self.rec_held):
                        self.rec_held.update(
                            {f"pass.in.{k}": v for k, v in rows(m).items()})
                        self.rec_held.update(
                            {f"pass.out.{k}": v
                             for k, v in rows(out).items()})
                        self.rec_held["pass.kf"] = np.int32(kf_id)
                        self.rec_held["pass.fast"] = np.bool_(fast)
                    return out
                setattr(self, attr, mapping)

        def track_rgbd(self, *a, **kw):
            f = super().track_rgbd(*a, **kw)
            self.rec_ret.append((np.asarray(f.Tcw, np.float32),
                                 bool(f.pose_ok)))
            if capture is not None and self.frame_id - 1 == capture:
                self.rec_held.update(plain_state(self))
            return f
    return Recorded, made


def record_study_variant(part):
    """part "var_small:<name>" / "var_vga:<name>": ab_deviations.py's
    run_variant for variant <name> on the circuit's first frames (see
    VAR_SMALL_* / VAR_VGA_FRAMES), with the SlamSystem class wrapped: its
    result, every frame's returned pose and flag, the keyframe frames, the
    trajectory records and, for var_small, the state the port starts
    from."""
    import object_slam_tpu.slam.system as jsys
    ab = load_script("ab_deviations")
    kind, name = part.split(":")[:2]
    small = kind == "var_small"
    noise = None
    if kind == "var_vga_noise":
        # part "var_vga_noise:<name>:<k>": the VGA run under one-ulp noise
        # (seed k) with var_vga:<name>'s keyframe decisions pinned (from
        # studies_vga.npz where that part is not under build/studies/)
        main = study_part_path(f"var_vga:{name}")
        pinned = (np.load(main)["insert_frames"] if os.path.exists(main)
                  else np.load(OUT_STUDIES_VGA)[f"var.{name}.insert_frames"])
        noise = (int(part.split(":")[2]), pinned)
    cfg = ab.build_cfg(4 if small else 1)
    if small:
        cfg = cfg.replace(tracking=dataclasses.replace(
            cfg.tracking, pipelined_readback=False))
    from object_slam_tpu.config import MappingConfig
    vcfg = cfg.replace(mapping=dataclasses.replace(
        MappingConfig(), **ab.VARIANTS[name]))
    n = VAR_SMALL_END if small else VAR_VGA_FRAMES
    poses = loop_poses()[:n]
    Recorded, made = recording_systems(
        VAR_SMALL_START - 1 if small else None, noise=noise)
    orig, jsys.SlamSystem = jsys.SlamSystem, Recorded
    try:
        res = ab.run_variant(vcfg, loop_scene(cfg), list(poses))
    finally:
        jsys.SlamSystem = orig
    sys_ = made[-1]
    sys_._resolve_fused_pending()
    out = {"result": np.asarray(json.dumps(res)),
           "ret_tcw": np.stack([t for t, _ in sys_.rec_ret]),
           "ret_ok": np.asarray([ok for _, ok in sys_.rec_ret]),
           "insert_frames": np.asarray(sys_.rec_inserts, np.int32),
           "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
           "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
               np.float32),
           "n_points": np.int32(sys_.n_points),
           "n_keyframes": np.int32(sys_.n_keyframes)}
    out.update({f"state.{k}": v for k, v in sys_.rec_held.items()})
    print(f"{part}: {json.dumps(res)}; keyframes at {sys_.rec_inserts}",
          flush=True)
    np.savez_compressed(study_part_path(part), **out)


def alias_setup():
    """diag_loop_alias.py's corridor at --scale 1 (its defaults otherwise):
    (cfg, scene, Tcw poses)."""
    ab = load_script("ab_deviations")
    al = load_script("diag_loop_alias")
    cfg = ab.build_cfg(1)
    scene = al.build_alias_scene(cfg, period=3.2, n_periods=16, seed=7)
    poses = np.stack([np.linalg.inv(T) for T in
                      al.straight_path(ALIAS_FRAMES, step=0.2)])
    return cfg, scene, poses


def record_study_alias(part):
    """part "alias:main": the corridor through run_loop (objects off,
    track_rgbd, the default pipelined readback: diag_loop_alias.run_alias's
    calls) over ALIAS_FRAMES frames, with the inputs of the first closure
    the pre-gate refuses and of the first the post-gates refuse (map rows,
    q, l, T12, s12). "alias:pin<k>": one-ulp noise (seed k) with main's
    keyframe decisions and Sim3 draws pinned, over alias_depth's
    frames."""
    from object_slam_tpu.loop import loop_closing as jloop
    from object_slam_tpu.slam.map_state import init_map
    cfg, scene, poses = alias_setup()
    kind = part.split(":")[1]
    inputs, out_extra = {}, {}
    orig = jloop.LoopCloser._correct_loop

    def correct_loop(lc, m, q, l, T12, s12):
        n_ev = len(lc.events)
        arrays = {f: np.asarray(getattr(m, f)) for f in MapState._fields}
        res = orig(lc, m, q, l, T12, s12)
        ev = lc.events[n_ev] if len(lc.events) > n_ev else None
        if ev is not None and not ev["accepted"]:
            tag = "pre" if ev.get("pre_gated") else "post"
            if tag not in inputs:
                base = init_map(lc.cfg.caps, lc.cfg.objects.history_capacity,
                                n_bow_words=lc.vocab.n_words)
                rows = compact_map(arrays, {f: np.asarray(getattr(base, f))
                                            for f in MapState._fields})
                inputs[tag] = True
                out_extra.update({f"{tag}.m.{k}": v for k, v in rows.items()})
                out_extra.update({
                    f"{tag}.q": np.int32(q), f"{tag}.l": np.int32(l),
                    f"{tag}.T12": np.asarray(T12, np.float32),
                    f"{tag}.s12": np.float32(s12),
                    f"{tag}.event": np.asarray(json.dumps(ev)),
                    f"{tag}.n_event": np.int32(n_ev)})
        return res
    jloop.LoopCloser._correct_loop = correct_loop
    try:
        if kind == "main":
            res, sys_, _ = run_loop(cfg, scene, poses, objects=False,
                                    blob=False, tag="alias corridor")
        else:
            k = int(kind[len("pin"):])
            main = np.load(study_part_path("alias:main"))
            upto = alias_depth(main)
            res, sys_, _ = run_loop(
                cfg, scene, poses[:upto], objects=False, blob=False,
                noise_seed=k,
                pin=(main["insert_frames"], main["sim3_sets"]),
                tag=f"alias corridor pinned ulp noise {k}")
    finally:
        jloop.LoopCloser._correct_loop = orig
    # the script's own summary (run_alias): centre errors of the tracked
    # records after the flush
    errs = []
    for rec, T in zip(sys_.trajectory, poses):
        if rec.tracked:
            C = -np.asarray(rec.Tcw)[:3, :3].T @ np.asarray(rec.Tcw)[:3, 3]
            errs.append(np.linalg.norm(C - np.linalg.inv(T)[:3, 3]))
    res["ate_rmse_mm"] = np.float64(
        np.sqrt(np.mean(np.square(errs))) * 1e3 if errs else -1.0)
    res["keyframes"] = np.int32(sys_.n_keyframes)
    res.update(out_extra)
    np.savez_compressed(study_part_path(part), **res)
    print(f"{part}: events {str(res['events'])}", flush=True)


def alias_depth(main):
    """The corridor's frames chip_smoke.py replays: through two frames
    after the frame whose keyframe made the first rejection by the
    pre-gate, or by the post-gates where one comes later (the JAX run at
    VGA makes none)."""
    ev = json.loads(str(main["events"]))
    frames = alias_event_frames(main)
    kinds = [bool(e.get("pre_gated")) for e in ev]
    if True not in kinds or any(e["accepted"] for e in ev):
        raise SystemExit(f"alias corridor: events {ev}; a pre-gated "
                         f"rejection and no accepted closure are needed")
    last = frames[kinds.index(True)]
    post = [f for f, e in zip(frames, ev) if not e.get("pre_gated")]
    if post:
        last = max(last, post[0])
    return min(last + 3, len(main["tracked"]))


def record_study_alias_postgate():
    """The post-gates on the corridor's first pre-gated candidate: the JAX
    closer's _correct_loop on alias:main's recorded input (map rows, q, l,
    T12, s12) with the pre-gate's absolute limits lifted, so the full
    speculative correction runs (the candidate's relative pre-gate tests
    do not fire; checked) and the bend-budget and quality gates decide,
    as in results/loop_alias_r5_postgates.json. Writes the event."""
    from object_slam_tpu.slam.map_state import init_map
    cfg, _, _ = alias_setup()
    main = np.load(study_part_path("alias:main"))
    ev_pre = json.loads(str(main["pre.event"]))
    if (ev_pre["pred_bend_deg"] > 4.0 * ev_pre["budget_deg"]
            or ev_pre["pred_bend_frac"] > 4.0 * ev_pre["budget_frac"]):
        raise SystemExit(f"alias postgate: a relative pre-gate test fires "
                         f"on {ev_pre}")
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True)
    lc = sys_.loop_closer
    lc.cfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, pregate_bend_deg_abs=float("inf"),
        pregate_bend_frac_abs=float("inf")))
    base = {f: np.asarray(getattr(init_map(
        cfg.caps, cfg.objects.history_capacity,
        n_bow_words=lc.vocab.n_words), f)) for f in MapState._fields}
    rows = {k[len("pre.m."):]: main[k] for k in main.files
            if k.startswith("pre.m.")}
    full = {}
    for f, b in base.items():
        v = rows[f]
        if v.ndim == 0 or v.shape[0] == b.shape[0]:
            full[f] = v
        else:
            full[f] = b.copy()
            full[f][:v.shape[0]] = v
    m = MapState(**{f: jnp.asarray(v) for f, v in full.items()})
    _, accepted = lc._correct_loop(m, int(main["pre.q"]),
                                   int(main["pre.l"]),
                                   jnp.asarray(main["pre.T12"]),
                                   float(main["pre.s12"]))
    ev = lc.events[-1]
    print(f"alias postgate: {json.dumps(ev)}", flush=True)
    if accepted or ev.get("pre_gated"):
        raise SystemExit("alias postgate: the post-gates must reject")
    np.savez_compressed(study_part_path("alias:postgate"),
                        event=np.asarray(json.dumps(ev)))


def alias_event_frames(main):
    """The frame of each closure event of a run_loop record: the first
    on_keyframe call (frame, kf, closed) on the event's query keyframe
    after the previous event's frame."""
    okf = main["on_keyframe"]
    frames, at = [], -1
    for e in json.loads(str(main["events"])):
        rows = okf[(okf[:, 1] == e["q"]) & (okf[:, 0] > at)]
        at = int(rows[0, 0])
        frames.append(at)
    return frames


def probe_kf_errors(m, kf_frame, poses):
    """diag_loop.py's kf_pose_errors: each valid keyframe's centre error
    against its frame's ground truth, mm."""
    errs = {}
    kv = np.asarray(m.kf_valid)
    kp = np.asarray(m.kf_pose)
    for k, fi in kf_frame.items():
        if k < len(kv) and kv[k]:
            errs[k] = float(np.linalg.norm(
                np.linalg.inv(kp[k])[:3, 3]
                - np.linalg.inv(poses[fi])[:3, 3]) * 1e3)
    return errs


def record_study_loop_probe():
    """diag_loop.py's closure probe (its _correct_loop instrumentation and
    keyframe-to-frame map, verbatim) on loop_small.npz's circuit (the
    script's scene at --scale 2, strict readback): every closure's event
    with the probe's fields, the per-keyframe errors before and after, and
    the keyframe-to-frame map as it stood after frame loop_small "start",
    where the port's replay begins. Refuses to write unless the run's
    closer events and keyframe frames are loop_small.npz's."""
    tap_sampler()
    del _SETS[:]
    fx = np.load(OUT_LOOP_SMALL)
    start = int(fx["start"])
    cfg = loop_small_cfg()
    scene = loop_scene(cfg)
    poses = loop_poses(LOOP_SMALL_FRAMES)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True)
    lc = sys_.loop_closer
    orig_correct = lc._correct_loop
    events, errs_log, kf_frame, current_frame = [], [], {}, [0]

    def instrumented(m, q, l, T12, s12):
        q_fi = kf_frame.get(int(q), current_frame[0])
        kf_frame[int(q)] = q_fi
        Tq = np.asarray(m.kf_pose[q])
        Tl = np.asarray(m.kf_pose[l])
        gt_q, gt_l = poses[q_fi], poses[kf_frame[int(l)]]
        ev = {"q": int(q), "l": int(l), "s12": float(s12)}
        T12_gt = gt_q @ np.linalg.inv(gt_l)
        dT = np.asarray(T12) @ np.linalg.inv(T12_gt)
        ev["sim3_trans_err_mm"] = float(np.linalg.norm(dT[:3, 3]) * 1e3)
        ev["sim3_rot_err_deg"] = float(np.degrees(np.arccos(
            np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))))
        T12_est = Tq @ np.linalg.inv(Tl)
        dD = T12_est @ np.linalg.inv(T12_gt)
        ev["drift_trans_mm"] = float(np.linalg.norm(dD[:3, 3]) * 1e3)
        ev["drift_rot_deg"] = float(np.degrees(np.arccos(
            np.clip((np.trace(dD[:3, :3]) - 1) / 2, -1, 1))))
        events.append(ev)
        before = probe_kf_errors(m, kf_frame, poses)
        m2, accepted = orig_correct(m, q, l, T12, s12)
        ev["accepted"] = bool(accepted)
        errs_log.append((before, probe_kf_errors(m2, kf_frame, poses)))
        return m2, accepted
    lc._correct_loop = instrumented
    held = {}
    for i, T in enumerate(poses):
        current_frame[0] = i
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(jnp.asarray(np.asarray(gray, np.float32)),
                        jnp.asarray(np.asarray(depth, np.float32)),
                        jnp.asarray(np.asarray(rgb, np.float32)), None,
                        timestamp=i / 30.0)
        if sys_.last_kf_id >= 0 and sys_.last_kf_id not in kf_frame:
            kf_frame[sys_.last_kf_id] = i
        if i == start:
            held["kf_frame"] = np.asarray(sorted(kf_frame.items()),
                                          np.int32).reshape(-1, 2)
    jax.effects_barrier()
    want = [(e["q"], e["l"], e["accepted"])
            for e in json.loads(str(fx["events"]))]
    got = [(e["q"], e["l"], e["accepted"]) for e in events]
    sets = [s for k, s in _SETS if k == 3]
    same_sets = (len(sets) == len(fx["sim3_sets"]) and all(
        np.array_equal(a, b) for a, b in zip(sets, fx["sim3_sets"])))
    if got != want or not same_sets:
        raise SystemExit(f"loop probe: closures {got} against loop_small's "
                         f"{want}, Sim3 draws equal: {same_sets}")
    print(f"loop probe: {json.dumps(events)}", flush=True)
    out = {"events": np.asarray(json.dumps(events)),
           "kf_errors": np.asarray(json.dumps(
               [[{str(k): v for k, v in d.items()} for d in pair]
                for pair in errs_log])),
           "kf_frame": held["kf_frame"]}
    np.savez_compressed(study_part_path("loop_probe"), **out)


class StudyMeta:
    """A TUM frame's timestamp, as the semantic probes read it."""

    def __init__(self, timestamp):
        self.timestamp = timestamp


def sem_small_inputs():
    """The semantic probes' CPU input: the object-stability scene
    (objects_cfg) rendered into the probes' frame layout (u8 rgb, metric
    float32 depth, the detections with bit-packed masks), the timestamps
    and the ground-truth centres by timestamp."""
    from object_slam_tpu.semantic.object2d import pack_mask_bits
    cfg = objects_cfg()
    scene, _ = object_scene(cfg)
    poses = orbit_poses(SEM_SMALL_FRAMES, step=0.008)
    frames, metas, gt = [], [], {}
    for i, T in enumerate(poses):
        _, depth, rgb, sem = scene.render_rgbd(T)
        sa = scene.sem_arrays(sem, cfg.semantic.max_instances)
        frames.append((np.clip(rgb, 0, 255).astype(np.uint8),
                       np.asarray(depth, np.float32),
                       (np.asarray(pack_mask_bits(jnp.asarray(sa[0]))),)
                       + tuple(np.asarray(a) for a in sa[1:])))
        metas.append(StudyMeta(i / 30.0))
        gt[round(i / 30.0, 4)] = np.linalg.inv(T)[:3, 3]
    return cfg, frames, metas, gt


def sem_vga_inputs():
    """The first SEM_VGA_FRAMES frames of scripts/make_synth_tum.py's
    40-frame directory (written under build/studies/tum) through
    run_experiments.load_tum_frames, at SlamConfig.tum_rgbd()."""
    from object_slam_tpu.datasets import tum
    import subprocess
    seq = os.path.join(STUDIES_DIR, "tum")
    if not os.path.isfile(os.path.join(seq, "groundtruth.txt")):
        subprocess.run([sys.executable, os.path.join(
            HERE, "..", "..", "scripts", "make_synth_tum.py"), "--out", seq,
            "--frames", str(EXP_TUM_FRAMES)], check=True)
    ex = load_script("run_experiments")
    cfg = SlamConfig.tum_rgbd()
    metas, frames = ex.load_tum_frames(seq, cfg, SEM_VGA_FRAMES)
    ts_gt, pos_gt, _ = tum.load_groundtruth(seq)
    gt = {round(t, 4): p for t, p in zip(ts_gt, pos_gt)}
    return cfg, frames, metas, gt, seq


def run_semopt_probe(cfg, frames, metas, gt):
    """diag_semopt.py's loop: the staged path (fused=False, strict
    readback), objects on, sync; each frame's pose before the semantic
    refinement (SlamSystem._last_presem_Tcw) and after it, and the
    script's summary."""
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, fused=False, pipelined_readback=False))
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=False)
    rows, pre_tcw, post_tcw, deltas = [], [], [], []
    for i, (rgb8, d16, sem) in enumerate(frames):
        f = sys_.track_rgbd(None, d16, rgb8, sem,
                            timestamp=metas[i].timestamp)
        gt_p = gt.get(round(metas[i].timestamp, 4))
        pre = getattr(sys_, "_last_presem_Tcw", None)
        if gt_p is None or pre is None:
            continue
        c_pre = np.linalg.inv(np.asarray(pre))[:3, 3]
        c_post = np.linalg.inv(np.asarray(f.Tcw))[:3, 3]
        deltas.append((i, float(np.linalg.norm(c_pre - gt_p)),
                       float(np.linalg.norm(c_post - gt_p))))
        pre_tcw.append(np.asarray(pre, np.float32))
        post_tcw.append(np.asarray(f.Tcw, np.float32))
    d = np.asarray([(a, b) for _, a, b in deltas])
    if len(d) == 0:
        summary = {"n_semopt_frames": 0}
    else:
        diff_mm = (d[:, 1] - d[:, 0]) * 1000
        summary = {
            "n_semopt_frames": len(d),
            "mean_pre_mm": float(d[:, 0].mean() * 1000),
            "mean_post_mm": float(d[:, 1].mean() * 1000),
            "median_shift_mm": float(np.median(diff_mm)),
            "mean_shift_mm": float(diff_mm.mean()),
            "p90_shift_mm": float(np.percentile(diff_mm, 90)),
            "frames_worse": int((diff_mm > 0.1).sum()),
            "frames_better": int((diff_mm < -0.1).sum()),
            "worst_shift_mm": float(diff_mm.max()),
        }
    m = sys_.map
    labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
    lab, cnt = np.unique(labels, return_counts=True)
    out = {"summary": np.asarray(json.dumps(summary)),
           "frames": np.asarray([i for i, _, _ in deltas], np.int32),
           "pre_tcw": (np.stack(pre_tcw) if pre_tcw
                       else np.zeros((0, 4, 4), np.float32)),
           "post_tcw": (np.stack(post_tcw) if post_tcw
                        else np.zeros((0, 4, 4), np.float32)),
           "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
           "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
               np.float32),
           "census_labels": lab.astype(np.int32),
           "census_counts": cnt.astype(np.int32),
           "semantic_constraints": np.int64(
               sys_.objects.semantic_constraints)}
    print(f"semopt probe: {json.dumps(summary)} over frames "
          f"{out['frames'].tolist()}", flush=True)
    return out


def degrade_ragged(cfg, frames, seed=RAGGED_SEED, shift=RAGGED_SHIFT,
                   holes=0.0):
    """diag_semopt_ragged.py's mask degradation, verbatim."""
    from object_slam_tpu.datasets.synthetic import degrade_masks
    from object_slam_tpu.semantic.object2d import (pack_mask_bits,
                                                   unpack_mask_bits)
    rng = np.random.RandomState(seed)
    ragged = []
    for rgb8, d16, sem in frames:
        if sem is None:
            ragged.append((rgb8, d16, None))
            continue
        packed, labels, probs, bboxes, valid = sem
        M = np.asarray(unpack_mask_bits(packed, cfg.camera.width))
        Mn, Bn = degrade_masks(M, np.asarray(valid), rng, shift=shift,
                               hole_frac=holes)
        ragged.append((rgb8, d16, (np.asarray(pack_mask_bits(Mn)), labels,
                                   probs, np.asarray(Bn, np.float32),
                                   valid)))
    return ragged


def run_ragged_arms(cfg, frames, metas, seq):
    """diag_semopt_ragged.py's two arms (semopt_enabled on / off, objects
    on, sync) on the degraded frames through
    run_experiments.run_tum_variant, the SlamSystem class wrapped (its
    12-frame prewarm systems are thrown away and left out): each arm's
    result without its timings, records, keyframe frames and census; and
    the degraded masks."""
    import object_slam_tpu.slam.system as jsys
    ex = load_script("run_experiments")
    ragged = degrade_ragged(cfg, frames)
    cfg_semoff = cfg.replace(objects=dataclasses.replace(
        cfg.objects, semopt_enabled=False))
    out = {"ragged_masks": np.concatenate(
        [r[2][0].reshape(-1) for r in ragged if r[2] is not None])}
    for name, vcfg in (("ragged_semopt_on", cfg),
                       ("ragged_semopt_off", cfg_semoff)):
        Recorded, made = recording_systems()
        orig, jsys.SlamSystem = jsys.SlamSystem, Recorded
        try:
            res = ex.run_tum_variant(seq, vcfg, ragged, metas,
                                     enable_objects=True, async_mapping=False)
        finally:
            jsys.SlamSystem = orig
        sys_ = made[-1]
        for k in ("fps", "median_track_ms"):
            res.pop(k, None)
        m = sys_.map
        labels = np.asarray(m.obj_label)[np.asarray(m.obj_valid)]
        lab, cnt = np.unique(labels, return_counts=True)
        out.update({
            f"{name}.result": np.asarray(json.dumps(res)),
            f"{name}.tracked": np.asarray([r.tracked
                                           for r in sys_.trajectory]),
            f"{name}.rec_tcw": np.stack(
                [r.Tcw for r in sys_.trajectory]).astype(np.float32),
            f"{name}.insert_frames": np.asarray(sys_.rec_inserts, np.int32),
            f"{name}.census_labels": lab.astype(np.int32),
            f"{name}.census_counts": cnt.astype(np.int32)})
        print(f"{name}: {json.dumps(res)}", flush=True)
    return out


def record_study_semantic(part):
    """part "sem_small" / "sem_vga": the semantic refinement probe
    (run_semopt_probe) and the ragged-mask A/B (run_ragged_arms) on
    sem_small_inputs / sem_vga_inputs."""
    if part == "sem_small":
        cfg, frames, metas, gt = sem_small_inputs()
        seq = os.path.join(STUDIES_DIR, "no_sequence")
    else:
        cfg, frames, metas, gt, seq = sem_vga_inputs()
    out = {f"semopt.{k}": v
           for k, v in run_semopt_probe(cfg, frames, metas, gt).items()}
    out.update({f"ragged.{k}": v for k, v in run_ragged_arms(
        cfg, frames, metas, seq).items()})
    np.savez_compressed(study_part_path(part), **out)


def merge_studies():
    """The parts under build/studies/ -> studies.npz (the CPU tests: the
    scale-4 variants, the corridor's recorded candidate inputs, the
    closure probe, the semantic probes on the object-stability scene) and
    studies_vga.npz (chip_smoke.py: the VGA variants, the corridor's run
    and its pinned noise runs, the semantic probes at tum_rgbd)."""
    small, vga = {}, {}
    for name in STUDY_VARIANTS:
        for kind, out in (("var_small", small), ("var_vga", vga)):
            d = np.load(study_part_path(f"{kind}:{name}"))
            out.update({f"var.{name}.{k}": d[k] for k in d.files})
    for name in STUDY_VARIANTS:
        n = 0
        for k in range(VAR_NOISE_RUNS):
            p = study_part_path(f"var_vga_noise:{name}:{k}")
            if not os.path.exists(p):
                continue
            d = np.load(p)
            for f in ("result", "tracked", "rec_tcw", "insert_frames"):
                vga[f"var.{name}.noise.{n}.{f}"] = d[f]
            n += 1
        vga[f"var.{name}.n_noise"] = np.int32(n)
    main = np.load(study_part_path("alias:main"))
    depth = alias_depth(main)
    small.update({f"alias.{k}": main[k] for k in main.files
                  if k.startswith(("pre.", "post."))})
    small["alias.events"] = main["events"]
    small["alias.postgate.event"] = np.load(
        study_part_path("alias:postgate"))["event"]
    keep = ("tracked", "rec_tcw", "insert_frames", "gray_sum", "events",
            "on_keyframe", "loops_closed", "loops_rejected", "sim3_sets",
            "pnp_sets", "staged_frames", "reloc_frames", "reloc_ok",
            "ate_rmse_mm", "keyframes", "seconds")
    vga.update({f"alias.{k}": main[k] for k in keep})
    vga["alias.event_frames"] = np.asarray(alias_event_frames(main),
                                           np.int32)
    vga["alias.depth"] = np.int32(depth)
    n = 0
    for k in range(ALIAS_NOISE_RUNS):
        p = study_part_path(f"alias:pin{k}")
        if not os.path.exists(p):
            continue
        d = np.load(p)
        ev = [e for e in json.loads(str(d["events"]))]
        vga[f"alias.noise.{n}.events"] = d["events"]
        vga[f"alias.noise.{n}.tracked"] = d["tracked"]
        vga[f"alias.noise.{n}.rec_tcw"] = d["rec_tcw"]
        print(f"alias pinned noise {k}: {len(ev)} events", flush=True)
        n += 1
    vga["alias.n_noise"] = np.int32(n)
    d = np.load(study_part_path("loop_probe"))
    small.update({f"probe.{k}": d[k] for k in d.files})
    for part, out in (("sem_small", small), ("sem_vga", vga)):
        d = np.load(study_part_path(part))
        out.update({k: d[k] for k in d.files})
    vga["sem.frames"] = np.int32(SEM_VGA_FRAMES)
    for path, out in ((OUT_STUDIES, small), (OUT_STUDIES_VGA, vga)):
        np.savez_compressed(path, **out)
        print(f"wrote {path}: {os.path.getsize(path) / 1e3:.1f} kB",
              flush=True)


def merge_var_noise():
    """studies_vga.npz's variants gain the var_vga_noise parts under
    build/studies/ for the seeds past the runs they hold (seed k is noise
    run k); the rest of the file stays as it is."""
    vga = dict(np.load(OUT_STUDIES_VGA))
    for name in STUDY_VARIANTS:
        n = int(vga[f"var.{name}.n_noise"])
        for k in range(n, VAR_NOISE_RUNS):
            p = study_part_path(f"var_vga_noise:{name}:{k}")
            if not os.path.exists(p):
                break
            d = np.load(p)
            for f in ("result", "tracked", "rec_tcw", "insert_frames"):
                vga[f"var.{name}.noise.{n}.{f}"] = d[f]
            n += 1
        vga[f"var.{name}.n_noise"] = np.int32(n)
        print(f"{name}: {n} pinned noise runs", flush=True)
    np.savez_compressed(OUT_STUDIES_VGA, **vga)
    print(f"wrote {OUT_STUDIES_VGA}: "
          f"{os.path.getsize(OUT_STUDIES_VGA) / 1e3:.1f} kB", flush=True)


def record_studies(part):
    """make_reference.py studies:<part> (one part, for parallel runs) or
    studies (every part in turn, then merge); studies:var_noise_merge
    adds the variants' noise parts to an existing studies_vga.npz."""
    if part == "var_noise_merge":
        merge_var_noise()
    elif part.startswith(("var_small:", "var_vga:", "var_vga_noise:")):
        record_study_variant(part)
    elif part == "alias:postgate":
        record_study_alias_postgate()
    elif part.startswith("alias:"):
        record_study_alias(part)
    elif part == "loop_probe":
        record_study_loop_probe()
    elif part in ("sem_small", "sem_vga"):
        record_study_semantic(part)
    elif part == "merge":
        merge_studies()
    else:
        raise SystemExit(f"studies: unknown part {part}")


STUDY_PARTS = ([f"{k}:{n}" for k in ("var_small", "var_vga")
                for n in STUDY_VARIANTS]
               + [f"var_vga_noise:{n}:{k}" for n in STUDY_VARIANTS
                  for k in range(VAR_NOISE_RUNS)]
               + ["alias:main", "alias:postgate"]
               + [f"alias:pin{k}" for k in range(ALIAS_NOISE_RUNS)]
               + ["loop_probe", "sem_small", "sem_vga", "merge"])


# ---------------------------------------------------------------------------
# the tracking-retention probes of scripts/ (diag_poseopt.py,
# diag_retention.py with its dumps, diag_replay.py, diag_gnsteps.py;
# diag_kitti_retention.py, diag_kitti.py, diag_local_recovery.py,
# diag_motion_chain.py): their loops as the scripts run them, every number
# kept at full precision (the scripts print them rounded)
# ---------------------------------------------------------------------------

OUT_PROBES = os.path.join(HERE, "probes.npz")
OUT_PROBES_VGA = os.path.join(HERE, "probes_vga.npz")
PROBES_DIR = os.path.join(HERE, "..", "..", "build", "probes")
# the CPU tests' sizes: small_cfg's TUM orbit and stereo_cfg's street
# canyon (a PROBE_KITTI_SMALL-frame drive); chip_smoke.py's: tum_rgbd()'s
# 30-frame orbit (diag_retention.py's default) and the first
# PROBE_KITTI_VGA frames of the 24-frame KITTI drive its second process
# renders
PROBE_RET_SMALL, PROBE_RET_VGA = 12, 30
PROBE_LOC_SMALL, PROBE_LOC_VGA = 8, 12
PROBE_KITTI_SMALL, PROBE_KITTI_VGA, PROBE_KITTI_DRIVE = 10, 12, 24
PROBE_NOISE = {"small": 4, "vga": 6}
PROBE_LOC_NOISE = 3
PROBE_POSE_NOISE = 8
PROBE_KITTI_KINDS = ("kret", "kitti", "lrec", "mchain")


def probe_path(part):
    os.makedirs(PROBES_DIR, exist_ok=True)
    return os.path.join(PROBES_DIR, part.replace(":", "_") + ".npz")


def level_noise(seed):
    """Every pyramid level past the first times (1 + u), u uniform in
    +-6e-8 (at most one float32 ulp; a fixed field per level, drawn from
    ``seed``): the reference's frame build under another rounding of its
    resize, as the card's matrix products round it. Patches the module
    function before any extractor traces it."""
    import object_slam_tpu.features.pyramid as jpyr
    orig = jpyr.build_pyramid

    def noisy(img, n_levels, scale):
        levels = orig(img, n_levels, scale)
        out = [levels[0]]
        for l, x in enumerate(levels[1:], 1):
            u = np.random.RandomState(seed * 64 + l).uniform(
                -6e-8, 6e-8, x.shape).astype(np.float32)
            out.append(x * (np.float32(1.0) + jnp.asarray(u)))
        return out
    jpyr.build_pyramid = noisy


def probe_tum_cfg(size):
    return small_cfg() if size == "small" else SlamConfig.tum_rgbd()


def pose_probe_rows(uv_noise_seed=None):
    """diag_poseopt.py's 18 rows (its scene, its RandomState(0) stream),
    at full precision: (n_valid, [18, 4] dt_mm, dr_deg, err_mm, n_inl).
    uv_noise_seed: every pixel coordinate moved one float32 ulp up, down
    or not (RandomState(seed)), after the scene's draws."""
    from object_slam_tpu.solvers.pose_opt import PoseObs, pose_optimize
    cfg = SlamConfig.tum_rgbd()
    K = Intrinsics.from_config(cfg.camera)
    rng = np.random.RandomState(0)
    N = 500
    pw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(3.5, 4.5, N)], -1).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    pc = pw
    u = K.fx * pc[:, 0] / pc[:, 2] + K.cx
    v = K.fy * pc[:, 1] / pc[:, 2] + K.cy
    ur = u - K.bf / pc[:, 2]
    uv = np.stack([u, v], -1)
    levels = np.minimum((rng.geometric(0.45, N) - 1), 7)
    sf = 1.2 ** levels
    uv = uv + rng.randn(N, 2) * 0.3 * sf[:, None]
    inv_sigma2 = (1.0 / (sf * sf)).astype(np.float32)
    inb = (u >= 0) & (u < K.width) & (v >= 0) & (v < K.height)
    uv32 = np.asarray(jnp.asarray(uv))
    if uv_noise_seed is not None:
        step = np.random.RandomState(uv_noise_seed).randint(-1, 2, uv.shape)
        uv32 = np.where(step > 0, np.nextafter(uv32, np.float32(np.inf)),
                        np.where(step < 0, np.nextafter(
                            uv32, np.float32(-np.inf)), uv32))
    obs = PoseObs(uv=jnp.asarray(uv32), ur=jnp.asarray(ur),
                  pw=jnp.asarray(pw), inv_sigma2=jnp.asarray(inv_sigma2),
                  valid=jnp.asarray(inb))
    popt = jax.jit(lambda T0: pose_optimize(K, T0, obs))
    rows = []
    for dt in [0.005, 0.01, 0.03, 0.1, 0.3, 1.0]:
        for dr_deg in [0.0, 0.5, 2.0]:
            T0 = np.eye(4, dtype=np.float32)
            d = rng.randn(3)
            T0[:3, 3] = dt * d / np.linalg.norm(d)
            th = np.deg2rad(dr_deg)
            c, s = np.cos(th), np.sin(th)
            T0[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                  np.float32)
            Tcw, inl, n_inl = popt(jnp.asarray(T0))
            err = np.linalg.norm(np.asarray(Tcw)[:3, 3] - T_gt[:3, 3]) * 1000
            rows.append([dt * 1000, dr_deg, err, int(n_inl)])
    return int(inb.sum()), np.asarray(rows, np.float64)


def record_probe_pose():
    n_valid, rows = pose_probe_rows()
    out = {"pose.n_valid": np.int64(n_valid), "pose.rows": rows}
    for k in range(PROBE_POSE_NOISE):
        out[f"pose.noise.{k}.rows"] = pose_probe_rows(k)[1]
    np.savez_compressed(probe_path("pose"), **out)


def retention_dump(frame, dbg, m, T_gt, T_pred):
    """diag_retention.py's OSLAM_DUMP arrays for one frame (T_pred: the
    staged path's, else the prediction the fused program made)."""
    return dict(uv=np.asarray(frame.uv), ur=np.asarray(frame.ur),
                level=np.asarray(frame.level),
                valid=np.asarray(frame.valid),
                depth=np.asarray(frame.depth),
                kp_pt_motion=np.asarray(dbg["tr_motion"].kp_pt_all),
                kp_pt_local=np.asarray(dbg["tr_local"].kp_pt_all),
                T_pred=np.asarray(T_pred),
                Tcw_motion=np.asarray(dbg["tr_motion"].Tcw),
                Tcw_local=np.asarray(dbg["tr_local"].Tcw),
                pt_xyz=np.asarray(m.pt_xyz), pt_valid=np.asarray(m.pt_valid),
                T_gt=T_gt)


def jax_retention(cfg, n_frames, loc_only=False, noise=None, dump_all=False):
    """diag_retention.py's loop (orbit, room scene seed 3, objects off)
    on the reference at full precision: (per-frame records, summary,
    dumps {frame: arrays}, keyframe frames). noise (seed, pinned
    keyframe frames): level_noise and pinned_noise. A frame is dumped
    where the script dumps (error past 20 mm), and every frame with
    dump_all."""
    from object_slam_tpu.datasets.synthetic import orbit_poses as jorbit
    if noise is not None:
        level_noise(noise[0])
    scene = SyntheticScene.make(cfg, seed=3, n_objects=2, plane_z=4.0,
                                room=True)
    poses = jorbit(n_frames, radius=0.4, step=0.03)
    Recorded, _ = recording_systems(noise=noise)
    sys_ = Recorded(cfg, enable_objects=False)
    recs, errs, dumps = [], [], {}
    for i, T in enumerate(poses):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        if loc_only and sys_.state == 1:
            sys_.enable_mapping = False
        T_fused = (np.asarray(sys_.velocity) @ np.asarray(
            sys_.last_frame.Tcw) if sys_.last_frame is not None else None)
        frame = sys_.track_rgbd(gray, depth, rgb, timestamp=i / 30.0)
        Tcw = np.asarray(frame.Tcw)
        err = np.linalg.norm(Tcw[:3, 3] - T[:3, 3])
        dR = Tcw[:3, :3] @ T[:3, :3].T
        rot_deg = np.degrees(np.arccos(
            np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        C_est = -Tcw[:3, :3].T @ Tcw[:3, 3]
        C_gt = -T[:3, :3].T @ T[:3, 3]
        dC = T[:3, :3] @ (C_est - C_gt)
        errs.append(err)
        rec = sys_.trajectory[-1]
        # the script reads the map before its printed line's n_keyframes
        # folds in the lagged readback (which may insert a keyframe)
        r = {"f": i, "tracked": int(rec.tracked), "err_mm": err * 1000,
             "rot_deg": float(rot_deg), "dC_mm": (dC * 1000).tolist(),
             "motion": None, "local": None, "map3d": None, "far": 0,
             "dumped": False}
        dbg = getattr(sys_, "debug_last", None)
        if dbg is not None and i > 0:
            for tag in ("tr_motion", "tr_local"):
                tr = dbg[tag]
                kp_pt = np.asarray(tr.kp_pt)
                sel = kp_pt >= 0
                if sel.sum() == 0:
                    r[tag[3:]] = {"n": 0, "wrong": None, "err_mm": None}
                    continue
                pw = np.asarray(sys_.map.pt_xyz)[kp_pt[sel]]
                pc = (T[:3, :3] @ pw.T).T + T[:3, 3]
                z = np.maximum(pc[:, 2], 1e-6)
                u = cfg.camera.fx * pc[:, 0] / z + cfg.camera.cx
                v = cfg.camera.fy * pc[:, 1] / z + cfg.camera.cy
                kp_uv = np.asarray(frame.uv)[sel]
                d = np.hypot(u - kp_uv[:, 0], v - kp_uv[:, 1])
                terr = np.linalg.norm(
                    np.asarray(tr.Tcw)[:3, 3] - T[:3, 3]) * 1000
                r[tag[3:]] = {"n": int(sel.sum()),
                              "wrong": float((d > 3).mean() * 100),
                              "err_mm": float(terr)}
            kp_pt = np.asarray(dbg["tr_local"].kp_pt)
            fd = np.asarray(frame.depth)
            sel = (kp_pt >= 0) & (fd > 0)
            if sel.sum() > 0:
                uvn = np.asarray(frame.uv)[sel]
                z = fd[sel]
                pc_gt = np.stack(
                    [(uvn[:, 0] - cfg.camera.cx) / cfg.camera.fx * z,
                     (uvn[:, 1] - cfg.camera.cy) / cfg.camera.fy * z, z], -1)
                Twc = np.linalg.inv(T)
                pw_gt = pc_gt @ Twc[:3, :3].T + Twc[:3, 3]
                e3d = np.linalg.norm(
                    np.asarray(sys_.map.pt_xyz)[kp_pt[sel]] - pw_gt, axis=1)
                r["map3d"] = {"med_mm": float(np.median(e3d) * 1000),
                              "p90_mm": float(np.percentile(e3d, 90) * 1000)}
                pv = np.asarray(sys_.map.pt_valid)
                px = np.asarray(sys_.map.pt_xyz)
                r["far"] = int((pv & (np.linalg.norm(px, axis=1)
                                      > 20.0)).sum())
            if err > 0.02 or dump_all:
                T_pred = dbg["T_pred"] if "T_pred" in dbg else T_fused
                dumps[i] = retention_dump(frame, dbg, sys_.map, T, T_pred)
                r["dumped"] = bool(err > 0.02)
            sys_.debug_last = None
        r["state"] = int(sys_.state)
        r["kfs"] = int(sys_.n_keyframes)
        r["pts"] = int(sys_.n_points)
        recs.append(r)
        print(f"retention f={i} err={err * 1000:.1f}mm kfs={r['kfs']} "
              f"pts={r['pts']}", flush=True)
    errs = np.asarray(errs)
    n_ok = sum(1 for rr in sys_.trajectory if rr.tracked)
    summary = {"tracked": n_ok, "frames": len(poses),
               "ate_raw_mm": float(np.sqrt(np.mean(errs ** 2)) * 1000),
               "max_mm": float(errs.max() * 1000)}
    return recs, summary, dumps, sorted(set(sys_.rec_inserts))


def probe_kitti_dir(size):
    """The KITTI directory of the probes' drive, written from the
    reference's renders by datasets/kitti.py::write_sequence (the files
    chip_smoke.py writes from the port's renders): the small street of
    stereo_cfg (PROBE_KITTI_SMALL frames) or the KITTI-width drive of
    PROBE_KITTI_DRIVE frames. Returns (cfg, directory)."""
    from object_slam_tpu_torch.datasets import kitti as tkitti
    root = os.path.join(PROBES_DIR, f"kitti_{size}")
    kind, n = (("stereo", PROBE_KITTI_SMALL) if size == "small"
               else ("kitti", PROBE_KITTI_DRIVE))
    cfg = SlamConfig.kitti_stereo() if size == "vga" else stereo_cfg()
    if not os.path.exists(os.path.join(root, "gt.txt")):
        _, _, poses, frames = render_street(kind, n)
        frames = [(gl, gr, tuple(np.asarray(a) for a in sa))
                  for gl, gr, sa in frames]
        tkitti.write_sequence(root, poses, frames)
    return cfg, root


def _pil_u8(path):
    from PIL import Image
    return np.asarray(Image.open(path), np.uint8)


def jax_kitti_retention(cfg, seq, n_frames, start=0, radius_th=15.0,
                        level_window=1, forward_onesided=False):
    """diag_kitti_retention.py's loop (FrameBuilder.build_stereo, GT
    transport) at full precision; the Hamming in row chunks (the same
    counts as the script's [N, N, 256] cube): (per-frame, totals, level
    jumps)."""
    from object_slam_tpu.datasets import kitti
    from object_slam_tpu.slam.frame import FrameBuilder
    fb = FrameBuilder(cfg)
    frames = kitti.load_sequence(seq)
    gt = kitti.load_groundtruth(os.path.join(seq, "gt.txt"))
    K = fb.K
    sf = np.asarray(fb.scale_factors)
    close_z = cfg.camera.th_depth * cfg.camera.baseline

    def build(i):
        fr = frames[i]
        sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index,
                                  cfg)
        return fb.build_stereo(_pil_u8(fr.left_path), _pil_u8(fr.right_path),
                               None, sa, fr.timestamp)

    tot = dict(n=0, detected=0, lvl_ok=0, desc_ok=0, retained=0,
               det_in_img=0)
    lvl_jumps, per = [], []
    prev = build(start)
    for i in range(start + 1, start + n_frames):
        cur = build(i)
        p_uv = np.asarray(prev.uv)
        p_lvl = np.asarray(prev.level)
        p_desc = np.asarray(prev.desc)
        p_d = np.asarray(prev.depth)
        p_ok = np.asarray(prev.valid) & (p_d > 0) & (p_d < close_z)
        Tw_prev, Tw_cur = gt[i - 1], gt[i]
        Tcw_cur = np.linalg.inv(Tw_cur)
        z = np.maximum(p_d, 1e-6)
        pc = np.stack([(p_uv[:, 0] - K.cx) / K.fx * z,
                       (p_uv[:, 1] - K.cy) / K.fy * z, z], -1)
        pw = pc @ Tw_prev[:3, :3].T + Tw_prev[:3, 3]
        pc2 = pw @ Tcw_cur[:3, :3].T + Tcw_cur[:3, 3]
        z2 = pc2[:, 2]
        u2 = K.fx * pc2[:, 0] / np.maximum(z2, 1e-6) + K.cx
        v2 = K.fy * pc2[:, 1] / np.maximum(z2, 1e-6) + K.cy
        in_img = ((z2 > 0.1) & (u2 >= 0) & (u2 < cfg.camera.width)
                  & (v2 >= 0) & (v2 < cfg.camera.height))
        rows = p_ok & in_img
        c_uv = np.asarray(cur.uv)
        c_lvl = np.asarray(cur.level)
        c_desc = np.asarray(cur.desc)
        c_ok = np.asarray(cur.valid)
        radius = radius_th * sf[np.clip(p_lvl, 0, len(sf) - 1)]
        du = np.abs(u2[:, None] - c_uv[None, :, 0])
        dv = np.abs(v2[:, None] - c_uv[None, :, 1])
        win = (du < radius[:, None]) & (dv < radius[:, None]) & c_ok[None, :]
        if forward_onesided:
            lvl_win = c_lvl[None, :] >= (p_lvl[:, None] - 1)
        else:
            lvl_win = (np.abs(c_lvl[None, :] - p_lvl[:, None])
                       <= level_window)
        pb = np.unpackbits(np.ascontiguousarray(p_desc).view(np.uint8),
                           axis=-1)
        cb = np.unpackbits(np.ascontiguousarray(c_desc).view(np.uint8),
                           axis=-1)
        ham = np.zeros(win.shape, np.int32)
        for a in range(0, pb.shape[0], 128):
            ham[a:a + 128] = (pb[a:a + 128, None, :]
                              != cb[None, :, :]).sum(-1)
        desc_win = ham <= 100
        detected = win.any(1)
        lvl_ok = (win & lvl_win).any(1)
        desc_ok = (win & desc_win).any(1)
        retained = (win & lvl_win & desc_win).any(1)
        tot["n"] += int(rows.sum())
        tot["det_in_img"] += int(rows.sum())
        tot["detected"] += int((detected & rows).sum())
        tot["lvl_ok"] += int((lvl_ok & rows).sum())
        tot["desc_ok"] += int((desc_ok & rows).sum())
        tot["retained"] += int((retained & rows).sum())
        hit_rows = np.where(rows & detected)[0]
        if hit_rows.size:
            d2 = du[hit_rows] ** 2 + dv[hit_rows] ** 2
            d2 = np.where(win[hit_rows], d2, np.inf)
            nearest = d2.argmin(1)
            lvl_jumps.extend((c_lvl[nearest] - p_lvl[hit_rows]).tolist())
        per.append({"f": i, "close": int(rows.sum()),
                    "det": int((detected & rows).sum()),
                    "lvl": int((lvl_ok & rows).sum()),
                    "desc": int((desc_ok & rows).sum()),
                    "ret": int((retained & rows).sum())})
        print(f"kitti_retention {per[-1]}", flush=True)
        prev = cur
    vals, cnts = np.unique(np.asarray(lvl_jumps, np.int64),
                           return_counts=True)
    return per, tot, {int(v): int(c) for v, c in zip(vals, cnts)}


def jax_kitti(cfg, seq, n_frames, start=0, noise=None):
    """diag_kitti.py's loop (objects on, async mapping, float images and
    rgb) at full precision: (per-frame, keyframe frames)."""
    from object_slam_tpu.datasets import kitti
    from PIL import Image
    if noise is not None:
        level_noise(noise[0])
    frames = kitti.load_sequence(seq)[start:start + n_frames]
    gt = kitti.load_groundtruth(os.path.join(seq, "gt.txt"))
    Recorded, _ = recording_systems(noise=noise)
    sys_ = Recorded(cfg, enable_objects=True, async_mapping=True)
    per = []
    for i, fr in enumerate(frames):
        gl = np.asarray(Image.open(fr.left_path), np.float32)
        gr = np.asarray(Image.open(fr.right_path), np.float32)
        rgb = np.stack([gl] * 3, -1)
        sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index,
                                  cfg)
        f = sys_.track_stereo(jnp.asarray(gl), jnp.asarray(gr),
                              jnp.asarray(rgb), sa, timestamp=fr.timestamp)
        Twc = np.linalg.inv(np.asarray(f.Tcw))
        err = np.linalg.norm(Twc[:3, 3] - gt[start + i][:3, 3])
        d = np.asarray(f.depth)
        v = np.asarray(f.valid)
        close = (d > 0) & (d < cfg.camera.th_depth * cfg.camera.baseline)
        per.append({"f": start + i,
                    "inl": int(getattr(sys_, "_last_n_inliers", -1)),
                    "err_m": float(err), "kps": int(v.sum()),
                    "depth": int((d > 0).sum()),
                    "close": int((close & v).sum()),
                    "det": int(np.asarray(f.obj.valid).sum()),
                    "obj3d": np.asarray(f.obj3d)[:3].tolist(),
                    "kfs": int(sys_.n_keyframes)})
        print(f"kitti {per[-1]}", flush=True)
    kfs = sorted(set(sys_.rec_inserts))
    sys_.shutdown()
    return per, kfs


def jax_local_recovery(cfg, seq, n_frames, start=0, noise=None):
    """diag_local_recovery.py's loop (SlamSystem(cfg) as the script makes
    it, u8 images, rgb None) at full precision: (per-frame, totals,
    keyframe frames)."""
    from object_slam_tpu.datasets import kitti
    if noise is not None:
        level_noise(noise[0])
    Recorded, _ = recording_systems(noise=noise)
    sys_ = Recorded(cfg)
    frames = kitti.load_sequence(seq)
    close_z = cfg.camera.th_depth * cfg.camera.baseline
    cam = cfg.camera
    sf = np.asarray(sys_.scale_factors)
    log_scale = float(sys_.log_scale)
    n_levels = len(sf)
    tot = {k: 0 for k in ["close_vis", "matched", "no_local", "frustum",
                          "no_kp_radius", "level", "desc", "lost",
                          "level_would_pass_w2", "radius_would_pass_2x"]}
    per_frame = []
    for i in range(start, start + n_frames):
        fr = frames[i]
        sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index,
                                  cfg)
        sys_.track_stereo(_pil_u8(fr.left_path), _pil_u8(fr.right_path),
                          None, sa, fr.timestamp)
        if sys_.last_frame is None or i < start + 2:
            continue
        m = sys_.map
        frame = sys_.last_frame
        Tcw = np.asarray(frame.Tcw)
        pt_valid = np.asarray(m.pt_valid)
        pw = np.asarray(m.pt_xyz)
        normal = np.asarray(m.pt_normal)
        mind = np.asarray(m.pt_min_dist)
        maxd = np.asarray(m.pt_max_dist)
        desc = np.asarray(m.pt_desc)
        P = pw.shape[0]
        pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        close = pt_valid & (z > 0.1) & (z < close_z)
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        close_vis = close & in_img
        n_close_vis = int(close_vis.sum())
        if n_close_vis == 0:
            continue
        kp_pt = np.asarray(frame.kp_pt)
        matched_set = np.zeros((P,), bool)
        matched_set[np.clip(kp_pt, 0, P - 1)] |= (kp_pt >= 0)
        matched = close_vis & matched_set
        kf_kp_pt = np.asarray(m.kf_kp_pt)
        kf_kp_valid = np.asarray(m.kf_kp_valid)
        kf_valid = np.asarray(m.kf_valid)
        obs_ok = (kf_kp_pt >= 0) & kf_kp_valid & kf_valid[:, None]
        votes = (matched_set[np.clip(kf_kp_pt, 0, P - 1)] & obs_ok).sum(1)
        order = np.argsort(-votes)[:16]
        order = order[votes[order] > 0]
        local_mask = np.zeros((P,), bool)
        for kf in order:
            sel = kf_kp_pt[kf]
            okk = (sel >= 0) & kf_kp_valid[kf]
            local_mask[np.clip(sel, 0, P - 1)] |= okk
        local_mask &= pt_valid
        cap = cfg.caps.local_search_pts
        if local_mask.sum() > cap:
            recent = np.asarray(m.pt_first_kf) >= int(m.n_kf) - 3
            score = np.where(recent, 1e6, 0) + np.asarray(m.pt_n_obs)
            score = np.where(local_mask, score, -1)
            keep = np.argsort(-score)[:cap]
            lm2 = np.zeros((P,), bool)
            lm2[keep] = score[keep] >= 0
            local_mask = lm2
        cc = -Tcw[:3, :3].T @ Tcw[:3, 3]
        po = pw - cc
        dist = np.linalg.norm(po, axis=1)
        vcos = (po * normal).sum(1) / np.maximum(dist, 1e-6)
        frustum_ok = ((dist >= 0.8 * mind) & (dist <= 1.2 * maxd)
                      & (vcos > 0.5))
        kp_uv = np.asarray(frame.uv)
        kp_lvl = np.asarray(frame.level)
        kp_desc = np.asarray(frame.desc)
        kp_free = np.asarray(frame.valid) & (kp_pt < 0)
        lvl = np.clip(np.ceil(np.log(np.maximum(
            maxd / np.maximum(dist, 1e-6), 1e-6)) / log_scale
        ).astype(np.int32), 0, n_levels - 1)
        r0 = np.where(vcos > 0.998, 2.5, 4.0)
        radius = r0 * sf[lvl] * (7.0 / 7.0)
        rows = np.where(close_vis & ~matched)[0]
        cnt = dict(no_local=0, frustum=0, no_kp_radius=0, level=0,
                   desc=0, lost=0, level_would_pass_w2=0,
                   radius_would_pass_2x=0)
        pb = np.unpackbits(np.ascontiguousarray(desc[rows]).view(np.uint8),
                           axis=-1) if len(rows) else None
        cb = np.unpackbits(np.ascontiguousarray(kp_desc).view(np.uint8),
                           axis=-1)
        for k, p in enumerate(rows):
            if not local_mask[p]:
                cnt["no_local"] += 1
                continue
            if not frustum_ok[p]:
                cnt["frustum"] += 1
                continue
            du = np.abs(u[p] - kp_uv[:, 0])
            dv = np.abs(v[p] - kp_uv[:, 1])
            win = (du < radius[p]) & (dv < radius[p]) & kp_free
            if not win.any():
                if ((du < 2 * radius[p]) & (dv < 2 * radius[p])
                        & kp_free).any():
                    cnt["radius_would_pass_2x"] += 1
                cnt["no_kp_radius"] += 1
                continue
            lvl_ok = np.abs(kp_lvl - lvl[p]) <= 1
            if not (win & lvl_ok).any():
                if (win & (np.abs(kp_lvl - lvl[p]) <= 2)).any():
                    cnt["level_would_pass_w2"] += 1
                cnt["level"] += 1
                continue
            ham = (pb[k][None, :] != cb[win & lvl_ok]).sum(-1)
            if ham.min() > 100:
                cnt["desc"] += 1
                continue
            cnt["lost"] += 1
        tot["close_vis"] += n_close_vis
        tot["matched"] += int(matched.sum())
        for k in cnt:
            tot[k] += cnt[k]
        per_frame.append(dict(f=i, close_vis=n_close_vis,
                              matched=int(matched.sum()), **cnt))
        print(f"local_recovery {per_frame[-1]}", flush=True)
    kfs = sorted(set(sys_.rec_inserts))
    return per_frame, tot, kfs


def jax_motion_chain(cfg, seq, n_frames, start=0, noise=None):
    """diag_motion_chain.py's loop (SlamSystem(cfg), u8 images, rgb None;
    the motion search with and without last_angle on the real inputs) at
    full precision: (per-frame, totals, keyframe frames)."""
    from object_slam_tpu.datasets import kitti
    from object_slam_tpu.slam import tracking as trk
    if noise is not None:
        level_noise(noise[0])
    Recorded, _ = recording_systems(noise=noise)
    sys_ = Recorded(cfg)
    frames = kitti.load_sequence(seq)
    gt = kitti.load_groundtruth(os.path.join(seq, "gt.txt"))
    close_z = cfg.camera.th_depth * cfg.camera.baseline
    sf = np.asarray(sys_.scale_factors)
    K = sys_.K
    motion_jit = jax.jit(lambda m, fr, lu, lp, ll, lv, tp, tl, la:
                         trk.track_motion_model(
                             K, m, fr, lu, lp, ll, lv, tp,
                             sys_.scale_factors, sys_.inv_sigma2,
                             radius_th=cfg.tracking.motion_model_radius,
                             T_last=tl, last_angle=la))
    motion_norot_jit = jax.jit(lambda m, fr, lu, lp, ll, lv, tp, tl:
                               trk.track_motion_model(
                                   K, m, fr, lu, lp, ll, lv, tp,
                                   sys_.scale_factors, sys_.inv_sigma2,
                                   radius_th=cfg.tracking.motion_model_radius,
                                   T_last=tl, last_angle=None))
    tot = {k: 0 for k in ["bound", "window", "ur_ok", "level", "desc",
                          "matched", "matched_norot", "inlier",
                          "inlier_norot", "killed_total",
                          "killed_correct"]}
    per = []
    for i in range(start, start + n_frames):
        fr = frames[i]
        sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index,
                                  cfg)
        last_snapshot = sys_.last_frame
        last_Tcw = (np.asarray(last_snapshot.Tcw)
                    if last_snapshot is not None else None)
        vel = np.asarray(sys_.velocity) if sys_.velocity is not None \
            else np.eye(4)
        sys_.track_stereo(_pil_u8(fr.left_path), _pil_u8(fr.right_path),
                          None, sa, fr.timestamp)
        if last_snapshot is None or i < start + 2:
            continue
        m = sys_.map
        last = last_snapshot
        cur = sys_.last_frame
        T_pred = vel @ last_Tcw
        P = np.asarray(m.pt_xyz).shape[0]
        l_uv = np.asarray(last.uv)
        l_pt = np.asarray(last.kp_pt)
        l_lvl = np.asarray(last.level)
        l_d = np.asarray(last.depth)
        l_valid = np.asarray(last.valid)
        l_desc = np.asarray(last.desc)
        pt_valid = np.asarray(m.pt_valid)
        close = l_valid & (l_d > 0) & (l_d < close_z)
        bound = close & (l_pt >= 0) & pt_valid[np.clip(l_pt, 0, P - 1)]
        pw = np.asarray(m.pt_xyz)[np.clip(l_pt, 0, P - 1)]
        pc = pw @ T_pred[:3, :3].T + T_pred[:3, 3]
        z = pc[:, 2]
        u = K.fx * pc[:, 0] / np.maximum(z, 1e-6) + K.cx
        v = K.fy * pc[:, 1] / np.maximum(z, 1e-6) + K.cy
        ur_pred = u - K.bf / np.maximum(z, 1e-6)
        in_img = (z > 0) & (u >= 0) & (u < cfg.camera.width) & \
            (v >= 0) & (v < cfg.camera.height)
        rows = bound & in_img
        c_uv = np.asarray(cur.uv)
        c_lvl = np.asarray(cur.level)
        c_desc = np.asarray(cur.desc)
        c_ur = np.asarray(cur.ur)
        c_ok = np.asarray(cur.valid)
        radius = cfg.tracking.motion_model_radius * sf[
            np.clip(l_lvl, 0, len(sf) - 1)]
        du = np.abs(u[:, None] - c_uv[None, :, 0])
        dv = np.abs(v[:, None] - c_uv[None, :, 1])
        win = (du < radius[:, None]) & (dv < radius[:, None]) & c_ok[None, :]
        ur_ok_m = (c_ur[None, :] < 0) | (
            np.abs(ur_pred[:, None] - c_ur[None, :]) < radius[:, None])
        lvl_win = c_lvl[None, :] >= (l_lvl[:, None] - 1)
        pb = np.unpackbits(np.ascontiguousarray(l_desc).view(np.uint8),
                           axis=-1)
        cb = np.unpackbits(np.ascontiguousarray(c_desc).view(np.uint8),
                           axis=-1)
        desc_hit = np.zeros(win.shape, bool)
        step = 256
        for a in range(0, pb.shape[0], step):
            ham = (pb[a:a + step, None, :] != cb[None, :, :]).sum(-1)
            desc_hit[a:a + step] = ham <= 100
        stage_w = (win).any(1)
        stage_u = (win & ur_ok_m).any(1)
        stage_l = (win & ur_ok_m & lvl_win).any(1)
        stage_d = (win & ur_ok_m & lvl_win & desc_hit).any(1)
        res = motion_jit(m, cur, last.uv, last.kp_pt, last.level,
                         last.valid, jnp.asarray(T_pred),
                         jnp.asarray(last_Tcw), last.angle)
        res_norot = motion_norot_jit(m, cur, last.uv, last.kp_pt,
                                     last.level, last.valid,
                                     jnp.asarray(T_pred),
                                     jnp.asarray(last_Tcw))
        mt = np.asarray(res.kp_pt_all)
        inl = np.asarray(res.kp_pt)
        mt_nr = np.asarray(res_norot.kp_pt_all)
        inl_nr = np.asarray(res_norot.kp_pt)
        matched_set = np.zeros((P,), bool)
        matched_set[np.clip(mt, 0, P - 1)] |= (mt >= 0)
        matched_nr_set = np.zeros((P,), bool)
        matched_nr_set[np.clip(mt_nr, 0, P - 1)] |= (mt_nr >= 0)
        inlier_set = np.zeros((P,), bool)
        inlier_set[np.clip(inl, 0, P - 1)] |= (inl >= 0)
        inlier_nr_set = np.zeros((P,), bool)
        inlier_nr_set[np.clip(inl_nr, 0, P - 1)] |= (inl_nr >= 0)
        lptc = np.clip(l_pt, 0, P - 1)
        killed_correct = killed_total = 0
        gtTcw = np.linalg.inv(gt[i])
        kp_of_pt = np.full((P,), -1, np.int64)
        kp_of_pt[np.clip(mt_nr, 0, P - 1)] = np.where(
            mt_nr >= 0, np.arange(len(mt_nr)), -1)
        pw_all = np.asarray(m.pt_xyz)
        for pslot in np.where(matched_nr_set & ~matched_set)[0]:
            r_last = np.where((lptc == pslot) & rows)[0]
            if len(r_last) == 0:
                continue
            j = kp_of_pt[pslot]
            if j < 0:
                continue
            pcg = pw_all[pslot] @ gtTcw[:3, :3].T + gtTcw[:3, 3]
            if pcg[2] <= 0:
                continue
            ug = K.fx * pcg[0] / pcg[2] + K.cx
            vg = K.fy * pcg[1] / pcg[2] + K.cy
            killed_total += 1
            if (ug - c_uv[j, 0]) ** 2 + (vg - c_uv[j, 1]) ** 2 < 9.0:
                killed_correct += 1
        row_stats = dict(
            f=i, bound=int(rows.sum()),
            window=int((stage_w & rows).sum()),
            ur_ok=int((stage_u & rows).sum()),
            level=int((stage_l & rows).sum()),
            desc=int((stage_d & rows).sum()),
            matched=int((matched_set[lptc] & rows).sum()),
            matched_norot=int((matched_nr_set[lptc] & rows).sum()),
            inlier=int((inlier_set[lptc] & rows).sum()),
            inlier_norot=int((inlier_nr_set[lptc] & rows).sum()),
            killed_total=killed_total,
            killed_correct=killed_correct)
        for k in tot:
            tot[k] += row_stats[k]
        per.append(row_stats)
        print(f"motion_chain {row_stats}", flush=True)
    kfs = sorted(set(sys_.rec_inserts))
    return per, tot, kfs


def _probe_K(cfg):
    cam = cfg.camera
    sf = np.asarray([cfg.orb.scale_factor ** l
                     for l in range(cfg.orb.n_levels)])
    return Intrinsics.from_config(cam), (1.0 / (sf * sf)).astype(np.float32)


def jax_replay(d, cfg):
    """diag_replay.py on a dump at full precision (its camera: cfg's):
    the six replays, the recorded errors, the two basins and the three
    costs."""
    from object_slam_tpu.solvers.pose_opt import PoseObs, pose_optimize
    K, inv_sigma2_lvl = _probe_K(cfg)
    T_gt = d["T_gt"]

    def replay(kp_pt, T0):
        matched = (kp_pt >= 0) & d["valid"]
        P = d["pt_xyz"].shape[0]
        ptc = np.clip(kp_pt, 0, P - 1)
        obs = PoseObs(
            uv=jnp.asarray(d["uv"]),
            ur=jnp.asarray(np.where(matched, d["ur"], -1.0)),
            pw=jnp.asarray(d["pt_xyz"][ptc]),
            inv_sigma2=jnp.asarray(inv_sigma2_lvl[np.clip(d["level"], 0,
                                                          7)]),
            valid=jnp.asarray(matched))
        Tcw, inl, n_inl = pose_optimize(K, jnp.asarray(T0), obs)
        Tcw = np.asarray(Tcw)
        pw = d["pt_xyz"][ptc[matched]]
        pc = (T_gt[:3, :3] @ pw.T).T + T_gt[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = float(K.fx) * pc[:, 0] / z + float(K.cx)
        v = float(K.fy) * pc[:, 1] / z + float(K.cy)
        kp = d["uv"][matched]
        dd = np.hypot(u - kp[:, 0], v - kp[:, 1])
        lv = d["level"][matched]
        return {"n": int(matched.sum()),
                "wrong": float((dd > 3).mean() * 100),
                "err0_mm": float(np.linalg.norm(T0[:3, 3] - T_gt[:3, 3])
                                 * 1000),
                "err_mm": float(np.linalg.norm(Tcw[:3, 3] - T_gt[:3, 3])
                                * 1000),
                "n_inl": int(n_inl),
                "spread": [float(kp[:, 0].std()), float(kp[:, 1].std())],
                "levels": [float(np.median(lv)),
                           float(np.percentile(lv, 90))]}, Tcw

    def cost(kp_pt, T):
        matched = (kp_pt >= 0) & d["valid"]
        P = d["pt_xyz"].shape[0]
        ptc = np.clip(kp_pt, 0, P - 1)
        pw = d["pt_xyz"][ptc]
        pc = (T[:3, :3] @ pw.T).T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = float(K.fx) * pc[:, 0] / z + float(K.cx)
        v = float(K.fy) * pc[:, 1] / z + float(K.cy)
        urp = u - float(K.bf) / z
        ru = d["uv"][:, 0] - u
        rv = d["uv"][:, 1] - v
        rr = np.where(d["ur"] >= 0, d["ur"] - urp, 0.0)
        isig = inv_sigma2_lvl[np.clip(d["level"], 0, 7)]
        chi2 = (ru * ru + rv * rv + rr * rr) * isig
        delta2 = np.where(d["ur"] >= 0, 7.815, 5.991)
        rho = np.where(chi2 <= delta2, chi2,
                       2 * np.sqrt(delta2 * np.maximum(chi2, 1e-12))
                       - delta2)
        rho = np.where(matched, rho, 0.0)
        n = matched.sum()
        return {"cost": float(rho.sum()), "mean": float(rho.sum() / n),
                "median_chi2": float(np.median(chi2[matched])), "n": int(n)}

    out = {}
    for name, T0 in (("T_pred", d["T_pred"]), ("Tcw_local", d["Tcw_local"]),
                     ("T_gt", T_gt.astype(np.float32))):
        out[f"init_{name}"] = {
            "motion": replay(d["kp_pt_motion"], T0)[0],
            "local": replay(d["kp_pt_local"], T0)[0]}
    out["recorded"] = {
        "motion_err_mm": float(np.linalg.norm(
            d["Tcw_motion"][:3, 3] - T_gt[:3, 3]) * 1000),
        "local_err_mm": float(np.linalg.norm(
            d["Tcw_local"][:3, 3] - T_gt[:3, 3]) * 1000),
        "T_pred_err_mm": float(np.linalg.norm(
            d["T_pred"][:3, 3] - T_gt[:3, 3]) * 1000)}
    wrong, T_wrong = replay(d["kp_pt_local"], d["T_pred"])
    right, T_right = replay(d["kp_pt_local"], T_gt.astype(np.float32))
    out["wrong_basin"], out["right_basin"] = wrong, right
    out["cost_wrong"] = cost(d["kp_pt_local"], T_wrong)
    out["cost_right"] = cost(d["kp_pt_local"], T_right)
    out["cost_gt"] = cost(d["kp_pt_local"], T_gt)
    return out


def jax_gnsteps(d, cfg):
    """diag_gnsteps.py on a dump at full precision: every LM step's error,
    step and active count (4 rounds of 10) and each regate's count."""
    from object_slam_tpu.solvers import pose_opt as po
    K, inv_sigma2_lvl = _probe_K(cfg)
    T_gt = d["T_gt"]
    kp_pt = d["kp_pt_local"]
    matched = (kp_pt >= 0) & d["valid"]
    P = d["pt_xyz"].shape[0]
    ptc = np.clip(kp_pt, 0, P - 1)
    obs = po.PoseObs(
        uv=jnp.asarray(d["uv"]),
        ur=jnp.asarray(np.where(matched, d["ur"], -1.0)),
        pw=jnp.asarray(d["pt_xyz"][ptc]),
        inv_sigma2=jnp.asarray(inv_sigma2_lvl[np.clip(d["level"], 0, 7)]),
        valid=jnp.asarray(matched))
    gn = jax.jit(lambda T, l, a: po._lm_step(K, T, l, obs, a, 5.991, 7.815))
    regate = jax.jit(lambda T: po.reproj_residual_jac(K, T, obs))
    T = jnp.asarray(d["T_pred"])
    lam = jnp.float32(1e-3)
    active = obs.valid
    steps, regates = [], []
    start = float(np.linalg.norm(np.asarray(T)[:3, 3] - T_gt[:3, 3]) * 1000)
    for rnd in range(4):
        for it in range(10):
            # _lm_step returns (T, lam, converged): the script's two-name
            # unpacking predates the third
            T2, lam, _ = gn(T, lam, active)
            step = np.linalg.norm(np.asarray(T2)[:3, 3] - np.asarray(T)[:3, 3])
            T = T2
            err = np.linalg.norm(np.asarray(T)[:3, 3] - T_gt[:3, 3]) * 1000
            steps.append({"round": rnd, "it": it, "err_mm": float(err),
                          "step_mm": float(step * 1000),
                          "active": int(jnp.sum(active))})
        r, _, stereo, z = regate(T)
        chi2 = po.edge_chi2(r, obs.inv_sigma2, stereo)
        gate = jnp.where(stereo, 7.815, 5.991)
        active = obs.valid & (chi2 <= gate) & (z > 0)
        regates.append(int(jnp.sum(active)))
    return {"start_err_mm": start, "steps": steps, "regates": regates}


def record_probe_part(part):
    """make_reference.py probes:<part>: one run, saved under build/probes/
    (merge collects them). Parts: pose; ret_<size>:<main|noise<k>|loc|
    locnoise<k>>; kitti_dir:<size>; <kind>_<size>:<main|noise<k>> for
    kind in PROBE_KITTI_KINDS (kret takes only level_noise)."""
    import probe_bands
    if part == "pose":
        return record_probe_pose()
    name, run = part.split(":")
    if name == "kitti_dir":
        probe_kitti_dir(run)
        return
    kind, size = name.rsplit("_", 1)
    out = {}

    def pin_of(main_name):
        main = np.load(probe_path(f"{main_name}:main"))
        return [int(x) for x in main["kf_frames"]]
    if kind == "ret":
        cfg = probe_tum_cfg(size)
        loc = run.startswith("loc")
        n = ((PROBE_LOC_SMALL if size == "small" else PROBE_LOC_VGA) if loc
             else (PROBE_RET_SMALL if size == "small" else PROBE_RET_VGA))
        noise = None
        if run.startswith(("noise", "locnoise")):
            seed = int(run.replace("loc", "").replace("noise", ""))
            noise = (seed, [] if loc else pin_of(name))
        recs, summary, dumps, kfs = jax_retention(
            cfg, n, loc_only=loc, noise=noise, dump_all=(run == "main"))
        probe_bands.put(out, "recs", recs)
        probe_bands.put(out, "summary", [summary])
        out["kf_frames"] = np.asarray(kfs, np.int32)
        if run == "main":
            # the script's dumps (error past 20 mm); where fewer than two,
            # the frames of largest error through the same writer
            errs = {r["f"]: r["err_mm"] for r in recs if r["f"] in dumps}
            own = [f for f in sorted(dumps) if recs[f]["dumped"]]
            pick = own[:2] + [f for f in sorted(errs, key=lambda f: -errs[f])
                              if f not in own][:max(0, 2 - len(own))]
            out["dump_frames"] = np.asarray(pick, np.int32)
            out["dump_by_script"] = np.asarray([f in own for f in pick])
            for j, f in enumerate(pick):
                for k, v in dumps[f].items():
                    out[f"dump{j}.{k}"] = v
    else:
        cfg, seq = probe_kitti_dir(size)
        n = PROBE_KITTI_SMALL if size == "small" else PROBE_KITTI_VGA
        seed = int(run[len("noise"):]) if run.startswith("noise") else None
        if kind == "kret":
            if seed is not None:
                level_noise(seed)
            per, tot, jumps = jax_kitti_retention(cfg, seq, n)
            probe_bands.put(out, "totals", [dict(tot, jumps=jumps)])
        else:
            noise = None if seed is None else (seed, pin_of(name))
            if kind == "kitti":
                per, kfs = jax_kitti(cfg, seq, n, noise=noise)
            elif kind == "lrec":
                per, tot, kfs = jax_local_recovery(cfg, seq, n, noise=noise)
                probe_bands.put(out, "totals", [tot])
            else:
                per, tot, kfs = jax_motion_chain(cfg, seq, n, noise=noise)
                probe_bands.put(out, "totals", [tot])
            out["kf_frames"] = np.asarray(kfs, np.int32)
        probe_bands.put(out, "recs", per)
    np.savez_compressed(probe_path(part), **out)
    print(f"probes:{part} written", flush=True)


def probe_parts(size):
    k = PROBE_NOISE[size]
    return ([f"ret_{size}:main"] + [f"ret_{size}:noise{i}" for i in range(k)]
            + [f"ret_{size}:loc"]
            + [f"ret_{size}:locnoise{i}" for i in range(PROBE_LOC_NOISE)]
            + [f"kitti_dir:{size}"]
            + [f"{kind}_{size}:{run}" for kind in PROBE_KITTI_KINDS
               for run in ["main"] + [f"noise{i}" for i in range(k)]])


def merge_probes(sizes=("small", "vga")):
    """probes.npz (small) and probes_vga.npz from the parts: each run's
    tables under <name>.<run>., the dumps, and the reference's replay and
    GN trace of each dump."""
    sys.path.insert(0, HERE)
    import probe_bands
    pose = dict(np.load(probe_path("pose")))
    for size, path in (("small", OUT_PROBES), ("vga", OUT_PROBES_VGA)):
        if size not in sizes:
            continue
        out = dict(pose)
        for part in probe_parts(size):
            if part.startswith("kitti_dir"):
                continue
            name, run = part.split(":")
            d = np.load(probe_path(part))
            for k in d.files:
                if k.startswith("dump"):
                    out[f"{name}.{k}"] = d[k]
                elif not k.startswith(("recs.", "summary.", "totals.")):
                    out[f"{name}.{run}.{k}"] = d[k]
            for tab in ("recs", "summary", "totals"):
                t = probe_bands.load(d, tab)
                if t:
                    probe_bands.put(out, f"{name}.{run}.{tab}", t)
        cfg = probe_tum_cfg(size)
        for j in range(len(out[f"ret_{size}.dump_frames"])):
            dump = {k.split(".", 2)[2]: v for k, v in out.items()
                    if k.startswith(f"ret_{size}.dump{j}.")}
            probe_bands.put(out, f"replay{j}", [jax_replay(dump, cfg)])
            probe_bands.put(out, f"gnsteps{j}", [jax_gnsteps(dump, cfg)])
        np.savez_compressed(path, **out)
        print(f"wrote {path}: {os.path.getsize(path) / 1e3:.1f} kB, "
              f"{len(out)} arrays", flush=True)


def record_probes(part):
    if part == "merge":
        merge_probes()
    elif part.startswith("merge:"):
        merge_probes((part.split(":", 1)[1],))
    else:
        record_probe_part(part)

# ---------------------------------------------------------------------------
# the single-card stage timers of scripts/ (diag_ba_profile.py,
# diag_kitti_stages.py, diag_fullpipe.py): what each timed call computes,
# at full precision, for the port's scripts to be held to (their outputs
# are milliseconds)
# ---------------------------------------------------------------------------

OUT_STAGES = os.path.join(HERE, "stages.npz")
STAGES_DIR = os.path.join(HERE, "..", "..", "build", "stages")
# diag_ba_profile.py's problem: the CPU tests' size and the script's own
STAGE_BA_SIZES = {"small": (6, 64, 256), "full": (40, 2048, 8192)}
STAGE_BA_NOISE = 4
# diag_kitti_stages.py's 12 frames: stereo_cfg's street (the CPU tests)
# and the first 12 of make_synth_kitti.py's 24 (chip_smoke.py's third
# process writes that directory with make_synth_kitti_torch.py)
STAGE_KITTI_FRAMES, STAGE_KITTI_DRIVE = 12, 24
STAGE_KITTI_NOISE = 4
# diag_fullpipe.py's 16 frames at small_cfg and at tum_rgbd()
STAGE_FULLPIPE_FRAMES = 16


def stage_path(part):
    os.makedirs(STAGES_DIR, exist_ok=True)
    return os.path.join(STAGES_DIR, part.replace(":", "_") + ".npz")


def stage_script(name):
    """The port's script scripts/<name>.py (its numpy problem builder and
    census, which define what is recorded)."""
    sys.path.insert(0, os.path.join(HERE, "..", "..", "scripts"))
    import importlib
    return importlib.import_module(name)


def ba_profile_problem(K, Wtot, N, Lp):
    """diag_ba_profile.py's problem, its lines verbatim: (BAProblem, slot
    table, the numpy arrays)."""
    O = Wtot * N
    rng = np.random.RandomState(0)
    pts = rng.uniform([-20, -5, 5], [20, 5, 60], (Lp, 3)).astype(np.float32)
    poses = []
    for i in range(Wtot):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, 0, -0.5 * i]
        poses.append(T)
    poses = np.stack(poses)
    fx, fy, cx, cy, bf = (float(K.fx), float(K.fy), float(K.cx),
                          float(K.cy), float(K.bf))
    obs_pt = rng.randint(0, Lp, (O,)).astype(np.int32)
    obs_kf = np.repeat(np.arange(Wtot), N).astype(np.int32)
    pw = pts[obs_pt]
    pc = (poses[obs_kf, :3, :3] @ pw[..., None])[..., 0] + poses[obs_kf, :3, 3]
    z = np.maximum(pc[:, 2], 0.1)
    uv = np.stack([fx * pc[:, 0] / z + cx,
                   fy * pc[:, 1] / z + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    ur = uv[:, 0] - bf / z
    valid = (pc[:, 2] > 0.5) & (np.abs(uv[:, 0] - cx) < cx) \
        & (np.abs(uv[:, 1] - cy) < cy)
    valid = np.asarray(valid)
    slot = np.full((Lp, Wtot), -1, np.int64)
    for o in range(O):
        if not valid[o]:
            continue
        p, w = obs_pt[o], obs_kf[o]
        if slot[p, w] < 0:
            slot[p, w] = o
        else:
            valid[o] = False
    prob = BAProblem(
        kf_pose=jnp.asarray(poses),
        kf_fixed=jnp.zeros((Wtot,), bool).at[0].set(True),
        kf_valid=jnp.ones((Wtot,), bool),
        pt_xyz=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape)
                           .astype(np.float32)),
        pt_valid=jnp.ones((Lp,), bool),
        obs_kf=jnp.asarray(obs_kf), obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_ur=jnp.asarray(np.where(valid, ur, -1.0).astype(np.float32)),
        obs_inv_sigma2=jnp.ones((O,)),
        obs_valid=jnp.asarray(valid))
    return prob, slot.astype(np.int32)


def record_stage_ba(size, run):
    """diag_ba_profile.py's seven variants on its problem at size: each
    ba_iterate result (jitted, as the script calls it) as
    stage_bands.ba_record keeps it. run "noise<k>":
    the points' initial coordinates times (1 + u), u uniform in +-6e-8
    (RandomState(k))."""
    from object_slam_tpu.solvers.ba import _robust_cost, ba_iterate
    import stage_bands
    prof = stage_script("diag_ba_profile_torch")
    cfg = SlamConfig.kitti_stereo()
    K = Intrinsics.from_config(cfg.camera)
    Wtot, N, Lp = STAGE_BA_SIZES[size]
    prob, slot = ba_profile_problem(K, Wtot, N, Lp)
    out = {"problem_hash": np.asarray(stage_bands.problem_hash(
        {f: np.asarray(getattr(prob, f)) for f in BAProblem._fields},
        slot))}
    if run.startswith("noise"):
        u = np.random.RandomState(int(run[len("noise"):])).uniform(
            -6e-8, 6e-8, prob.pt_xyz.shape)
        prob = prob._replace(pt_xyz=jnp.asarray(
            (np.asarray(prob.pt_xyz) * (1.0 + u)).astype(np.float32)))
    slot_j = jnp.asarray(slot)
    for i, (name, blocked, with_slot, it, cg) in enumerate(prof.VARIANTS):
        fn = jax.jit(lambda p, it=it, cg=cg, bn=N if blocked else None,
                     sl=with_slot: ba_iterate(
                         K, p, it, cg_iters=cg, block_n=bn,
                         pt_obs_slot=slot_j if sl else None))
        kf_pose, pt_xyz = fn(prob)
        cost = float(_robust_cost(K, prob, kf_pose, pt_xyz, 5.991, 7.815,
                                  lambda x: x, block_n=None))
        rec = stage_bands.ba_record(np.asarray(prob.pt_xyz), kf_pose, pt_xyz,
                                    cost)
        for k, v in rec.items():
            out[f"v{i}.{k}"] = v
        print(f"stages:ba_{size}:{run} {name}: cost {cost:.6f}", flush=True)
    return out


def stage_kitti_dir(size):
    """The KITTI directory the stage timer drives: size "small", the first
    STAGE_KITTI_FRAMES frames of stereo_cfg's street written from the
    reference's renders (datasets/kitti.py::write_sequence, as
    probe_kitti_dir writes); "vga", make_synth_kitti_torch.py's
    STAGE_KITTI_DRIVE frames (its files equal make_synth_kitti.py's,
    held here to experiments.npz's digests). Returns (cfg, directory)."""
    import subprocess
    root = os.path.join(STAGES_DIR, f"kitti_{size}")
    if size == "small":
        cfg = stereo_cfg()
        if not os.path.exists(os.path.join(root, "gt.txt")):
            from object_slam_tpu_torch.datasets import kitti as tkitti
            _, _, poses, frames = render_street("stereo", STAGE_KITTI_FRAMES)
            frames = [(gl, gr, tuple(np.asarray(a) for a in sa))
                      for gl, gr, sa in frames]
            tkitti.write_sequence(root, poses, frames)
        return cfg, root
    cfg = SlamConfig.kitti_stereo()
    seq = os.path.join(root, "kitti")
    if not os.path.exists(os.path.join(seq, "gt.txt")):
        subprocess.run([sys.executable, os.path.join(
            HERE, "..", "..", "scripts", "make_synth_kitti_torch.py"),
            "--out", seq, "--frames", str(STAGE_KITTI_DRIVE)], check=True)
        want = json.loads(str(np.load(os.path.join(
            HERE, "experiments.npz"))["synth_digests"]))
        got = synth_digests(root)
        bad = [k for k in want if k.startswith("kitti") and
               want[k] != got.get(k)]
        if bad:
            raise SystemExit(f"stages: {len(bad)} KITTI files differ from "
                             f"make_synth_kitti.py's: {bad[:5]}")
    return cfg, seq


def record_stage_kitti(size, run):
    """diag_kitti_stages.py's drive (the first STAGE_KITTI_FRAMES frames,
    objects on, inline mapping, PIL's float images) and its eleven stages,
    each called once with the script's arguments, counted by the port
    script's stage_counts; run "noise<k>": pinned_noise with main's
    keyframe decisions."""
    from object_slam_tpu.datasets import kitti
    from object_slam_tpu.slam import local_mapping, map_ops
    from object_slam_tpu.slam.map_state import (covisibility,
                                                recompute_point_stats)
    from PIL import Image
    st = stage_script("diag_kitti_stages_torch")
    cfg, seq = stage_kitti_dir(size)
    noise = None
    if run.startswith("noise"):
        main = np.load(stage_path(f"kitti_{size}:main"))
        noise = (int(run[len("noise"):]),
                 [int(x) for x in main["kf_frames"]])
    Recorded, _ = recording_systems(noise=noise)
    frames = kitti.load_sequence(seq)[:STAGE_KITTI_FRAMES]
    sys_ = Recorded(cfg, enable_objects=True, async_mapping=False)
    for i, fr in enumerate(frames):
        gl = np.asarray(Image.open(fr.left_path), np.float32)
        gr = np.asarray(Image.open(fr.right_path), np.float32)
        rgb = np.stack([gl] * 3, -1)
        sa = kitti.load_semantics(os.path.join(seq, "semantic"), fr.index,
                                  cfg)
        f = sys_.track_stereo(jnp.asarray(gl), jnp.asarray(gr),
                              jnp.asarray(rgb), sa, timestamp=fr.timestamp)
    m = sys_.map
    frame, last = f, sys_.last_frame
    kfi = jnp.int32(max(sys_.last_kf_id, 0))
    kf_id = int(kfi)
    spawn = frame.valid & (frame.depth > 0)
    calls = {
        "build_stereo": lambda: sys_.builder.build_stereo(
            jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(rgb),
            sys_.builder.pack_sem_arrays(sa), 0.0),
        "fused": lambda: sys_._jit_fused(
            m, frame, last, jnp.eye(4), jnp.int32(max(sys_.last_kf_id, 0)),
            jnp.int32(1), jnp.int32(11), jnp.int32(500)),
        "insert": lambda: sys_._jit_insert(m, frame, frame.Tcw, frame.kp_pt,
                                           spawn, np.int32(11)),
        "mapping": lambda: sys_._jit_mapping(m, kfi),
        "covisibility": lambda: jax.jit(covisibility)(m),
        "recompute_stats": lambda: jax.jit(recompute_point_stats)(m),
        "cull_points": lambda: jax.jit(lambda mm, k: map_ops.cull_points(
            mm, k, recency_scope=True))(m, kfi),
        "triangulate": lambda: jax.jit(
            lambda mm, k: map_ops.triangulate_new_points(
                mm, k, n_neighbors=5, K=sys_.K,
                inv_sigma2_lvl=sys_.inv_sigma2,
                scale_factors=sys_.scale_factors))(m, kfi),
        "fuse": lambda: jax.jit(lambda mm, k: map_ops.fuse_into_neighbors(
            mm, k, n_neighbors=5, K=sys_.K, scale_factors=sys_.scale_factors,
            inv_sigma2_lvl=sys_.inv_sigma2))(m, kfi),
        "local_ba": lambda: jax.jit(lambda mm, k: local_mapping.run_local_ba(
            K=sys_.K, m=mm, kf_id=k, window=cfg.caps.local_window_kf,
            n_fixed=8, inv_sigma2_lvl=sys_.inv_sigma2))(m, kfi),
        "cull_kfs": lambda: jax.jit(lambda mm, k: map_ops.cull_keyframes(
            mm, k, scale_condition=False, n_levels=cfg.orb.n_levels))(m, kfi),
    }
    rec = {"map": st.map_counts(m)}
    for name in st.STAGES:
        out = calls[name]()
        # the insert handle records the frame id: drop this call's
        if name == "insert":
            sys_.rec_inserts.pop()
        rec[name] = st.stage_counts(name, out, m, kf_id)
        print(f"stages:kitti_{size}:{run} {name}: {rec[name]}", flush=True)
    sys.path.insert(0, HERE)
    import probe_bands
    out = {"kf_frames": np.asarray(sorted(set(sys_.rec_inserts)), np.int32),
           "gray_sum": np.asarray(float(np.sum(gl, dtype=np.float64)))}
    probe_bands.put(out, "counts", [rec])
    sys_.shutdown()
    return out


def record_stage_fullpipe(size):
    """diag_fullpipe.py's loop (its scene and frames; at "vga" the depth
    and rgb cast to float32 first, as chip_smoke.py's main process holds
    its renders) with the profiler on: the bytes line, the profiler's span
    names and calls, then, the last lagged readback resolved, every
    frame's pose and flag and the keyframes' frames."""
    cfg = small_cfg().replace(tracking=TrackingConfig()) \
        if size == "small" else SlamConfig.tum_rgbd()
    fp = stage_script("diag_fullpipe_torch")
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b['size'] = 0.9
    poses = orbit_poses(STAGE_FULLPIPE_FRAMES, step=0.01)
    frames, gray_sums = [], []
    for T in poses:
        gray, depth, rgb, sem = scene.render_rgbd(T)
        if size == "vga":
            depth = np.asarray(depth).astype(np.float32)
            rgb = np.asarray(rgb).astype(np.float32)
        gray_sums.append(float(np.sum(np.asarray(gray, np.float32),
                                      dtype=np.float64)))
        frames.append(fp.to_inputs(cfg, depth, rgb, scene.sem_arrays(
            sem, cfg.semantic.max_instances)))
    sys_ = SlamSystem(cfg, enable_objects=True)
    sys_.profiler.enabled = True
    for i, (d16, rgb8, sa) in enumerate(frames):
        f = sys_.builder.build_rgbd(None, jnp.asarray(d16),
                                    jnp.asarray(rgb8), sa, i / 30.0)
        jnp.asarray(f.desc).block_until_ready()
        sys_._host_ts = i / 30.0
        out = sys_._track(f)
        jnp.asarray(out.Tcw).block_until_ready()
    stats = sys_.profiler.stats()
    sys_._resolve_fused_pending()
    m = sys_.map
    kv = np.asarray(m.kf_valid)
    rec = {"bytes": np.asarray(fp.frame_bytes(*frames[0]), np.int64),
           "span_names": np.asarray(sorted(stats)),
           "span_calls": np.asarray([stats[k]["n"] for k in sorted(stats)],
                                    np.int64),
           "Tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
               np.float32),
           "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
           "kf_frames": np.asarray(sorted(
               int(x) for x in np.asarray(m.kf_frame_id)[kv]), np.int32),
           "gray_sums": np.asarray(gray_sums),
           "gt_Tcw": np.stack(poses).astype(np.float32)}
    print(f"stages:fullpipe_{size}: tracked {int(rec['tracked'].sum())} of "
          f"{len(rec['tracked'])}, keyframes {rec['kf_frames'].tolist()}, "
          f"spans {dict(zip(rec['span_names'].tolist(), rec['span_calls'].tolist()))}",
          flush=True)
    return rec


STAGE_PARTS = ([f"ba_{s}:{r}" for s in STAGE_BA_SIZES
                for r in ["main"] + [f"noise{k}"
                                     for k in range(STAGE_BA_NOISE)]]
               + [f"kitti_{s}:{r}" for s in ("small", "vga")
                  for r in ["main"] + [f"noise{k}"
                                       for k in range(STAGE_KITTI_NOISE)]]
               + ["fullpipe_small:main", "fullpipe_vga:main"])


def record_stages(part):
    """make_reference.py stages:<part>: one run, saved under build/stages/
    (run a size's main before its noise runs); stages:merge collects them
    into stages.npz under <name>.<run>."""
    if part != "merge":
        name, run = part.split(":")
        kind, size = name.split("_")
        if kind == "ba":
            out = record_stage_ba(size, run)
        elif kind == "kitti":
            out = record_stage_kitti(size, run)
        else:
            out = record_stage_fullpipe(size)
        np.savez_compressed(stage_path(part), **out)
        print(f"stages:{part} written", flush=True)
        return
    out = {}
    for p in STAGE_PARTS:
        name, run = p.split(":")
        with np.load(stage_path(p)) as d:
            for k in d.files:
                out[f"{name}.{run}.{k}"] = d[k]
    np.savez_compressed(OUT_STAGES, **out)
    print(f"wrote {OUT_STAGES}: {os.path.getsize(OUT_STAGES) / 1e3:.1f} kB, "
          f"{len(out)} arrays", flush=True)


OUT_ASYNC_DEVICE = os.path.join(HERE, "async_device.npz")
ASYNC_DEVICE_DIR = os.path.join(HERE, "..", "..", "build", "async_device")
# ab_async_device.py's defaults: scale 2, 120 frames, 1.15 turns, seed 3;
# the depths recorded: the CPU tests', chip_smoke.py's two and the full
# length (each the first frames of the 120-frame circuit)
ASYNC_DEVICE_FRAMES, ASYNC_DEVICE_TURNS, ASYNC_DEVICE_SEED = 120, 1.15, 3
ASYNC_DEVICE_DEPTHS = (8, 16, 40, 120)
ASYNC_DEVICE_NOISE = 4
ASYNC_DEVICE_ARMS = (("sync", False), ("async_dev1", True))


def async_device_inputs(n):
    """ab_async_device.py's scene and frames, its lines verbatim, cut to
    the first n of the 120-frame circuit: (cfg, poses, rendered, sems)."""
    from object_slam_tpu.datasets.synthetic import loop_trajectory
    ab = load_script("ab_deviations")
    cfg = ab.build_cfg(2)
    scene = SyntheticScene.make(cfg, seed=ASYNC_DEVICE_SEED, n_objects=3,
                                plane_z=4.0)
    poses = loop_trajectory(ASYNC_DEVICE_FRAMES,
                            sweep=2 * np.pi * ASYNC_DEVICE_TURNS)[:n]
    rendered = [scene.render_rgbd(T) for T in poses]
    sems = [scene.sem_arrays(s, cfg.semantic.max_instances)
            for (_, _, _, s) in rendered]
    return cfg, poses, rendered, sems


def run_async_device(cfg, poses, rendered, sems, async_mapping,
                     noise=None):
    """One arm of ab_async_device.py: its run() loop verbatim, with
    ready() pinned to "a pass is pending" (the reference's ready() merges
    on the staged path when the device is done, which is timing), the
    dispatches and merges counted (AsyncRecorder) and, with noise (seed,
    pin_frames), one-ulp noise in every mapping pass's input and the
    keyframe decisions of pin_frames (pinned_noise; pin_frames None: the
    noise alone, ulp_noise). Returns the script's dict and what the port
    is held to."""
    import time
    from object_slam_tpu.slam import system as jsys
    ready = jsys._AsyncMapping.ready
    jsys._AsyncMapping.ready = lambda self: self.pending is not None
    try:
        sys_ = SlamSystem(cfg, enable_objects=True,
                          async_mapping=async_mapping)
        if noise is not None and noise[1] is None:
            ulp_noise(sys_, noise[0])
        elif noise is not None:
            pinned_noise(sys_, *noise)
        arec = AsyncRecorder(sys_)
        inserts = []
        jit_insert = sys_._jit_insert

        def insert(m, frame, Tcw, kp_pt, spawn, fid):
            inserts.append(int(fid))
            return jit_insert(m, frame, Tcw, kp_pt, spawn, fid)
        sys_._jit_insert = insert
        lags, lag_at = [], []
        dispatch_frame, last_pending_kf = -1, -1
        t0 = time.perf_counter()
        times = []
        for i, (T, (gray, depth, rgb, _)) in enumerate(zip(poses,
                                                           rendered)):
            tf0 = time.perf_counter()
            sys_.track_rgbd(gray, depth, rgb, sems[i], timestamp=i / 30.0)
            times.append(time.perf_counter() - tf0)
            lag = -1
            if sys_._async is not None and sys_._async.pending is not None:
                if sys_._async.pending_kf != last_pending_kf:
                    dispatch_frame, last_pending_kf = (
                        i, sys_._async.pending_kf)
                lags.append(i - dispatch_frame)
                lag = i - dispatch_frame
            lag_at.append(lag)
        total = time.perf_counter() - t0
        sys_.flush_mapping()
    finally:
        jsys._AsyncMapping.ready = ready
    errs = []
    for rec, T in zip(sys_.trajectory, poses):
        if rec.tracked:
            errs.append(np.linalg.norm(rec.Tcw[:3, 3] - T[:3, 3]))
    dev = ("dev1" if (sys_._async is not None
                      and sys_._async.device is not None) else "dev0")
    res = {
        "async": async_mapping, "mapping_device": dev,
        "fps": len(poses) / total,
        "median_frame_ms": float(np.median(times) * 1e3),
        "ate_rmse_mm": float(np.sqrt(np.mean(np.square(errs))) * 1e3),
        "keyframes": sys_.n_keyframes,
        "tracked": sum(1 for r in sys_.trajectory if r.tracked),
        "frames_with_pending_pass": len(lags),
        "merge_lag_frames_max": int(max(lags)) if lags else 0,
        "merge_lag_frames_median": float(np.median(lags)) if lags else 0.0,
    }
    m = sys_.map
    kf_valid = np.asarray(m.kf_valid)
    return {
        "result": np.asarray(json.dumps(res)),
        "tracked": np.asarray([r.tracked for r in sys_.trajectory]),
        "rec_tcw": np.stack([r.Tcw for r in sys_.trajectory]).astype(
            np.float32),
        "inserts": np.asarray(inserts, np.int32),
        "kf_frames": np.asarray(m.kf_frame_id)[kf_valid].astype(np.int32),
        "n_points": np.int32(int(np.sum(np.asarray(m.pt_valid)))),
        "dispatches": np.int32(arec.dispatches),
        "fast_dispatches": np.int32(arec.fast),
        "merges": np.int32(arec.merges),
        "lag": np.asarray(lag_at, np.int32),
    }


def async_device_path(part):
    os.makedirs(ASYNC_DEVICE_DIR, exist_ok=True)
    return os.path.join(ASYNC_DEVICE_DIR, part.replace(":", "_") + ".npz")


ASYNC_DEVICE_PARTS = ([f"{n}:main" for n in ASYNC_DEVICE_DEPTHS]
                      + [f"{n}:noise{k}" for n in ASYNC_DEVICE_DEPTHS
                         for k in range(ASYNC_DEVICE_NOISE)])


def record_async_device(part):
    """async_device:<n>:<run> (run main, or noise<k> after the depth's
    main, or free<k>: the noise with the run's own decisions): both arms
    at depth n, saved under build/async_device/; async_device:merge
    collects the main and noise runs into async_device.npz under
    <n>.<arm>.<run>, async_device:free_merge adds the free runs found."""
    import glob
    import time
    if part == "free_merge":
        with np.load(OUT_ASYNC_DEVICE) as d:
            out = {k: d[k] for k in d.files}
        for path in sorted(glob.glob(os.path.join(ASYNC_DEVICE_DIR,
                                                  "*_free*.npz"))):
            n, run = os.path.basename(path)[:-4].split("_")
            with np.load(path) as d:
                out.update({f"{n}.{k.split('.', 1)[0]}.{run}."
                            f"{k.split('.', 1)[1]}": d[k]
                            for k in d.files if "." in k})
        np.savez_compressed(OUT_ASYNC_DEVICE, **out)
        print(f"wrote {OUT_ASYNC_DEVICE}: "
              f"{os.path.getsize(OUT_ASYNC_DEVICE) / 1e3:.1f} kB, "
              f"{len(out)} arrays", flush=True)
        return
    if part != "merge":
        n, run = part.split(":")
        n = int(n)
        assert len(jax.devices()) == 8, "run with the 8-device mesh"
        cfg, poses, rendered, sems = async_device_inputs(n)
        out = {"gray_sum": np.asarray([np.sum(g, dtype=np.float64)
                                       for g, _, _, _ in rendered]),
               "n_devices": np.int32(len(jax.devices()))}
        main = None
        if run.startswith("noise"):
            with np.load(async_device_path(f"{n}:main")) as d:
                main = {k: d[k] for k in d.files}
        for arm, flag in ASYNC_DEVICE_ARMS:
            noise = None
            if run.startswith("free"):
                noise = (1000 * n + 500 + int(run[len("free"):])
                         + 17 * flag, None)
            elif main is not None:
                noise = (1000 * n + int(run[len("noise"):]) + 17 * flag,
                         main[f"{arm}.inserts"])
            t0 = time.perf_counter()
            rec = run_async_device(cfg, poses, rendered, sems, flag, noise)
            print(f"async_device {part} {arm}: {rec['result']} "
                  f"inserts {rec['inserts'].tolist()} dispatches "
                  f"{int(rec['dispatches'])} merges {int(rec['merges'])} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            out.update({f"{arm}.{k}": v for k, v in rec.items()})
        np.savez_compressed(async_device_path(part), **out)
        return
    out = {}
    for p in ASYNC_DEVICE_PARTS:
        n, run = p.split(":")
        with np.load(async_device_path(p)) as d:
            for k in d.files:
                if k in ("gray_sum", "n_devices"):
                    if run == "main":
                        out[f"{n}.{k}"] = d[k]
                    continue
                arm, key = k.split(".", 1)
                out[f"{n}.{arm}.{run}.{key}"] = d[k]
    np.savez_compressed(OUT_ASYNC_DEVICE, **out)
    print(f"wrote {OUT_ASYNC_DEVICE}: "
          f"{os.path.getsize(OUT_ASYNC_DEVICE) / 1e3:.1f} kB, {len(out)} "
          f"arrays", flush=True)


OUT_SCALING = os.path.join(HERE, "scaling.npz")
# bench_ba_scaling.py at a small size: --kf 8 --pts 512 --iters 3
SCALING_SIZE = (8, 512, 3)
SCALING_MESH = (1, 2, 4)
SCALING_NOISE = 4


def scaling_problem(n_kf, n_pt):
    """bench_ba_scaling.py's problem, its lines verbatim."""
    from object_slam_tpu.geometry import se3, camera as cam_mod
    K = cam_mod.Intrinsics.from_config(SlamConfig().camera)
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-3, 3, (n_pt, 3)).astype(np.float32)
                      + np.array([0, 0, 6], np.float32))
    poses = jnp.stack([se3.exp(jnp.asarray(
        rng.normal(0, 0.1, 6).astype(np.float32))) for _ in range(n_kf)])
    obs_kf = jnp.asarray(np.repeat(np.arange(n_kf), n_pt // 4))
    obs_pt = jnp.asarray(rng.randint(0, n_pt, obs_kf.shape[0]))
    pc = jnp.einsum('oij,oj->oi', poses[obs_kf, :3, :3], pts[obs_pt]) \
        + poses[obs_kf, :3, 3]
    z = jnp.maximum(pc[:, 2], 1e-3)
    uv = jnp.stack([K.fx * pc[:, 0] / z + K.cx,
                    K.fy * pc[:, 1] / z + K.cy], -1)
    prob = BAProblem(
        kf_pose=poses, kf_fixed=jnp.zeros(n_kf, bool).at[0].set(True),
        kf_valid=jnp.ones(n_kf, bool),
        pt_xyz=pts + 0.01, pt_valid=jnp.ones(n_pt, bool),
        obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=uv,
        obs_ur=uv[:, 0] - K.bf / z,
        obs_inv_sigma2=jnp.ones(obs_kf.shape[0]),
        obs_valid=z > 0.1)
    return K, prob


def record_scaling():
    """bench_ba_scaling.py's problem at SCALING_SIZE through
    make_sharded_ba at each mesh size of SCALING_MESH, and SCALING_NOISE
    runs of each with the initial points scaled by (1 + u), |u| <= 6e-8
    (at most one float32 ulp)."""
    from jax.sharding import Mesh
    from object_slam_tpu.parallel.sharded_ba import make_sharded_ba, \
        pad_obs_to
    n_kf, n_pt, iters = SCALING_SIZE
    devices = jax.devices()
    assert len(devices) >= max(SCALING_MESH), "run with the 4-device mesh"
    K, prob = scaling_problem(n_kf, n_pt)
    out = {f"prob.{f}": np.asarray(getattr(prob, f))
           for f in BAProblem._fields}
    out["size"] = np.asarray(SCALING_SIZE, np.int32)
    for nd in SCALING_MESH:
        mesh = Mesh(np.asarray(devices[:nd]).reshape(-1), ('ba',))
        fn = make_sharded_ba(K, mesh, n_iters=iters)
        runs = [("main", prob)]
        for k in range(SCALING_NOISE):
            u = np.random.RandomState(100 + k).uniform(-6e-8, 6e-8,
                                                       (n_pt, 3))
            xyz = (np.asarray(prob.pt_xyz) * (1.0 + u)).astype(np.float32)
            runs.append((f"noise{k}", prob._replace(pt_xyz=jnp.asarray(xyz))))
        for run, p in runs:
            kf, pt = fn(pad_obs_to(p, nd))
            out[f"mesh{nd}.{run}.kf_pose"] = np.asarray(kf)
            out[f"mesh{nd}.{run}.pt_xyz"] = np.asarray(pt)
        d_kf = max(float(np.abs(out[f"mesh{nd}.noise{k}.kf_pose"]
                                - out[f"mesh{nd}.main.kf_pose"]).max())
                   for k in range(SCALING_NOISE))
        print(f"scaling: mesh {nd}: noise spread of the poses {d_kf:.3g}",
              flush=True)
    np.savez_compressed(OUT_SCALING, **out)
    print(f"wrote {OUT_SCALING}: {os.path.getsize(OUT_SCALING) / 1e3:.1f} "
          f"kB", flush=True)


def main():
    parts = sys.argv[1:] or ["slice1", "objects", "tum_vga", "pipelined",
                             "kidnap", "pipelined_tum_vga", "kidnap_tum_vga",
                             "stereo", "kitti_stereo", "kitti_pass",
                             "kitti_objects", "loop_small",
                             "loop_circuit_tum_vga", "kidnap_loop_tum_vga",
                             "mono_small", "mono_euroc", "localization_small",
                             "localization_tum_vga", "euroc_driver",
                             "parallel", "batched"]
    if "slice1" in parts:
        out = {}
        record_local_ba(out)
        record_system(out)
        np.savez_compressed(OUT, **out)
        print(f"wrote {OUT}: {os.path.getsize(OUT) / 1e6:.2f} MB, "
              f"{len(out)} arrays", flush=True)
    if "objects" in parts:
        out = {}
        record_objects(out)
        np.savez_compressed(OUT_OBJECTS, **out)
        print(f"wrote {OUT_OBJECTS}: "
              f"{os.path.getsize(OUT_OBJECTS) / 1e6:.2f} MB, "
              f"{len(out)} arrays", flush=True)
    if "tum_vga" in parts:
        record_tum_vga()
    for name, path, fn in (("pipelined", OUT_PIPELINED, record_pipelined),
                           ("kidnap", OUT_KIDNAP, record_kidnap)):
        if name in parts:
            out = {}
            fn(out)
            np.savez_compressed(path, **out)
            print(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB, "
                  f"{len(out)} arrays", flush=True)
    if "pipelined_tum_vga" in parts:
        record_pipelined_tum_vga()
    if "kidnap_tum_vga" in parts:
        record_kidnap_tum_vga()
    if "stereo" in parts:
        record_street("stereo", STEREO_FRAMES, OUT_STEREO)
    if "kitti_stereo" in parts:
        record_street("kitti", KITTI_FRAMES, OUT_KITTI)
    if "kitti_pass" in parts:
        record_kitti_pass()
    if "kitti_objects" in parts:
        record_kitti_objects()
    if "loop_small" in parts:
        record_loop_small()
    if "loop_pass_tum_vga" in parts:
        record_loop_circuit("main")
    for p in parts:
        # loop_circuit_tum_vga: every part in turn; loop_circuit_tum_vga:
        # <part> one of them (main, off, noise<k>, merge), for parallel runs
        if p == "loop_circuit_tum_vga":
            for part in (["main", "off"]
                         + [f"{kind}{k}" for kind in ("pin", "noise")
                            for k in range(LOOP_NOISE_RUNS)] + ["merge"]):
                record_loop_circuit(part)
        elif p.startswith("loop_circuit_tum_vga:"):
            record_loop_circuit(p.split(":", 1)[1])
    if "kidnap_loop_tum_vga" in parts:
        record_kidnap_loop_tum_vga()
    for p in parts:
        # mono_small / mono_euroc: every part in turn; mono_<kind>:<part>
        # one of them (main, pinned, noise<k>, merge), for parallel runs
        for kind in MONO_RUNS:
            if p == f"mono_{kind}":
                for part in (["main", "pinned"]
                             + [f"noise{k}" for k in range(MONO_RUNS[kind][5])]
                             + [f"seed{k}" for k in range(1, 4)]
                             + ["merge"]):
                    record_mono(kind, part)
            elif p.startswith(f"mono_{kind}:"):
                record_mono(kind, p.split(":", 1)[1])
    if "localization_small" in parts:
        record_localization_small()
    if "localization_tum_vga" in parts:
        record_localization_tum_vga()
    if "euroc_driver" in parts:
        record_euroc_driver()
    if "parallel" in parts:
        record_parallel()
    if "batched" in parts:
        record_batched()
    if "pnp_cases" in parts:
        record_pnp_cases()
    if "pnp_cases_noise" in parts:
        record_pnp_cases_noise()
    if "experiments" in parts:
        record_experiments()
    if "experiments_tiny" in parts:
        record_experiments_tiny()
    if "xla_resize" in parts:
        record_xla_resize()
    if "vocab" in parts:
        record_vocab()
    if "vocab_counts" in parts:
        record_vocab_counts()
    if "brief" in parts:
        record_brief()
    if "harvest_cpu" in parts:
        record_harvest_cpu()
    if "harvest_cpu:brief" in parts:
        record_harvest_cpu(("brief",))
    if "kitti_pass_noise" in parts:
        record_kitti_pass_noise()
    for p in parts:
        # studies: every part in turn; studies:<part> one of them
        if p == "studies":
            for part in STUDY_PARTS:
                record_studies(part)
        elif p.startswith("studies:"):
            record_studies(p.split(":", 1)[1])
    for p in parts:
        # probes: every part in turn, then merge; probes:<part> one of them
        if p == "probes":
            for part in (["pose"] + probe_parts("small") + probe_parts("vga")
                         + ["merge"]):
                record_probes(part)
        elif p.startswith("probes:"):
            record_probes(p.split(":", 1)[1])
    for p in parts:
        # stages: every part in turn, then merge; stages:<part> one of them
        if p == "stages":
            for part in STAGE_PARTS + ["merge"]:
                record_stages(part)
        elif p.startswith("stages:"):
            record_stages(p.split(":", 1)[1])
    for p in parts:
        # loop_small_noise: every part in turn; loop_small_noise:<part>
        # one of them (noise<k>, merge), for parallel runs
        if p == "loop_small_noise":
            for part in ([f"noise{k}" for k in range(LOOP_SMALL_NOISE_RUNS)]
                         + ["merge"]):
                record_loop_small_noise(part)
        elif p.startswith("loop_small_noise:"):
            record_loop_small_noise(p.split(":", 1)[1])
    for p in parts:
        # async_device: every part in turn, then merge;
        # async_device:<depth>:<run> or async_device:merge one of them
        if p == "async_device":
            for part in ASYNC_DEVICE_PARTS + ["merge"]:
                record_async_device(part)
        elif p.startswith("async_device:"):
            record_async_device(p.split(":", 1)[1])
    if "scaling" in parts:
        record_scaling()


if __name__ == "__main__":
    main()
