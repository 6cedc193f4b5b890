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
  TUM-VGA frames, which ``chip_smoke.py`` holds the card's run to.

Run from the repository root (all parts, or the ones named):

    python tests/torch_fixtures/make_reference.py [slice1] [objects] [tum_vga]

Every run uses ``pipelined_readback=False``. The rendered inputs'
checksums are stored so that the tests can prove they re-render the same
frames.
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

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


def main():
    parts = sys.argv[1:] or ["slice1", "objects", "tum_vga"]
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


if __name__ == "__main__":
    main()
