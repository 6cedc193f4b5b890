"""Write the JAX reference outputs that the PyTorch port's tests compare with.

The expensive JAX programs (the fused tracking step, keyframe insertion,
the local-mapping pass, local BA and the 12-frame system run) take minutes
to compile on the CPU, so their inputs and outputs are recorded here once
and committed as ``tests/torch_fixtures/slice1.npz``.

Run from the repository root:

    python tests/torch_fixtures/make_reference.py

The configuration is the small verify geometry (160x120, 300 features,
4 levels), scene seed 1, ``orbit_poses(12, step=0.02)``, objects off and
``pipelined_readback=False``. The rendered inputs' checksums are stored so
that the tests can prove they re-render the same frames.
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
                                    OrbConfig, SlamConfig, TrackingConfig)
from object_slam_tpu.datasets.synthetic import (SyntheticScene,  # noqa: E402
                                                orbit_poses)
from object_slam_tpu.eval.ate import ate_rmse  # noqa: E402
from object_slam_tpu.slam.frame import FrameData  # noqa: E402
from object_slam_tpu.slam.map_state import MapState  # noqa: E402
from object_slam_tpu.slam.system import SlamSystem  # noqa: E402
from object_slam_tpu.solvers.ba import BAProblem, local_ba  # noqa: E402
from object_slam_tpu.geometry.camera import Intrinsics  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slice1.npz")
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


def main():
    out = {}
    record_local_ba(out)
    record_system(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {os.path.getsize(OUT) / 1e6:.2f} MB, "
          f"{len(out)} arrays", flush=True)


if __name__ == "__main__":
    main()
