#!/usr/bin/env python
"""Time each per-frame and per-keyframe device stage at KITTI capacities
with the PyTorch port (the counterpart of scripts/diag_kitti_stages.py):
SlamConfig.kitti_stereo(), objects on, inline mapping, the first 12
frames of a KITTI directory through track_stereo (float images, rgb the
left image three times), then eleven stages on the map, the last frame
and the frame before it, each ms per call over 5 calls after one warm
call: the stereo frame build, the fused tracking step, keyframe
insertion, the local-mapping pass, covisibility, the point-statistics
refresh, point culling, triangulation, fusion, local BA and keyframe
culling, with the reference's arguments. Runs on the CUDA card unless
given --device cpu.

Usage: python scripts/diag_kitti_stages_torch.py [SEQ] [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

N_FRAMES = 12
# the reference's stages, in its order
STAGES = ("build_stereo", "fused", "insert", "mapping", "covisibility",
          "recompute_stats", "cull_points", "triangulate", "fuse",
          "local_ba", "cull_kfs")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq", nargs="?", default="/tmp/synth_kitti2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def map_counts(m):
    """A map's census: valid keyframes and points, keypoint-to-point
    bindings of valid keyframes, and the valid points' observation,
    visible and found counts summed."""
    kf_valid, pt_valid = _np(m.kf_valid), _np(m.pt_valid)
    return {"kfs": int(kf_valid.sum()), "pts": int(pt_valid.sum()),
            "obs": int(((_np(m.kf_kp_pt) >= 0) & kf_valid[:, None]).sum()),
            "n_obs": int(_np(m.pt_n_obs)[pt_valid].sum()),
            "visible": int(_np(m.pt_visible)[pt_valid].sum()),
            "found": int(_np(m.pt_found)[pt_valid].sum())}


def stage_counts(name, out, m, kf_id):
    """What a stage's output leaves, as counts: the change of the map's
    census it returns (points spawned, fused or culled, bindings made or
    erased, keyframes culled), and per stage the tracking step's inliers
    and flags from its packed readback, the inserted keyframe's slot, the
    covisibility weights' sum, nonzero entries and the keyframe's row sum,
    the built frame's keypoints with depth."""
    if name == "build_stereo":
        v = _np(out.valid)
        return {"kps": int(v.sum()), "depth": int((v & (_np(out.depth) > 0))
                                                  .sum())}
    if name == "covisibility":
        W = _np(out)
        return {"sum": int(W.sum()), "nnz": int((W > 0).sum()),
                "row": int(W[kf_id].sum())}
    res = {}
    if name == "fused":
        p = _np(out[3])
        res = {"inliers": int(p[50]), "ok": int(p[48] > 0.5),
               "need_kf": int(p[49] > 0.5), "need_kf_hard": int(p[57] > 0.5)}
        out = out[0]
    elif name == "insert":
        res = {"kf_id": int(out[1])}
        out = out[0]
    before, after = map_counts(m), map_counts(out)
    res.update({f"d_{k}": after[k] - before[k] for k in after})
    return res


def stage_calls(sys_, m, frame, last, kf_id, pair):
    """The eleven stages as closures of no arguments, with the reference
    script's arguments (frames_since_kf 1, frame_id 11, last_kf_inliers
    500; 5 neighbours, 8 fixed keyframes, recency_scope for the point
    culling)."""
    import torch
    from object_slam_tpu_torch.slam import local_mapping, map_ops
    from object_slam_tpu_torch.slam.map_state import (covisibility,
                                                      recompute_point_stats)
    cfg = sys_.cfg
    gl, gr, rgb, sa = pair
    eye = torch.eye(4, dtype=torch.float32, device=sys_.device)
    spawn = frame.valid & (frame.depth > 0)
    b = sys_.builder
    return {
        "build_stereo": lambda: b.build_stereo(gl, gr, rgb,
                                               b.pack_sem_arrays(sa), 0.0),
        "fused": lambda: sys_._fused_impl(m, frame, last, eye, kf_id, 1, 11,
                                          500),
        "insert": lambda: sys_._insert_impl(m, frame, frame.Tcw,
                                            frame.kp_pt, spawn, 11),
        "mapping": lambda: sys_._mapping_pass(m, kf_id, False),
        "covisibility": lambda: covisibility(m),
        "recompute_stats": lambda: recompute_point_stats(m),
        "cull_points": lambda: map_ops.cull_points(m, kf_id,
                                                   recency_scope=True),
        "triangulate": lambda: map_ops.triangulate_new_points(
            m, kf_id, n_neighbors=5, K=sys_.K,
            inv_sigma2_lvl=sys_.inv_sigma2,
            scale_factors=sys_.scale_factors),
        "fuse": lambda: map_ops.fuse_into_neighbors(
            m, kf_id, n_neighbors=5, K=sys_.K,
            scale_factors=sys_.scale_factors,
            inv_sigma2_lvl=sys_.inv_sigma2),
        "local_ba": lambda: local_mapping.run_local_ba(
            K=sys_.K, m=m, kf_id=kf_id, window=cfg.caps.local_window_kf,
            n_fixed=8, inv_sigma2_lvl=sys_.inv_sigma2),
        "cull_kfs": lambda: map_ops.cull_keyframes(
            m, kf_id, scale_condition=False, n_levels=cfg.orb.n_levels),
    }


def kf_replay(kf_frames, decisions):
    """A hook giving each fused frame the keyframe decision of a recorded
    run (frame in kf_frames), its own decision and inliers kept in
    decisions[frame]."""
    from object_slam_tpu_torch.slam import tracking as trk
    want = set(int(f) for f in kf_frames)

    def hook(sys_):
        own = sys_._need_keyframe

        def need_keyframe(pend, p):
            decisions[pend["fid"]] = (own(pend, p),
                                      int(p[trk.PACKED_N_INLIERS]))
            return pend["fid"] in want
        sys_._need_keyframe = need_keyframe
    return hook


def drive(cfg, seq, device=None, n_frames=N_FRAMES, kf_frames=None,
          on_system=None):
    """The drive over the first n_frames of seq (kf_frames: the keyframe
    decisions to replay; on_system(sys_): a hook before the first frame).
    Returns the state the stages run on: {"sys", "map", "frame", "last",
    "kf_id", "pair" (the last frame's images and detections),
    "kf_frames" (the frames a keyframe was inserted on), "decisions"
    ({frame: (own decision, inliers)} where replayed)}; the caller shuts
    the system down."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.slam.system import SlamSystem

    frames = kitti.load_sequence(seq)[:n_frames]
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=False,
                      device=device)
    decisions = {}
    if kf_frames is not None:
        kf_replay(kf_frames, decisions)(sys_)
    if on_system is not None:
        on_system(sys_)
    inserts = []
    insert_impl = sys_._insert_impl

    def insert(m, frame, Tcw, kp_pt, close_mask, frame_id):
        inserts.append(int(frame_id))
        return insert_impl(m, frame, Tcw, kp_pt, close_mask, frame_id)
    sys_._insert_impl = insert
    try:
        for fr in frames:
            gl, gr, rgb = kitti.load_frame_arrays(fr)
            sa = kitti.load_semantics(os.path.join(seq, "semantic"),
                                      fr.index, cfg)
            f = sys_.track_stereo(gl, gr, rgb, sa, timestamp=fr.timestamp)
    except BaseException:
        sys_.shutdown()
        raise
    finally:
        sys_._insert_impl = insert_impl
    return {"sys": sys_, "map": sys_.map, "frame": f,
            "last": sys_.last_frame, "kf_id": max(sys_.last_kf_id, 0),
            "pair": (gl, gr, rgb, sa), "kf_frames": inserts,
            "decisions": decisions}


def time_stages(state, reps=5, stages=STAGES, log=print):
    """Every stage of stages on a drive's state, timed over reps calls
    after a warm call (reps 0: the one call timed). Returns {"map":
    map_counts of the state's map, "stages": {name: {"ms", counts of
    stage_counts}}, "map_unchanged": the stages left the map as they
    found it}."""
    import torch
    sys_, m, kf_id = state["sys"], state["map"], state["kf_id"]
    kept = [t.clone() for t in m]

    def sync():
        if sys_.device.type == "cuda":
            torch.cuda.synchronize(sys_.device)

    timed = {}
    calls = stage_calls(sys_, m, state["frame"], state["last"], kf_id,
                        state["pair"])
    for name in stages:
        fn = calls[name]
        t0 = time.perf_counter()
        out = fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        if reps:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            sync()
            ms = (time.perf_counter() - t0) / reps * 1e3
        timed[name] = dict(stage_counts(name, out, m, kf_id), ms=ms)
        log(f"{name:20s} {ms:8.1f} ms")
    return {"map": map_counts(m), "stages": timed,
            "map_unchanged": all(torch.equal(a, b) for a, b in zip(kept, m))}


def run(cfg, seq, device=None, n_frames=N_FRAMES, reps=5, kf_frames=None,
        on_system=None, stages=STAGES, log=print):
    """drive then time_stages: time_stages' result with the drive's
    "kf_frames" and "decisions"."""
    state = drive(cfg, seq, device, n_frames, kf_frames, on_system)
    try:
        res = time_stages(state, reps, stages, log)
    finally:
        state["sys"].shutdown()
    return dict(res, kf_frames=state["kf_frames"],
                decisions=state["decisions"])


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args.seq, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
