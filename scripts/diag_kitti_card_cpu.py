#!/usr/bin/env python
"""Where the port's KITTI run on the card first parts from the same run on
the CPU.

    python scripts/diag_kitti_card_cpu.py dump --device cuda --out A.npz
        [--frames 9] [--async-mapping]
    python scripts/diag_kitti_card_cpu.py dump --device cpu --out B.npz
    python scripts/diag_kitti_card_cpu.py compare A.npz B.npz

``dump`` renders the first --frames frames of chip_smoke.py's 24-frame
street-canyon drive, runs SlamSystem(SlamConfig.kitti_stereo(), objects
on, inline or async mapping, the default fused pipelined path, its own
keyframe decisions) over them on --device, prints the keyframe frames, the ATE
and how far its records lie from the JAX run's of the same mode
(kitti_stereo.npz), and saves, per frame, the built frame's
keypoints by stage (detection: uv, level, response; description: angle,
descriptor; stereo match: ur, depth), the packed tracking readback, and
after each mapping pass the map's valid points and keyframe poses.
``compare`` walks the frames in order and prints, for each, the stages
whose outputs differ between the two dumps and by how much (the largest
absolute difference of a float field, the count of differing entries of
an integer one), then one JSON line naming the first frame and stage that
differ. Frame builds depend on the frame's images only, so the first
differing build stage is where the devices part; tracking and mapping
differences before it come from their own arithmetic.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

DRIVE_FRAMES = 24
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "torch_fixtures", "kitti_stereo.npz")
STAGES = (("detect", ("uv", "level", "response", "valid")),
          ("describe", ("angle", "desc")),
          ("stereo", ("ur", "depth")))


def dump(args):
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import render_street
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = SlamConfig.kitti_stereo()
    poses, frames, secs = render_street(cfg, DRIVE_FRAMES, 0, args.frames)
    print(f"rendered {len(frames)} pairs in {secs:.1f} s", flush=True)
    sys_ = SlamSystem(cfg, enable_objects=True,
                      async_mapping=args.async_mapping, device=args.device)
    out = {}
    build = sys_.builder.build_stereo

    def build_stereo(*a, **k):
        fr = build(*a, **k)
        i = sys_.frame_id
        for _, fields in STAGES:
            for f in fields:
                out[f"f{i}.{f}"] = getattr(fr, f).cpu().numpy()
        return fr
    sys_.builder.build_stereo = build_stereo
    need_kf = sys_._need_keyframe

    def need_keyframe(pend, p):
        d = need_kf(pend, p)
        out[f"f{pend['fid']}.packed"] = np.array(p, np.float32)
        out[f"f{pend['fid']}.need_kf"] = np.bool_(d)
        out[f"f{pend['fid']}.kf_inliers"] = np.float32(sys_._kf_inliers)
        return d
    sys_._need_keyframe = need_keyframe
    passes = []
    mapping_pass = sys_._mapping_pass

    def run_pass(m, kf_id, fast):
        m = mapping_pass(m, kf_id, fast)
        k = len(passes)
        passes.append(int(kf_id))
        out[f"p{k}.kf"] = np.int32(kf_id)
        out[f"p{k}.pt_valid"] = m.pt_valid.cpu().numpy()
        out[f"p{k}.pt_xyz"] = m.pt_xyz.cpu().numpy()[out[f"p{k}.pt_valid"]]
        out[f"p{k}.kf_pose"] = m.kf_pose[m.kf_valid].cpu().numpy()
        return m
    sys_._mapping_pass = run_pass
    for i, (gl, gr, sa) in enumerate(frames):
        sys_.track_stereo(gl, gr, None, sa, timestamp=i / 10.0)
    sys_.flush_mapping()
    if args.device != "cpu":
        torch.cuda.synchronize()
    out["frames"] = np.int32(args.frames)
    out["rec_tcw"] = np.stack([r.Tcw for r in sys_.trajectory])
    ok = np.asarray([r.tracked for r in sys_.trajectory])
    fin = np.stack([t[1] for t in sys_.final_trajectory()])
    ate = ate_rmse(np.stack([np.linalg.inv(T)[:3, 3] for T in fin])[ok],
                   np.stack([np.linalg.inv(T)[:3, 3] for T in poses])[ok])
    m = sys_.map
    out["kf_frames"] = m.kf_frame_id[m.kf_valid].cpu().numpy()
    sys_.shutdown()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    inl = [int(out[f"f{i}.packed"][trk.PACKED_N_INLIERS])
           for i in range(args.frames) if f"f{i}.packed" in out]
    mode = "async" if args.async_mapping else "sync"
    ref = np.load(REF)
    n = min(len(out["rec_tcw"]), len(ref[f"{mode}.rec_tcw"]))
    d = np.linalg.norm(out["rec_tcw"][:n, :3, 3]
                       - ref[f"{mode}.rec_tcw"][:n, :3, 3], axis=1)
    print(f"{args.device} {mode}: records at most {d.max() * 1e3:.4f} mm "
          f"from the JAX {mode} run's (kitti_stereo.npz, reference KFs "
          f"{ref[f'{mode}.kf_frames'].tolist()}); ATE {ate * 1e3:.4f} mm "
          f"(JAX {float(ref[f'{mode}.ate']) * 1e3:.4f} mm over 24 frames)",
          flush=True)
    print(f"{args.device} {mode}: KFs at {out['kf_frames'].tolist()}; "
          f"passes at "
          f"keyframes {passes}; n_inliers per tracked frame {inl}; wrote "
          f"{args.out}", flush=True)


def _diff(a, b):
    if a.shape != b.shape:
        return f"shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f":
        both = np.isfinite(a) & np.isfinite(b)
        e = float(np.max(np.abs(a[both] - b[both]))) if both.any() else 0.0
        n = int(np.sum(np.isfinite(a) != np.isfinite(b)))
        return None if e == 0 and n == 0 else round(e, 9) if n == 0 \
            else f"{e:.9g}, {n} finite/non-finite"
    n = int(np.sum(a != b))
    return None if n == 0 else f"{n} of {a.size}"


def compare(args):
    from object_slam_tpu_torch.slam import tracking as trk
    A, B = np.load(args.a), np.load(args.b)
    n = int(A["frames"])
    first = None
    for i in range(n):
        row = {}
        for stage, fields in STAGES:
            d = {f: _diff(A[f"f{i}.{f}"], B[f"f{i}.{f}"]) for f in fields}
            d = {f: v for f, v in d.items() if v is not None}
            if d:
                row[stage] = d
        if f"f{i}.packed" in A.files and f"f{i}.packed" in B.files:
            pa, pb = A[f"f{i}.packed"], B[f"f{i}.packed"]
            d = {}
            e = _diff(pa[trk.PACKED_TCW], pb[trk.PACKED_TCW])
            if e is not None:
                d["Tcw"] = e
            for name, k in (("n_inliers", trk.PACKED_N_INLIERS),
                            ("need_kf", trk.PACKED_NEED_KF),
                            ("need_kf_hard", trk.PACKED_NEED_KF_HARD)):
                if pa[k] != pb[k]:
                    d[name] = f"{pa[k]:g} / {pb[k]:g}"
            if bool(A[f"f{i}.need_kf"]) != bool(B[f"f{i}.need_kf"]):
                d["decision"] = (f"{bool(A[f'f{i}.need_kf'])} / "
                                 f"{bool(B[f'f{i}.need_kf'])}, inlier peak "
                                 f"since the last keyframe "
                                 f"{float(A[f'f{i}.kf_inliers']):g} / "
                                 f"{float(B[f'f{i}.kf_inliers']):g}")
            if d:
                row["track"] = d
        print(f"frame {i}: {json.dumps(row) if row else 'equal'}",
              flush=True)
        if row and first is None:
            first = {"frame": i, "stages": sorted(row)}
    k = 0
    while f"p{k}.kf" in A.files and f"p{k}.kf" in B.files:
        d = {f: _diff(A[f"p{k}.{f}"], B[f"p{k}.{f}"])
             for f in ("pt_valid", "pt_xyz", "kf_pose")}
        print(f"mapping pass {k} (keyframe {int(A[f'p{k}.kf'])}): "
              f"{json.dumps({f: v for f, v in d.items() if v is not None})}",
              flush=True)
        k += 1
    print(json.dumps({"first_difference": first,
                      "kf_frames": [A["kf_frames"].tolist(),
                                    B["kf_frames"].tolist()]}))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--device", default="cuda")
    d.add_argument("--frames", type=int, default=9)
    d.add_argument("--out", required=True)
    d.add_argument("--async-mapping", action="store_true")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    dump(args) if args.cmd == "dump" else compare(args)


if __name__ == "__main__":
    main()
