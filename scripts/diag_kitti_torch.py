#!/usr/bin/env python
"""Per-frame tracking health on the synthetic KITTI drive with the PyTorch
port (the counterpart of scripts/diag_kitti.py): inliers, ground-truth
translation error, keypoint, depth and close-point counts, detections,
object membership and keyframes. SlamConfig.kitti_stereo(), objects on,
async mapping; the images go in as float32 with rgb the left image three
times, as the reference's probe feeds them. Runs on the CUDA card unless
given --device cpu.

Usage: python scripts/diag_kitti_torch.py --seq DIR [--frames 60]
       [--start 0] [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default="/tmp/synth_kitti")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def run(cfg, args, device=None, log=print, on_system=None):
    """The drive over args' frames: {"frames": [{"f", "inl", "err_m",
    "kps", "depth", "close", "det", "obj3d", "kfs"}]}. on_system(sys_)
    may wrap the system before the first frame."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.png import read_png
    from object_slam_tpu_torch.slam.system import SlamSystem

    frames = kitti.load_sequence(args.seq)[args.start:args.start
                                           + args.frames]
    gt = kitti.load_groundtruth(os.path.join(args.seq, "gt.txt"))
    sys_ = SlamSystem(cfg, enable_objects=True, async_mapping=True,
                      device=device)
    if on_system is not None:
        on_system(sys_)
    per = []
    try:
        for i, fr in enumerate(frames):
            gl = read_png(fr.left_path).astype(np.float32)
            gr = read_png(fr.right_path).astype(np.float32)
            rgb = np.stack([gl] * 3, -1)
            sa = kitti.load_semantics(os.path.join(args.seq, "semantic"),
                                      fr.index, cfg)
            f = sys_.track_stereo(gl, gr, rgb, sa, timestamp=fr.timestamp)
            Twc = np.linalg.inv(_np(f.Tcw))
            gtw = gt[args.start + i]
            err = np.linalg.norm(Twc[:3, 3] - gtw[:3, 3])
            d = _np(f.depth)
            v = _np(f.valid)
            close = (d > 0) & (d < cfg.camera.th_depth * cfg.camera.baseline)
            r = {"f": args.start + i,
                 "inl": int(getattr(sys_, "_last_n_inliers", -1)),
                 "err_m": float(err), "kps": int(v.sum()),
                 "depth": int((d > 0).sum()),
                 "close": int((close & v).sum()),
                 "det": int(_np(f.obj.valid).sum()),
                 "obj3d": _np(f.obj3d)[:3].tolist()}
            r["kfs"] = int(sys_.n_keyframes)
            per.append(r)
            log(f"f={r['f']:3d} inl={r['inl']:4d} err={err:7.3f} "
                f"kps={r['kps']:4d} depth={r['depth']:4d} "
                f"close={r['close']:4d} det={r['det']} "
                f"obj3d={r['obj3d']} kfs={r['kfs']}")
    finally:
        sys_.shutdown()
    return {"frames": per}


def main(argv=None):
    from object_slam_tpu_torch.config import SlamConfig
    args = parse_args(argv)
    return run(SlamConfig.kitti_stereo(), args, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
