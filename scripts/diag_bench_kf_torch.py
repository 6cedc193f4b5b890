"""Print the keyframe decisions of bench.py's protocol on the port, frame
by frame, beside the JAX CPU run's keyframes.

    python scripts/diag_bench_kf_torch.py [--device cuda|cpu]
        [--pyramid own|xla] [--frames 24:35]

Runs chip_smoke.py's bench protocol (the 40 TUM-VGA frames as blobs
through track_rgbd_blob, objects on, the default pipelined readback),
then prints the keyframe frames against tests/torch_fixtures/
pipelined_tum_vga.npz and, for the frames asked for, each decision's
inputs from the fused step's packed readback: ok, need_kf, n_inliers,
n_matches, ref_kf, n_close_tracked, n_close_untracked, motion inliers,
n_semantic, need_kf_hard. ``--pyramid xla`` computes every pyramid with
the CPU's XLA-order taps (features/pyramid.py::resize_taps, the levels
moved to the device), which the card otherwise does not use.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pyramid", choices=("own", "xla"), default="own")
    ap.add_argument("--frames", default="24:35")
    args = ap.parse_args()
    lo, hi = (int(x) for x in args.frames.split(":"))

    import numpy as np
    import torch
    import chip_smoke as cs
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.features import pyramid as pyr
    from object_slam_tpu_torch.slam.system import SlamSystem
    from object_slam_tpu_torch.slam import tracking as trk

    if args.pyramid == "xla":
        own = pyr.resize_linear
        pyr.resize_linear = lambda img, shape, order="auto": own(
            img, shape, "xla")
    decisions = []
    need = SlamSystem._need_keyframe

    def spy(self, pend, p):
        out = need(self, pend, p)
        decisions.append((len(self.trajectory), p[trk.PACKED_OK:58]
                          .tolist(), out))
        return out
    SlamSystem._need_keyframe = spy
    cfg = SlamConfig.tum_rgbd()
    poses, frames, sems = cs.render(cs.tum_cfg(), cs.N_FRAMES)
    ref = np.load(cs.BENCH_REF)
    sys_ = SlamSystem(cfg, enable_objects=True, device=args.device)
    blobs = [cs.to_blob(sys_.builder, cfg, d, rgb, sems[i])
             for i, (_, d, rgb) in enumerate(frames)]
    for i, (blob, iv) in enumerate(blobs):
        sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
    sys_.flush_mapping()
    if sys_.device.type == "cuda":
        torch.cuda.synchronize()
    m = sys_.map
    kfs = m.kf_frame_id[m.kf_valid].cpu().numpy().tolist()
    print(f"{args.device} ({args.pyramid} pyramid): KFs at {kfs}, the JAX "
          f"run's {ref['kf_frames'].tolist()}")
    print("frame: ok, need_kf, n_inliers, n_matches, ref_kf, close tracked, "
          "close untracked, motion inliers, n_semantic, need_kf_hard -> "
          "keyframe")
    for f, p, out in decisions:
        if lo <= f <= hi:
            print(f"{f}: {[round(x, 1) for x in p]} -> {out}")


if __name__ == "__main__":
    main()
