"""Time the port's ORB extraction alone on one CUDA card.

    python scripts/time_torch_extract.py [--root DIR] [--reps 60]

Renders the first frame of chip_smoke.py's sequence (TUM VGA) and times
``OrbExtractor`` on it: host clock around each call, which ends in a
device synchronize; median and mean over ``--reps`` calls after 5
warm-up calls. ``--root`` runs the tree at DIR instead of this one (an
unpacked archive of another commit), so that two versions can be timed
in turns on one card. Prints one JSON object. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=60)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from chip_smoke import card_line, render, tum_cfg
    from object_slam_tpu_torch.features.extractor import OrbExtractor

    cfg = tum_cfg()
    frames = render(cfg, 1)[1]
    img = torch.from_numpy(frames[0][0]).cuda()
    ex = OrbExtractor(cfg, device="cuda")
    times = []
    for i in range(5 + args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kp = ex(img)
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "card": card_line(), "root": os.path.abspath(args.root),
        "reps": args.reps, "extract_ms_median": float(np.median(times)),
        "extract_ms_mean": float(np.mean(times)),
        "n_valid": int(kp.valid.sum())}))


if __name__ == "__main__":
    main()
