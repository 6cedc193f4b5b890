#!/usr/bin/env python
"""Where the async arm of scripts/ab_async_device_torch.py parts from the
reference's keyframe decisions, run by run, and whether the async
mapper's two placements part the same way.

The async arm (ab_async_device_torch.run_arm, objects on, ready() pinned
to "a pass is pending" as the reference's record is: pinned_ready) runs over the first
--depth frames (all by default) of the script's --frames-frame circuit
--repeats times on the async
mapper's own placement (a side stream of the tracker's card, cuda:1 with
a second card, or a thread on the CPU), then once through
_AsyncMapping's second-device branch with the tracker's device on both
sides (the snapshot and the result copied). One JSON line per run: its
placement, keyframes, dispatches, merges, merge lags, points, ATE, the
first frame whose keyframe decision or merge lag parts from the first
run's and from the reference's record, and whether its records equal
the first run's bit for bit. Then one line with the record's own runs at
this depth: for each noise run, its keyframes and the first frame where
it parts from the record's main run (noise<k>: one-ulp noise with the
main run's decisions pinned; free<k>: the noise with its own decisions,
where the record has them). The record is
tests/torch_fixtures/async_device.npz (make_reference.py
``async_device``); the comparisons with it are null unless the circuit
is the record's (--frames 120, --scale 2, --turns 1.15, --seed 3, a
recorded depth).

Usage: python scripts/diag_async_split_torch.py [--frames 120]
       [--depth N] [--repeats 2] [--device cuda|cpu] [--out F.json]
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

REFERENCE = os.path.join(HERE, "..", "tests", "torch_fixtures",
                         "async_device.npz")
ARM = "async_dev1"
RECORD_ARGS = {"frames": 120, "scale": 2, "turns": 1.15, "seed": 3}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--depth", type=int, default=None,
                    help="run the first this many frames of the circuit")
    ap.add_argument("--scale", type=int, default=2)
    ap.add_argument("--turns", type=float, default=1.15)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2,
                    help="runs on the async mapper's own placement")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="write the JSON record")
    args = ap.parse_args(argv)
    args.depth = args.depth or args.frames
    return args


def parts_at(a, b):
    """The first frame whose keyframe decision or merge lag differs
    between runs a and b ({"inserts", "lag"}), or None."""
    ia, ib = set(map(int, a["inserts"])), set(map(int, b["inserts"]))
    for i in range(min(len(a["lag"]), len(b["lag"]))):
        if (i in ia) != (i in ib) or int(a["lag"][i]) != int(b["lag"][i]):
            return i
    return None


def recorded(args):
    """{run: {"inserts", "lag", "keyframes"}} of the record's runs of the
    async arm at depth args.depth, or None when the circuit is not the
    record's."""
    if any(getattr(args, k) != v for k, v in RECORD_ARGS.items()):
        return None
    with np.load(REFERENCE) as fx:
        p = f"{args.depth}.{ARM}."
        runs = sorted({k[len(p):].split(".")[0] for k in fx.files
                       if k.startswith(p)})
        return {r: {"inserts": fx[f"{p}{r}.inserts"],
                    "lag": fx[f"{p}{r}.lag"],
                    "keyframes": json.loads(str(fx[f"{p}{r}.result"]))[
                        "keyframes"]} for r in runs} or None


def run(cfg, args, log=print):
    """The runs of the module docstring: (their lines, the record's
    line)."""
    import ab_async_device_torch as ab
    poses, frames, sems = ab.inputs(cfg, args, args.depth)
    ref = recorded(args)
    main = ref["main"] if ref else None
    lines, first = [], None
    for name, hook in ([("own placement", None)] * args.repeats
                       + [("second-device branch", ab.second_device)]):
        with ab.pinned_ready():
            res, det = ab.run_arm(cfg, poses, frames, sems, True,
                                  args.device, hook)
        first = first or det
        line = {
            "run": name, "mapping_placement": res["mapping_placement"],
            "keyframes": res["keyframes"], "dispatches": det["dispatches"],
            "merges": det["merges"],
            "merge_lag_frames_max": res["merge_lag_frames_max"],
            "merge_lag_frames_median": res["merge_lag_frames_median"],
            "points": det["n_points"], "ate_rmse_mm": res["ate_rmse_mm"],
            "parts_from_first_run_at": parts_at(det, first),
            "records_equal_first_run": bool(np.array_equal(
                det["rec_tcw"], first["rec_tcw"])),
            "parts_from_reference_at": (parts_at(det, main) if main
                                        else None)}
        lines.append(line)
        log(json.dumps(line))
    record = {"reference": None if ref is None else {
        r: {"keyframes": d["keyframes"],
            "parts_from_main_at": parts_at(d, main)}
        for r, d in ref.items() if r != "main"}}
    if ref is not None:
        record["reference"]["main"] = {"keyframes": main["keyframes"]}
    log(json.dumps(record))
    return lines, record


def main(argv=None):
    from ab_deviations_torch import build_cfg
    args = parse_args(argv)
    lines, record = run(build_cfg(args.scale), args,
                        log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": lines, **record}, f, indent=1)
    return lines, record


if __name__ == "__main__":
    main()
