"""Time the port's ORB kernels against another commit's, in turns on one
CUDA card.

    git archive <commit> object_slam_tpu_torch | tar -x -C build/parent
    python scripts/ab_kernels_torch.py --parent build/parent [--out F.json]

Builds the other tree's ``csrc/orb_describe.cu`` and
``csrc/patch_extract.cu`` (nvcc, sm_90a) beside this tree's, drives each
with its own Python wrapper (``ops/describe.py``, ``ops/patch.py`` of that
tree), and times them old, new, new, old (CUDA events around the wrapper
call, median of 100; the device time from torch.profiler):

- ``orb_describe`` at chip_smoke.py's main-path inputs (``main_path_inputs``:
  the budgets' corners on a rendered frame's pyramid, ~10% past the
  borders) at TUM VGA, EuRoC (752x480) and a KITTI pair (1241x376, both
  images: the old tree's two launches against this tree's one, and this
  tree's two one-image launches); the outputs of the two kernels compared;
- the launch alone: every level slot outside the table (a NaN angle per
  keypoint and nothing staged), at TUM VGA;
- ``extract_patches`` at the first render of the BRIEF-pattern harvest:
  the old tree's launch per level against ``extract_patches_levels``' one.

Prints the card line and one JSON object (also written to --out). Needs a
card; without one it stops.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _old_module(parent, name, lib):
    """The other tree's ops/<name>.py, its kernel library swapped in."""
    path = os.path.join(parent, "object_slam_tpu_torch", "ops", name + ".py")
    spec = importlib.util.spec_from_file_location("old_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(load=lambda _name: lib)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a directory holding the other tree's "
                         "object_slam_tpu_torch/{csrc,ops}")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_kernels_torch.py needs a CUDA card")
    import chip_smoke as cs
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (bench_room,
                                                          orbit_poses,
                                                          render_street)
    from object_slam_tpu_torch.ops import build
    from object_slam_tpu_torch.ops import describe as dsc
    from object_slam_tpu_torch.ops import patch as pm

    card = cs.card_line()
    print(card, flush=True)
    out_dir = os.path.join(ROOT, "build", "ab_kernels")
    os.makedirs(out_dir, exist_ok=True)
    names = ("orb_describe", "patch_extract")
    procs = [subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"lib{k}_old.so"),
         os.path.join(args.parent, "object_slam_tpu_torch", "csrc",
                      k + ".cu")]) for k in names]
    build.load_all(cs.KERNELS)
    if any(p.wait() != 0 for p in procs):
        sys.exit("nvcc failed on the other tree's sources")
    old_dsc = _old_module(args.parent, "describe", ctypes.CDLL(
        os.path.join(out_dir, "liborb_describe_old.so")))
    old_pm = _old_module(args.parent, "patch", ctypes.CDLL(
        os.path.join(out_dir, "libpatch_extract_old.so")))
    res = {"card": card}

    def turns(name, old_fn, new_fn, kernel_old, kernel_new):
        r = {"old_ms": [], "new_ms": [], "old_device_ms": [],
             "new_device_ms": []}
        for who in ("old", "new", "new", "old"):
            fn, kn = (old_fn, kernel_old) if who == "old" else \
                (new_fn, kernel_new)
            r[f"{who}_ms"].append(cs.cuda_time_ms(fn))
            r[f"{who}_device_ms"].append(cs.device_ms(fn, kn))
        print(f"{name}: old {[round(x * 1e3, 2) for x in r['old_ms']]} us "
              f"(device {[round(x * 1e3, 2) for x in r['old_device_ms']]}), "
              f"new {[round(x * 1e3, 2) for x in r['new_ms']]} us (device "
              f"{[round(x * 1e3, 2) for x in r['new_device_ms']]})",
              flush=True)
        res[name] = r

    def describe_inputs(cfg, grays):
        parts = []
        for g in grays:
            ex, levels, corners = cs.main_path_inputs(cfg, np.asarray(
                g, np.float32))
            parts.append(([levels[l] for l, _, _ in corners],
                          torch.cat([y for _, y, _ in corners]),
                          torch.cat([x for _, _, x in corners]),
                          torch.cat([torch.full_like(y, i) for i, (_, y, _)
                                     in enumerate(corners)])))
        return ex, parts

    def describe_case(name, cfg, grays):
        ex, parts = describe_inputs(cfg, grays)
        r, i1, i2 = ex.cfg.orb.half_patch, ex.brief_idx1, ex.brief_idx2
        levels = [t for p in parts for t in p[0]]
        cy = torch.cat([p[1] for p in parts])
        cx = torch.cat([p[2] for p in parts])
        lvl = torch.cat([p[3] + len(parts[0][0]) * k
                         for k, p in enumerate(parts)])
        call = dsc.OrbDescribe([tuple(t.shape) for t in levels], "cuda", i1,
                               i2, radius=r)

        def old_fn():
            for lv, y, x, l in parts:
                old_dsc.orb_describe_cuda(lv, y, x, l, i1, i2, radius=r)

        def new_fn():
            call(levels, cy, cx, lvl)
        na, nd = call(levels, cy, cx, lvl)
        olds = [old_dsc.orb_describe_cuda(lv, y, x, l, i1, i2, radius=r)
                for lv, y, x, l in parts]
        oa = torch.cat([o[0] for o in olds])
        od = torch.cat([o[1] for o in olds])
        torch.cuda.synchronize()
        agree = {"keypoints": int(cy.shape[0]),
                 "angles_equal": int((na == oa).sum()),
                 "max_angle_diff": float((na - oa).abs().max()),
                 "descriptor_rows_equal": int((nd == od).all(1).sum())}
        print(f"{name}: {json.dumps(agree)}", flush=True)
        turns(name, old_fn, new_fn, "orb_describe_kernel",
              "orb_describe_kernel")
        res[name]["agree"] = agree
        if len(parts) == 2:
            singles = [dsc.OrbDescribe([tuple(t.shape) for t in p[0]],
                                       "cuda", i1, i2, radius=r)
                       for p in parts]

            def two_new():
                for c, p in zip(singles, parts):
                    c(*p)
            turns(name + ", this tree's two one-image launches", old_fn,
                  two_new, "orb_describe_kernel", "orb_describe_kernel")
        return ex, parts

    tum = cs.tum_cfg()
    tum_gray = bench_room(tum).render_rgbd(orbit_poses(1)[0])[0]
    ex, parts = describe_case("orb_describe TUM VGA", tum, [tum_gray])
    eu = cs.euroc_cfg("mono")
    describe_case("orb_describe EuRoC", eu,
                  [bench_room(eu).render_rgbd(orbit_poses(1)[0])[0]])
    kcfg = SlamConfig.kitti_stereo()
    _, kf, _ = render_street(kcfg, 24, last=1)
    describe_case("orb_describe KITTI pair", kcfg, [kf[0][0], kf[0][1]])

    # the launch alone: no slot in the table, nothing staged
    lv, y, x, l = parts[0]
    none = torch.full_like(l, -1)
    call = dsc.OrbDescribe([tuple(t.shape) for t in lv], "cuda",
                           ex.brief_idx1, ex.brief_idx2,
                           radius=ex.cfg.orb.half_patch)
    turns("orb_describe TUM VGA, every slot outside the table",
          lambda: old_dsc.orb_describe_cuda(lv, y, x, none, ex.brief_idx1,
                                            ex.brief_idx2),
          lambda: call(lv, y, x, none), "orb_describe_kernel",
          "orb_describe_kernel")

    # extract_patches at the first render of the BRIEF-pattern harvest
    tb = cs.script_module("train_brief_pattern_torch")
    calls = []
    tb.harvest_patches(n_target=1, device="cuda", levels_out=calls)
    blurred, ys, xs, lv, p = calls[0]
    per = []
    for lvl_i, im in enumerate(blurred):
        sel = torch.nonzero(lv == lvl_i)[:, 0]
        if sel.numel():
            per.append((im, ys[sel].contiguous(), xs[sel].contiguous()))
    same = torch.equal(torch.cat([old_pm.extract_patches_cuda(*c)
                                  for c in per]), p)
    print(f"extract_patches: {int(ys.shape[0])} windows over {len(per)} "
          f"levels; the old per-level launches' windows equal the new "
          f"launch's: {same}", flush=True)
    if not same:
        sys.exit("the two trees' patches differ")

    def old_p():
        for c in per:
            old_pm.extract_patches_cuda(*c)
    turns("extract_patches, one BRIEF-harvest render", old_p,
          lambda: pm.extract_patches_levels_cuda(blurred, ys, xs, lv),
          "patch_extract_kernel", "patch_extract_levels_kernel")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
