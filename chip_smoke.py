"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit, torch/CUDA versions;
     build the port's CUDA kernel from csrc/ and print the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (a rendered 640x480 TUM frame, all 8
     pyramid levels at their keypoint budgets, ~10% of the corners past
     the borders): bit-exact check, CUDA-event times (median of 100 after
     warm-up), and the bound for the same work;
  3. the slice: SlamSystem.track_rgbd on 40 rendered TUM-VGA frames
     (objects off, strict readback) on the card, with every kernel's
     launch count read around that run;
  4. one JSON line of the kernels, the card line, and the last line
     {"ok": true, "device": {...}}.

Exits non-zero without a card, and when the port's package is absent.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM peak memory rate (NVIDIA data sheet), for the bound column
HBM_BYTES_PER_S = 3.35e12
N_FRAMES = 40
WARMUP = 8


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn()."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def tum_cfg():
    from object_slam_tpu_torch.config import SlamConfig, TrackingConfig
    return SlamConfig.tum_rgbd().replace(
        tracking=TrackingConfig(pipelined_readback=False))


def render(cfg, n_frames):
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(n_frames, step=0.01)
    frames = []
    for T in poses:
        gray, depth, rgb, _ = scene.render_rgbd(T)
        frames.append((gray.astype(np.float32), depth.astype(np.float32),
                       rgb.astype(np.float32)))
    return poses, frames


def phase_kernels(cfg, gray):
    """extract_patches against its plain version at the main path's
    shapes: 2 launches per pyramid level (raw and blurred level)."""
    import torch
    from object_slam_tpu_torch.features import pyramid as pyr
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    from object_slam_tpu_torch.ops import patch as patch_mod

    ex = OrbExtractor(cfg, device="cuda")
    img = torch.from_numpy(gray).cuda()
    levels = pyr.build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)
    rng = np.random.RandomState(0)
    calls = []
    for l, lvl in enumerate(levels):
        n = ex.budgets[l]
        if n <= 0:
            continue
        H, W = lvl.shape
        ys = rng.randint(0, H - 31, n)
        xs = rng.randint(0, W - 31, n)
        out = rng.rand(n) < 0.1            # ~10% past the borders
        ys[out] = np.where(rng.rand(out.sum()) < 0.5,
                           rng.randint(-40, 0, out.sum()),
                           rng.randint(H - 31, H + 40, out.sum()))
        xs[out] = np.where(rng.rand(out.sum()) < 0.5,
                           rng.randint(-40, 0, out.sum()),
                           rng.randint(W - 31, W + 40, out.sum()))
        ys_t = torch.from_numpy(ys.astype(np.int32)).cuda()
        xs_t = torch.from_numpy(xs.astype(np.int32)).cuda()
        for im in (lvl.contiguous(), pyr.gaussian_blur(lvl).contiguous()):
            calls.append((im, ys_t, xs_t))

    max_err = 0.0
    for im, ys_t, xs_t in calls:
        k = patch_mod.extract_patches_cuda(im, ys_t, xs_t)
        p = patch_mod.extract_patches_ref(im, ys_t, xs_t)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail("extract_patches kernel differs from its plain version")
        max_err = max(max_err, float((k - p).abs().max()))

    # one frame's worth of launches (all levels, raw + blurred)
    def run_kernel():
        for im, ys_t, xs_t in calls:
            patch_mod.extract_patches_cuda(im, ys_t, xs_t)

    def run_plain():
        for im, ys_t, xs_t in calls:
            patch_mod.extract_patches_ref(im, ys_t, xs_t)

    gathers = []
    for im, ys_t, xs_t in calls:
        H, W = im.shape
        d = torch.arange(32, device="cuda")
        y0 = ys_t.long().clamp(0, H - 32)
        x0 = xs_t.long().clamp(0, W - 32)
        gathers.append((im, y0[:, None, None] + d[None, :, None],
                        x0[:, None, None] + d[None, None, :]))

    def run_library():
        for im, yy, xx in gathers:
            im[yy, xx]

    ms = cuda_time_ms(run_kernel)
    plain_ms = cuda_time_ms(run_plain)
    library_ms = cuda_time_ms(run_library)
    # bound: every output byte written once, every input byte the windows
    # touch read once (the union of a level's windows; each level's corner
    # arrays once, shared by its raw and blurred call)
    n_bytes = 0
    seen = set()
    for im, yy, xx in gathers:
        touched = torch.zeros(im.shape, dtype=torch.bool, device="cuda")
        touched[yy, xx] = True
        n_bytes += yy.shape[0] * 32 * 32 * 4 + int(touched.sum()) * 4
    for _, ys_t, xs_t in calls:
        if ys_t.data_ptr() not in seen:
            seen.add(ys_t.data_ptr())
            n_bytes += 2 * ys_t.shape[0] * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    n_patches = sum(c[1].shape[0] for c in calls)
    print(f"extract_patches: {len(calls)} launches, {n_patches} patches per "
          f"frame; kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
          f"gather {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({n_bytes / 2 ** 20:.1f} MiB); bit-exact", flush=True)
    return {"name": "extract_patches", "route": "cuda",
            "source": "object_slam_tpu_torch/csrc/patch_extract.cu",
            "replaces": "object_slam_tpu/ops/patch_pallas.py:74",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def phase_slice(cfg, poses, frames, card):
    import torch
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.ops import patch as patch_mod
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, enable_objects=False, device="cuda", profile=True)
    n_lvl = sum(1 for b in sys_.builder.extractor.budgets if b > 0)
    patch_mod.extract_patches.launches = 0
    times, est, gt, oks = [], [], [], []
    for i, (T, (gray, depth, rgb)) in enumerate(zip(poses, frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        Tcw = f.Tcw.cpu().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.all(np.isfinite(Tcw)):
            fail(f"frame {i}: non-finite pose")
        est.append(np.linalg.inv(Tcw)[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
        oks.append(bool(f.pose_ok))
    launches = patch_mod.extract_patches.launches
    ate = ate_rmse(np.array(est), np.array(gt))
    steady = np.asarray(times[WARMUP:])
    n_kf, n_pts = sys_.n_keyframes, sys_.n_points
    stage = {k: float(np.mean(v[1:] if len(v) > 1 else v))
             for k, v in sys_.stage_ms.items()}
    print(f"slice [{card}]: {sum(oks)}/{len(oks)} tracked, {n_kf} KFs, "
          f"{n_pts} points, ATE {ate:.6f} m, median "
          f"{np.median(steady):.3f} ms/frame, mean {np.mean(steady):.3f} "
          f"ms/frame ({1e3 / np.median(steady):.3f} frames/s median) after "
          f"{WARMUP} warm-up frames; reloc skipped {sys_.n_reloc_skipped}",
          flush=True)
    print("slice stage mean ms [" + card + "]: " + json.dumps(
        {k: round(v, 3) for k, v in stage.items()}), flush=True)
    print("slice frame ms: " + json.dumps([round(t, 3) for t in times]),
          flush=True)
    if not all(oks):
        fail(f"untracked frames: {[i for i, o in enumerate(oks) if not o]}")
    if n_kf < 2:
        fail(f"only {n_kf} keyframes")
    if sys_.n_reloc_skipped != 0:
        fail(f"{sys_.n_reloc_skipped} frames needed relocalization")
    if not ate < 0.05:
        fail(f"ATE {ate} m >= 0.05 m")
    want = 2 * n_lvl * N_FRAMES
    if launches != want:
        fail(f"extract_patches launched {launches} times, expected {want}")
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        import object_slam_tpu_torch  # noqa: F401
        from object_slam_tpu_torch.ops import build
    except ImportError as e:
        fail(f"the port's package is missing: {e}")

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    build.load("patch_extract")
    print(f"kernel patch_extract built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = tum_cfg()
    t0 = time.perf_counter()
    poses, frames = render(cfg, N_FRAMES)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)

    row = phase_kernels(cfg, frames[0][0])
    row["launches"] = phase_slice(cfg, poses, frames, card)
    row["launches_per_frame"] = row["launches"] // N_FRAMES
    for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
        if not (isinstance(row[k], float) and math.isfinite(row[k])):
            fail(f"kernel row field {k} is not a finite number")
    print(json.dumps({"kernels": [row]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
