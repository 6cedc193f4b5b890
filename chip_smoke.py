"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit, torch/CUDA versions;
     build the port's CUDA kernels from csrc/ (one nvcc each, all started
     together) and print the build time;
  2. every kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (a rendered 640x480 TUM frame, all 8
     pyramid levels at their keypoint budgets, 1024 keypoints, ~10% of the
     corners past the borders), with the tolerance stated at each check,
     CUDA-event times of the wrapper call (median of 100 after warm-up),
     the kernel's device time (torch.profiler), and the bound for the
     same work: extract_patches (one frame's 16 per-level launches, off the
     main path since orb_describe took its place) and orb_describe (one
     launch for the frame);
  3. strict readback, objects off: SlamSystem.track_rgbd on 40 rendered
     TUM-VGA frames (pipelined_readback=False) on the card, with every
     kernel's launch count set to 0 before that run and read after it:
     orb_describe once per frame, extract_patches never (the same holds,
     counted the same way, for every run below);
  4. strict readback, objects on: the same 40 frames with their
     detections, held to the JAX package's CPU run of the same frames
     (tests/torch_fixtures/objects_tum_vga.npz, make_reference.py): all
     frames tracked as the reference tracked them, the same keyframe
     frames, every frame's pose within 2 mm / 0.1 deg of the reference's,
     ATE < 0.05 m and within 0.02 mm of the reference's (below the
     0.05 mm that objects on moves it from objects off), the same object
     census, semantic constraints > 0 and within 10%;
  5. the main path as bench.py runs it: the default configuration
     (pipelined readback), the 40 frames packed by pack_frame_blob into
     track_rgbd_blob, objects on, no per-frame sync, then flush_mapping;
     host-in-the-loop, then device-resident (blobs staged first). Each
     run is held to the JAX CPU run of the same blobs
     (pipelined_tum_vga.npz) as in 4, on its trajectory records; prints
     ms/frame next to the strict run, the blob's bytes and its transfer
     time;
  6. kidnap: 49 frames (a 36-frame pan, 3 dark frames, a jump back to the
     start whose reference keyframe shares too little) as blobs, objects
     on, pipelined; replaying the JAX run's RANSAC index sets
     (kidnap_tum_vga.npz) it gives the same LOST, staged and relocalized
     frames and records within 2 mm / 0.1 deg; with its own sampler it
     recovers on the same frame within 5 cm of the ground truth; then the
     cost of one relocalization call and the syncs inside eigh / svd;
  7. scripts/run_tum_torch.py on a 12-frame TUM-format directory with
     masks that this script writes under build/ (the port's zlib PNG
     writer): the three output files and the JSON summary;
  8. one JSON line of the kernels (launches from the main path of 5,
     host-in-the-loop, and per phase), the card line, and the last line
     {"ok": true, "device": {...}}.

Exits non-zero without a card, and when the port's package is absent.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peak rates (NVIDIA data sheet), for the bound column
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
KERNELS = ("patch_extract", "orb_describe")
N_FRAMES = 40
WARMUP = 8
# the objects-on ATE band around the reference's: on this scene the object
# layer moves the ATE by about 0.05 mm, so a wider band could not tell an
# optimizer that never moves the pose from one that does
ATE_BAND_M = 2e-5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_fixtures")
# the JAX package's CPU runs (tests/torch_fixtures/make_reference.py):
# strict objects on, bench.py's pipelined blob protocol, the kidnap
REFERENCE = os.path.join(FIXTURES, "objects_tum_vga.npz")
BENCH_REF = os.path.join(FIXTURES, "pipelined_tum_vga.npz")
KIDNAP_REF = os.path.join(FIXTURES, "kidnap_tum_vga.npz")
TUM_FRAMES = 12
# a relocalized record that holds a PnP pose alone, against the reference's
# (see hold_to_reference)
PNP_BAND_M = 5e-3


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


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of the CUDA kernels whose name holds `kernel`, per call
    of fn(), summed over their launches, from torch.profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if not spans:
        fail(f"the profiler traced no {kernel} on the card")
    return sum(spans) / reps / 1e3


def tum_cfg():
    from object_slam_tpu_torch.config import SlamConfig, TrackingConfig
    return SlamConfig.tum_rgbd().replace(
        tracking=TrackingConfig(pipelined_readback=False))


def make_scene(cfg):
    """bench.py's room: seed 3, three object boxes of size 0.9."""
    from object_slam_tpu_torch.datasets.synthetic import SyntheticScene
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene


def render(cfg, n_frames):
    from object_slam_tpu_torch.datasets.synthetic import orbit_poses
    scene = make_scene(cfg)
    poses = orbit_poses(n_frames, step=0.01)
    frames, sems = [], []
    for T in poses:
        gray, depth, rgb, sem = scene.render_rgbd(T)
        frames.append((gray.astype(np.float32), depth.astype(np.float32),
                       rgb.astype(np.float32)))
        sems.append(scene.sem_arrays(sem, cfg.semantic.max_instances))
    return poses, frames, sems


def write_tum_dir(out: str, cfg, poses, renders, t0: float = 1000.0):
    """A TUM-format sequence, as scripts/make_synth_tum.py writes it:
    rgb/ and depth/ PNGs (u8 rgb, raw u16 depth), rgb.txt, depth.txt,
    groundtruth.txt and a YOLACT-format semantic/ folder (each valid
    detection's line and 0/255 mask), every PNG from the port's zlib
    writer. renders: per pose (depth [H, W] metric, rgb [H, W, 3], the
    frame's sem_arrays slab)."""
    from object_slam_tpu_torch.datasets.png import write_png
    from object_slam_tpu_torch.eval.trajectory_io import _rot_to_quat
    for sub in ("rgb", "depth", "semantic"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, (T, (depth, rgb, sem)) in enumerate(zip(poses, renders)):
        key = f"{t0 + i / 30.0:.6f}"
        write_png(os.path.join(out, "rgb", key + ".png"),
                  np.clip(rgb, 0, 255).astype(np.uint8))
        write_png(os.path.join(out, "depth", key + ".png"),
                  np.clip(depth * cfg.camera.depth_map_factor, 0,
                          65535).astype(np.uint16))
        rgb_lines.append(f"{key} rgb/{key}.png")
        depth_lines.append(f"{key} depth/{key}.png")
        Twc = np.linalg.inv(T)
        t, q = Twc[:3, 3], _rot_to_quat(Twc[:3, :3])
        gt_lines.append(f"{key} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
        masks, labels, probs, bboxes, valid = sem
        fdir = os.path.join(out, "semantic", key)
        os.makedirs(fdir, exist_ok=True)
        with open(os.path.join(fdir, key + ".txt"), "w") as f:
            for j in np.flatnonzero(valid):
                x, y, w, h = bboxes[j]
                f.write(f"{labels[j]} {probs[j]:.3f} {int(x)} {int(y)} "
                        f"{int(w)} {int(h)} {j}\n")
                write_png(os.path.join(fdir, f"{j}.png"),
                          (np.asarray(masks[j]) * 255).astype(np.uint8))
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(out, name), "w") as f:
            f.write("# synthetic\n" + "\n".join(lines) + "\n")


def main_path_inputs(cfg, gray):
    """The pyramid of a rendered frame and, per level, as many window
    corners as its keypoint budget, ~10% of them past the borders."""
    import torch
    from object_slam_tpu_torch.features import pyramid as pyr
    from object_slam_tpu_torch.features.extractor import OrbExtractor

    ex = OrbExtractor(cfg, device="cuda")
    img = torch.from_numpy(gray).cuda()
    levels = [x.contiguous() for x in
              pyr.build_pyramid(img, cfg.orb.n_levels, cfg.orb.scale_factor)]
    rng = np.random.RandomState(0)
    corners = []
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
        corners.append((l, torch.from_numpy(ys.astype(np.int32)).cuda(),
                        torch.from_numpy(xs.astype(np.int32)).cuda()))
    return ex, levels, corners


def phase_patches(levels, corners):
    """extract_patches against its plain version at the main path's
    shapes: one frame's 2 launches per pyramid level (raw and blurred)."""
    import torch
    from object_slam_tpu_torch.features import pyramid as pyr
    from object_slam_tpu_torch.ops import patch as patch_mod

    calls = []
    for l, ys_t, xs_t in corners:
        for im in (levels[l], pyr.gaussian_blur(levels[l]).contiguous()):
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
    dev_ms = device_ms(run_kernel, "patch_extract_kernel")
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
          f"frame; kernel {ms * 1e3:.1f} us ({dev_ms * 1e3:.2f} us on the "
          f"device), plain {plain_ms * 1e3:.1f} us, "
          f"gather {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({n_bytes / 2 ** 20:.1f} MiB); bit-exact", flush=True)
    return {"name": "extract_patches", "route": "cuda",
            "source": "object_slam_tpu_torch/csrc/patch_extract.cu",
            "replaces": "object_slam_tpu/ops/patch_pallas.py:74",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def phase_describe(ex, levels, corners):
    """orb_describe against its plain version at the main path's shapes:
    one launch for the frame's keypoints over all levels.

    Tolerance: angles within 1e-5 rad (mod 2 pi) except where the plain
    version's stability margin |mag - tau * mass| is below 1e-4 tau mass
    (counted and printed); descriptors bit-exact wherever the two angles
    fall in the same bin; bins equal for >= 99.9% of keypoints. The kernel
    sums the moments in another order than torch, and the bin rounding
    and the gate see that; the blur and bf16 rounding are bit-exact."""
    import torch
    from object_slam_tpu_torch.ops import describe as dsc

    lv = [levels[l] for l, _, _ in corners]
    cy = torch.cat([ys for _, ys, _ in corners])
    cx = torch.cat([xs for _, _, xs in corners])
    lvl = torch.cat([torch.full_like(ys, i)
                     for i, (_, ys, _) in enumerate(corners)])
    args = (lv, cy, cx, lvl, ex.brief_idx1, ex.brief_idx2)
    radius = ex.cfg.orb.half_patch
    k_ang, k_desc = dsc.orb_describe_cuda(*args, radius=radius)
    p_ang, p_desc = dsc.orb_describe_ref(*args, radius=radius)
    near = dsc.near_gate(lv, cy, cx, lvl, radius=radius)
    torch.cuda.synchronize()

    def bins(a):
        return torch.remainder(torch.round(
            a / (2.0 * math.pi) * dsc.N_ANGLE_BINS).to(torch.int64),
            dsc.N_ANGLE_BINS)

    err = (torch.remainder(k_ang.double() - p_ang.double() + math.pi,
                           2 * math.pi) - math.pi).abs()
    max_err = float(err[~near].max()) if bool((~near).any()) else 0.0
    n_near = int(near.sum())
    n_near_diff = int((near & (err > 1e-5)).sum())
    same = bins(k_ang) == bins(p_ang)
    same_frac = float(same.double().mean())
    bad_bits = int(torch.sum(k_desc[same] != p_desc[same]))
    n = cy.shape[0]

    ms = cuda_time_ms(lambda: dsc.orb_describe_cuda(*args, radius=radius))
    dev_ms = device_ms(lambda: dsc.orb_describe_cuda(*args, radius=radius),
                       "orb_describe_kernel")
    plain_ms = cuda_time_ms(lambda: dsc.orb_describe_ref(*args,
                                                         radius=radius))
    # bound: the raw pixels the 38x38 wrapped windows touch (the union per
    # level), the BRIEF table rows of the bins in use (two int16 tables),
    # the corner and level arrays read once, angle and descriptor written
    # once; operations: the blur's multiply and add per tap (38x32 and
    # 32x32 outputs), the BRIEF compares (f32), the masked moments (f64)
    n_bytes = 0
    r = torch.arange(32 + 6, device="cuda")
    for l, ys, xs in corners:
        H, W = levels[l].shape
        y0 = ys.long().clamp(0, H - 32)
        x0 = xs.long().clamp(0, W - 32)
        rows = torch.remainder(y0[:, None] - 3 + r, H)
        cols = torch.remainder(x0[:, None] - 3 + r, W)
        touched = torch.zeros((H, W), dtype=torch.bool, device="cuda")
        touched[rows[:, :, None], cols[:, None, :]] = True
        n_bytes += int(touched.sum()) * 4
    n_bytes += int(torch.unique(bins(k_ang)).numel()) * 2 * 256 * 2
    n_bytes += n * 3 * 4 + n * (4 + 8 * 4)
    d = np.arange(32) - 15
    n_circ = int(np.sum(d[:, None] ** 2 + d[None, :] ** 2 <= radius ** 2))
    f32_ops = n * ((38 * 32 + 32 * 32) * 7 * 2 + 256)
    f64_ops = n * n_circ * 5
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = (f32_ops / F32_FLOP_PER_S + f64_ops / F64_FLOP_PER_S) * 1e3
    bound_ms = max(byte_ms, op_ms)
    print(f"orb_describe: 1 launch, {n} keypoints over {len(lv)} levels; "
          f"kernel {ms * 1e3:.1f} us ({dev_ms * 1e3:.2f} us on the device), "
          f"plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.3f} us ({n_bytes / 2 ** 20:.2f} MiB, "
          f"{byte_ms * 1e3:.3f} us; {(f32_ops + f64_ops) / 1e6:.1f} MFLOP, "
          f"{op_ms * 1e3:.3f} us); max angle error {max_err:.3e} rad outside "
          f"{n_near} near-gate keypoints ({n_near_diff} of them differ); "
          f"bins agree {same_frac:.6f}; {bad_bits} descriptor words differ "
          f"where bins agree", flush=True)
    if not max_err <= 1e-5:
        fail(f"orb_describe angle error {max_err} rad > 1e-5")
    if same_frac < 0.999:
        fail(f"orb_describe bins agree for only {same_frac:.6f}")
    if bad_bits:
        fail(f"orb_describe: {bad_bits} descriptor words differ from the "
             f"plain version where the bins agree")
    if not (torch.isfinite(k_ang).all() and k_desc.shape == (n, 8)):
        fail("orb_describe output is not finite or has the wrong shape")
    return {"name": "orb_describe", "route": "cuda",
            "source": "object_slam_tpu_torch/csrc/orb_describe.cu",
            "replaces": "object_slam_tpu/ops/patch_pallas.py:74",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
            "library": "none: no single PyTorch call computes the blur, the "
                       "IC angle and steered BRIEF of a window"}


def counters():
    from object_slam_tpu_torch.ops import describe as dsc
    from object_slam_tpu_torch.ops import patch as patch_mod
    return {"extract_patches": patch_mod.extract_patches,
            "orb_describe": dsc.orb_describe}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts(name: str, n_frames: int):
    """The launches since zero_counts(); fails unless they are one
    orb_describe per frame (dark frames too: the extractor describes its
    whole fixed-size keypoint slab, so the grid is never empty) and no
    extract_patches."""
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"extract_patches": 0, "orb_describe": n_frames}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    return launches


def run_path(cfg, poses, frames, sems, card, objects: bool):
    """SlamSystem.track_rgbd over the frames on the card (strict readback),
    the kernels' launch counts set to 0 just before and read just after.
    Fails unless every frame tracks with no relocalization, ATE < 0.05 m
    and the launches are one orb_describe per frame and no
    extract_patches. Returns the system, the ATE, the launches, the
    per-frame Tcw [F, 4, 4], the per-frame pose_ok flags and the median
    and mean ms per frame."""
    import torch
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.slam.system import SlamSystem

    name = "objects on" if objects else "objects off"
    sys_ = SlamSystem(cfg, enable_objects=objects, device="cuda",
                      profile=True)
    zero_counts()
    times, est, gt, oks, tcws = [], [], [], [], []
    for i, (T, (gray, depth, rgb)) in enumerate(zip(poses, frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = sys_.track_rgbd(gray, depth, rgb, sems[i] if objects else None,
                            timestamp=i / 30.0)
        Tcw = f.Tcw.cpu().numpy()
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.all(np.isfinite(Tcw)):
            fail(f"{name}, frame {i}: non-finite pose")
        tcws.append(Tcw)
        est.append(np.linalg.inv(Tcw)[:3, 3])
        gt.append(np.linalg.inv(T)[:3, 3])
        oks.append(bool(f.pose_ok))
    launches = read_counts(name, len(frames))
    ate = ate_rmse(np.array(est), np.array(gt))
    steady = np.asarray(times[WARMUP:])
    n_kf, n_pts = sys_.n_keyframes, sys_.n_points
    stage = {k: float(np.mean(v[1:] if len(v) > 1 else v))
             for k, v in sys_.stage_ms.items()}
    print(f"{name} [{card}]: {sum(oks)}/{len(oks)} tracked, {n_kf} KFs, "
          f"{n_pts} points, ATE {ate:.6f} m, median "
          f"{np.median(steady):.3f} ms/frame, mean {np.mean(steady):.3f} "
          f"ms/frame ({1e3 / np.median(steady):.3f} frames/s median) after "
          f"{WARMUP} warm-up frames; relocalized {sys_.n_relocalized}; "
          f"launches {launches}", flush=True)
    print(f"{name} stage mean ms [{card}]: " + json.dumps(
        {k: round(v, 3) for k, v in stage.items()}), flush=True)
    print(f"{name} frame ms: " + json.dumps([round(t, 3) for t in times]),
          flush=True)
    if not all(oks):
        fail(f"{name}: untracked frames "
             f"{[i for i, o in enumerate(oks) if not o]}")
    if n_kf < 2:
        fail(f"{name}: only {n_kf} keyframes")
    if sys_.n_relocalized != 0:
        fail(f"{name}: {sys_.n_relocalized} frames needed relocalization")
    if not ate < 0.05:
        fail(f"{name}: ATE {ate} m >= 0.05 m")
    return (sys_, ate, launches, np.stack(tcws), oks,
            (float(np.median(steady)), float(np.mean(steady))))


def rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def phase_objects(cfg, poses, frames, sems, card):
    """The main path, objects on, held to the JAX CPU run of the same
    frames."""
    ref = np.load(REFERENCE)
    gray_sum = [float(np.sum(g, dtype=np.float64)) for g, _, _ in frames]
    if not np.allclose(gray_sum, ref["gray_sum"], rtol=1e-9, atol=0):
        fail("the rendered frames differ from the reference run's")
    sys_, ate, launches, tcws, tracked, ms = run_path(cfg, poses, frames,
                                                      sems, card, True)
    m = sys_.map
    labels = m.obj_label[m.obj_valid].cpu().numpy()
    lab, cnt = np.unique(labels, return_counts=True)
    census = dict(zip(lab.tolist(), cnt.tolist()))
    ref_census = dict(zip(ref["census_labels"].tolist(),
                          ref["census_counts"].tolist()))
    n_sem = sys_.objects.semantic_constraints
    ref_sem = int(ref["semantic_constraints"])
    kf_frames = m.kf_frame_id[m.kf_valid].cpu().numpy().tolist()
    print(f"objects on: census {census} (reference {ref_census}), semantic "
          f"constraints {n_sem} (reference {ref_sem}), KFs at frames "
          f"{kf_frames} (reference {ref['kf_frames'].tolist()}), ATE "
          f"{ate:.6f} m (reference {float(ref['ate']):.6f} m)", flush=True)
    ref_tcw = ref["tcw"]
    d_t = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
           for a, b in zip(tcws, ref_tcw)]
    d_r = [rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(tcws, ref_tcw)]
    print(f"objects on: per-frame pose against the reference: max "
          f"{max(d_t) * 1e3:.4f} mm, {max(d_r):.5f} deg", flush=True)
    if tracked != ref["tracked"].tolist():
        fail(f"objects on: tracked flags {tracked} differ from the "
             f"reference's")
    if kf_frames != ref["kf_frames"].tolist():
        fail(f"objects on: KFs at frames {kf_frames}, reference "
             f"{ref['kf_frames'].tolist()}")
    if not (max(d_t) < 2e-3 and max(d_r) < 0.1):
        fail(f"objects on: a frame's pose is {max(d_t)} m / {max(d_r)} deg "
             f"from the reference's (limits 2 mm / 0.1 deg)")
    if not abs(ate - float(ref["ate"])) <= ATE_BAND_M:
        fail(f"objects on: ATE {ate} m is not within {ATE_BAND_M} m of the "
             f"reference's {float(ref['ate'])} m")
    if census != ref_census:
        fail(f"objects on: census {census} != the reference's {ref_census}")
    if not (n_sem > 0 and abs(n_sem - ref_sem) <= 0.1 * ref_sem):
        fail(f"objects on: {n_sem} semantic constraints, reference "
             f"{ref_sem}")
    return launches, ms


def hold_to_reference(name, sys_, ref, gt_poses, objects=True, pnp=()):
    """The run's trajectory records against a JAX CPU run of the same
    frames: tracked flags and keyframe frames equal, every record's pose
    within 2 mm / 0.1 deg, the ATE over tracked frames within ATE_BAND_M,
    and (objects on) the census equal and the semantic constraints within
    10%. The records of frames in ``pnp`` hold a PnP pose alone (a
    relocalization resolved behind a newer frame, with no local-map
    refinement): the f32 DLT hypotheses of the two packages differ by
    millimetres, so the best one and its polished inlier set can differ,
    and these records are held to PNP_BAND_M / 0.1 deg, the reference's
    own scatter of such poses around the ground truth (up to 4.4 mm in
    kidnap_tum_vga.npz); the ATE band then holds over the other tracked
    records. Returns the ATE."""
    from object_slam_tpu_torch.eval.ate import ate_rmse
    recs = sys_.trajectory
    tracked = [r.tracked for r in recs]
    if tracked != ref["tracked"].tolist():
        fail(f"{name}: tracked flags {tracked} differ from the reference's "
             f"{ref['tracked'].tolist()}")
    m = sys_.map
    kf_frames = m.kf_frame_id[m.kf_valid].cpu().numpy().tolist()
    if kf_frames != ref["kf_frames"].tolist():
        fail(f"{name}: KFs at frames {kf_frames}, reference "
             f"{ref['kf_frames'].tolist()}")
    d_all = [float(np.linalg.norm(r.Tcw[:3, 3] - b[:3, 3]))
             for r, b in zip(recs, ref["rec_tcw"])]
    d_t = [d for i, d in enumerate(d_all) if i not in pnp]
    d_p = [d for i, d in enumerate(d_all) if i in pnp] or [0.0]
    d_r = [rot_deg(r.Tcw[:3, :3], b[:3, :3])
           for r, b in zip(recs, ref["rec_tcw"])]
    fin = np.stack([t[1] for t in sys_.final_trajectory()])
    ok = np.asarray(tracked)

    def ate_of(final, sel):
        est = np.stack([np.linalg.inv(T)[:3, 3] for T in final])[sel]
        gt = np.stack([np.linalg.inv(T)[:3, 3] for T in gt_poses])[sel]
        return ate_rmse(est, gt)
    ate = ate_of(fin, ok)
    # the ATE band holds over the records held to 2 mm (all but pnp)
    held = ok & ~np.isin(np.arange(len(ok)), list(pnp))
    ate_held, ate_held_ref = ate_of(fin, held), ate_of(ref["final_tcw"], held)
    msg = (f"{name}: {int(ok.sum())}/{len(ok)} tracked, KFs at {kf_frames}, "
           f"per-record pose against the reference: max "
           f"{max(d_t) * 1e3:.4f} mm, {max(d_r):.5f} deg; ATE {ate:.6f} m "
           f"(reference {float(ref['ate']):.6f} m)")
    if pnp:
        msg += (f"; without the PnP-only records ATE {ate_held:.6f} m "
                f"(reference {ate_held_ref:.6f} m); PnP-only records "
                f"{sorted(pnp)}: max "
                f"{max(d_p) * 1e3:.4f} mm; per record mm "
                f"{json.dumps([round(d * 1e3, 4) for d in d_all])}")
    if objects:
        labels = m.obj_label[m.obj_valid].cpu().numpy()
        lab, cnt = np.unique(labels, return_counts=True)
        census = dict(zip(lab.tolist(), cnt.tolist()))
        ref_census = dict(zip(ref["census_labels"].tolist(),
                              ref["census_counts"].tolist()))
        n_sem = sys_.objects.semantic_constraints
        ref_sem = int(ref["semantic_constraints"])
        msg += (f"; census {census} (reference {ref_census}), semantic "
                f"constraints {n_sem} (reference {ref_sem})")
    print(msg, flush=True)
    if not (max(d_t) < 2e-3 and max(d_r) < 0.1):
        fail(f"{name}: a record's pose is {max(d_t)} m / {max(d_r)} deg from "
             f"the reference's (limits 2 mm / 0.1 deg)")
    if not max(d_p) < PNP_BAND_M:
        fail(f"{name}: a PnP-only record is {max(d_p)} m from the "
             f"reference's (limit {PNP_BAND_M} m)")
    if not abs(ate_held - ate_held_ref) <= ATE_BAND_M:
        fail(f"{name}: ATE {ate_held} m over the records held to 2 mm is not "
             f"within {ATE_BAND_M} m of the reference's {ate_held_ref} m")
    if objects:
        if census != ref_census:
            fail(f"{name}: census {census} != the reference's {ref_census}")
        if not (n_sem > 0 and abs(n_sem - ref_sem) <= 0.1 * ref_sem):
            fail(f"{name}: {n_sem} semantic constraints, reference "
                 f"{ref_sem}")
    return ate


def to_blob(builder, cfg, depth, rgb, sem_arrays):
    """bench.py's frame encoding: u16 depth, u8 rgb, one blob."""
    d16 = np.clip(depth * cfg.camera.depth_map_factor, 0,
                  65535).astype(np.uint16)
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    return builder.pack_frame_blob(d16, rgb8, sem_arrays)


def phase_bench(cfg, poses, frames, sems, card, strict_ms):
    """bench.py's protocol on the port: the 40 frames as pack_frame_blob
    blobs through track_rgbd_blob, objects on, the default pipelined
    readback, no per-frame sync, then flush_mapping; host-in-the-loop (the
    numpy blob goes in, one pinned non-blocking copy each), then
    device-resident (every blob staged on the card first). Each run is
    held to the JAX CPU run of the same blobs (BENCH_REF). Returns the
    launches of each run."""
    import torch
    from object_slam_tpu_torch.slam.system import SlamSystem

    ref = np.load(BENCH_REF)
    gray_sum = [float(np.sum(g, dtype=np.float64)) for g, _, _ in frames]
    if not np.allclose(gray_sum, ref["gray_sum"], rtol=1e-9, atol=0):
        fail("bench: the rendered frames differ from the reference run's")
    sys0 = SlamSystem(cfg, enable_objects=True, device="cuda")
    blobs = [to_blob(sys0.builder, cfg, d, rgb, sems[i])
             for i, (_, d, rgb) in enumerate(frames)]
    # the blocking transfer of one frame's blob (pinned copy included)
    up = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys0.builder.upload_blob(blobs[0][0])
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
    nbytes = int(blobs[0][0].nbytes)
    up_ms = float(np.median(up[5:]))
    print(f"bench blob [{card}]: {nbytes} bytes per frame, blocking "
          f"transfer {up_ms:.4f} ms median ({nbytes / up_ms / 1e6:.1f} "
          f"GB/s)", flush=True)
    del sys0
    out = {}
    for mode in ("host", "device"):
        name = f"bench {mode}-in-the-loop" if mode == "host" else \
            "bench device-resident"
        sys_ = SlamSystem(cfg, enable_objects=True, device="cuda")
        staged = None
        if mode == "device":
            staged = [torch.tensor(b, device="cuda") for b, _ in blobs]
        torch.cuda.synchronize()
        zero_counts()
        times = []
        for i, (blob, iv) in enumerate(blobs):
            t0 = time.perf_counter()
            sys_.track_rgbd_blob(blob if staged is None else staged[i], iv,
                                 timestamp=i / 30.0)
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sys_.flush_mapping()
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(name, len(blobs))
        steady = np.asarray(times[WARMUP:])
        print(f"{name} [{card}]: median {np.median(steady):.3f} ms/frame, "
              f"mean {np.mean(steady):.3f} ms/frame after {WARMUP} warm-up "
              f"frames (strict objects on: median {strict_ms[0]:.3f}, mean "
              f"{strict_ms[1]:.3f}); flush {flush_ms:.3f} ms; launches "
              f"{launches}", flush=True)
        print(f"{name} frame ms: " + json.dumps([round(t, 3)
                                                 for t in times]),
              flush=True)
        hold_to_reference(name, sys_, ref, poses)
        out[mode] = (launches, float(np.median(steady)),
                     float(np.mean(steady)))
    return out


def phase_kidnap(cfg, scene, card):
    """The kidnap sequence of KIDNAP_REF (a pan, dark frames, a jump back
    to the start) as blobs, objects on, pipelined readback. Run 1 replays
    the JAX run's RANSAC index sets and must give the same LOST, staged and
    relocalized frames and the same records; run 2 draws its own sets and
    must recover on the same frame within 5 cm of the ground truth. Then
    one relocalization call is timed and profiled. Returns the launches of
    each run."""
    import torch
    from object_slam_tpu_torch.slam.system import SlamSystem

    ref = np.load(KIDNAP_REF)
    poses, blank = ref["poses"], ref["blank"]
    H, W = cfg.camera.height, cfg.camera.width
    t0 = time.perf_counter()
    cache, frames = {}, []
    for T, dark in zip(poses, blank):
        if dark:
            frames.append((np.zeros((H, W), np.float32),
                           np.zeros((H, W), np.float32),
                           np.zeros((H, W, 3), np.float32), None))
            continue
        key = T.tobytes()
        if key not in cache:
            g, d, rgb, sem = scene.render_rgbd(T)
            cache[key] = (g.astype(np.float32), d.astype(np.float32),
                          rgb.astype(np.float32),
                          scene.sem_arrays(sem, cfg.semantic.max_instances))
        frames.append(cache[key])
    print(f"kidnap: rendered {len(cache)} views for {len(frames)} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gray_sum = [float(np.sum(f[0], dtype=np.float64)) for f in frames]
    if not np.allclose(gray_sum, ref["gray_sum"], rtol=1e-9, atol=0):
        fail("kidnap: the rendered frames differ from the reference run's")
    first_ok = int(ref["reloc_frames"][ref["reloc_ok"]][0])
    out = {}
    for replay in (True, False):
        name = "kidnap replay" if replay else "kidnap own sampler"
        sys_ = SlamSystem(cfg, enable_objects=True, device="cuda")
        blobs = [to_blob(sys_.builder, cfg, d, rgb, sa)
                 for _, d, rgb, sa in frames]
        seen = {"staged": [], "reloc": [], "sets": 0}
        sets = [torch.from_numpy(x).cuda() for x in ref["sets"]]
        draw, staged_fn, reloc_fn = (sys_._minimal_sets, sys_._track_staged,
                                     sys_._relocalize)

        def minimal_sets(valid, n_trials=256, k=6, sys_=sys_, draw=draw,
                         sets=sets, seen=seen, replay=replay):
            seen["sets"] += 1
            if not replay:
                return draw(valid, n_trials, k)
            if not sets:
                fail(f"{name}: more RANSAC draws than the reference's "
                     f"{len(ref['sets'])}")
            return sets.pop(0)

        def track_staged(frame, sys_=sys_, fn=staged_fn, seen=seen):
            seen["staged"].append(sys_.frame_id)
            return fn(frame)

        def relocalize(frame, fn=reloc_fn, seen=seen):
            tr = fn(frame)
            seen["reloc"].append((round(float(frame.timestamp) * 30),
                                  tr is not None))
            return tr
        sys_._minimal_sets = minimal_sets
        sys_._track_staged = track_staged
        sys_._relocalize = relocalize
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for i, (blob, iv) in enumerate(blobs):
            sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
        sys_.flush_mapping()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts(name, len(blobs))
        recs = sys_.trajectory
        lost = [i for i, r in enumerate(recs) if not r.tracked]
        ok_frames = [f for f, ok in seen["reloc"] if ok]
        err = float(np.linalg.norm(recs[first_ok].Tcw[:3, 3]
                                   - poses[first_ok][:3, 3]))
        print(f"{name} [{card}]: {len(blobs)} frames in {secs:.1f} s; LOST "
              f"{lost} (reference {np.where(~ref['tracked'])[0].tolist()}); "
              f"staged path at {seen['staged']} (reference "
              f"{ref['staged_frames'].tolist()}); relocalizations "
              f"{seen['reloc']}; {seen['sets']} RANSAC draws; recovered at "
              f"frame {first_ok} {err * 1e3:.3f} mm from the ground truth; "
              f"launches {launches}", flush=True)
        for attr in ("_minimal_sets", "_track_staged", "_relocalize"):
            delattr(sys_, attr)          # the system's own methods again
        if replay:
            if seen["staged"] != ref["staged_frames"].tolist():
                fail(f"{name}: staged frames {seen['staged']}")
            if [f for f, _ in seen["reloc"]] != ref["reloc_frames"].tolist() \
                    or [ok for _, ok in seen["reloc"]] != \
                    ref["reloc_ok"].tolist():
                fail(f"{name}: relocalizations {seen['reloc']}")
            if seen["sets"] != len(ref["sets"]):
                fail(f"{name}: {seen['sets']} RANSAC draws, reference "
                     f"{len(ref['sets'])}")
            hold_to_reference(name, sys_, ref, poses, pnp={
                f for f, ok in seen["reloc"]
                if ok and f not in seen["staged"]})
            reloc_cost(sys_, blobs[first_ok], card)
        else:
            if not ok_frames or ok_frames[0] != first_ok:
                fail(f"{name}: first recovery at {ok_frames[:1]}, reference "
                     f"frame {first_ok}")
        if not err < 0.05:
            fail(f"{name}: recovered {err} m from the ground truth")
        out["replay" if replay else "own"] = launches
    return out


def reloc_cost(sys_, blob_iv, card, reps: int = 10):
    """One relocalization call against the run's final map: the [N, P]
    brute match, then PnP RANSAC with its batched 12x12 eigh and 3x3 SVD;
    host-clock ms of each (they end in a device read), and the sync-like
    calls inside the eigh / SVD ops from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from object_slam_tpu_torch.features import matching
    from object_slam_tpu_torch.solvers.epnp import pnp_ransac_sets

    frame = sys_.builder.build_rgbd_blob(*blob_iv, 0.0)
    m = sys_.map
    P = m.pt_xyz.shape[0]

    def match():
        return matching.brute_match(frame.desc, frame.valid, m.pt_desc,
                                    m.pt_valid, th_dist=50, nn_ratio=0.75,
                                    check_rotation=False)
    midx, mok = match()
    pw = m.pt_xyz[torch.clamp(midx, 0, P - 1).long()]
    idx = sys_._minimal_sets(mok)

    def pnp():
        res = pnp_ransac_sets(idx, sys_.K, pw, frame.uv, mok,
                              min_inliers=25)
        return int(res.n_inliers)

    def timed(fn):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))
    ms_match, ms_pnp = timed(match), timed(pnp)
    ms_call = timed(lambda: sys_._relocalize(frame))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sys_._relocalize(frame)
        torch.cuda.synchronize()
    ev = prof.events()
    syncs = [e for e in ev if e.name in ("cudaStreamSynchronize",
                                         "cudaDeviceSynchronize",
                                         "cudaMemcpyAsync",
                                         "cudaEventSynchronize")]
    inside = {}
    for e in ev:
        if e.name in ("aten::linalg_eigh", "aten::linalg_svd"):
            r = e.time_range
            inside[e.name] = inside.get(e.name, 0) + sum(
                1 for c in syncs if c.thread == e.thread
                and r.start <= c.time_range.start < r.end)
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation]
    print(f"relocalization cost [{card}]: one call {ms_call:.3f} ms "
          f"(brute match [{frame.desc.shape[0]}, {P}] {ms_match:.3f} ms, "
          f"{idx.shape[0]} PnP hypotheses + polish {ms_pnp:.3f} ms; host "
          f"clock, median of {reps}); {len(dev)} kernel launches, "
          f"{len(syncs)} sync-like calls per call, of them inside "
          f"eigh / svd: {json.dumps(inside)}", flush=True)


def phase_tum(cfg, poses, frames, sems, card, n_frames: int = TUM_FRAMES):
    """scripts/run_tum_torch.py, in this process, on a TUM-format
    directory of the first n_frames frames with their masks (written under
    build/), the counts set to 0 just before and read just after. Checks
    the three output files and the JSON summary."""
    import contextlib
    import io
    import runpy
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    seq = os.path.join(root, "build", "tum_smoke", "seq")
    res_dir = os.path.join(root, "build", "tum_smoke", "out")
    shutil.rmtree(os.path.dirname(seq), ignore_errors=True)
    t0 = time.perf_counter()
    write_tum_dir(seq, cfg, poses[:n_frames],
                  [(d, rgb, sems[i]) for i, (_, d, rgb)
                   in enumerate(frames[:n_frames])])
    write_s = time.perf_counter() - t0
    argv = sys.argv
    sys.argv = ["run_tum_torch.py", "--seq", seq, "--semantic-dir",
                os.path.join(seq, "semantic"), "--out", res_dir]
    buf = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(root, "scripts", "run_tum_torch.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    run_s = time.perf_counter() - t0
    launches = read_counts("TUM driver", n_frames)
    lines = buf.getvalue().strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"TUM driver: no JSON summary in {lines[-3:]}")
    print(f"TUM driver [{card}]: wrote {n_frames} frames in {write_s:.1f} s, "
          f"ran in {run_s:.1f} s; summary {json.dumps(res)}; launches "
          f"{launches}", flush=True)
    cam = open(os.path.join(res_dir, "CameraTrajectory.txt")).read()
    kf = open(os.path.join(res_dir, "KeyFrameTrajectory.txt")).read()
    info = open(os.path.join(res_dir, "ObjectInfo.txt")).read().splitlines()
    if len(cam.splitlines()) != n_frames or not kf.strip():
        fail(f"TUM driver: {len(cam.splitlines())} camera poses, keyframe "
             f"file {len(kf)} bytes")
    if not (info and info[-1].startswith("semantic_constraints: ")
            and int(info[-1].split()[-1]) > 0):
        fail(f"TUM driver: ObjectInfo.txt reads {info}")
    if res.get("frames") != n_frames or not res.get("keyframes", 0) >= 2:
        fail(f"TUM driver: summary {res}")
    if not res.get("ate_rmse", 1.0) < 0.05:
        fail(f"TUM driver: ATE {res.get('ate_rmse')}")
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
    build.load_all(KERNELS)
    print(f"kernels {', '.join(KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = tum_cfg()
    t0 = time.perf_counter()
    poses, frames, sems = render(cfg, N_FRAMES)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)

    ex, levels, corners = main_path_inputs(cfg, frames[0][0])
    rows = [phase_patches(levels, corners),
            phase_describe(ex, levels, corners)]
    # every path: the counts set to 0 just before it, read just after
    by_phase = {}
    by_phase["strict_objects_off"] = run_path(cfg, poses, frames, sems,
                                              card, False)[2]
    by_phase["strict_objects_on"], strict_ms = phase_objects(
        cfg, poses, frames, sems, card)
    # the main path as bench.py runs it: the default configuration
    # (pipelined readback), blobs, objects on
    from object_slam_tpu_torch.config import SlamConfig
    main_cfg = SlamConfig.tum_rgbd()
    bench = phase_bench(main_cfg, poses, frames, sems, card, strict_ms)
    by_phase["bench_host_in_the_loop"] = bench["host"][0]
    by_phase["bench_device_resident"] = bench["device"][0]
    kid = phase_kidnap(main_cfg, make_scene(main_cfg), card)
    by_phase["kidnap_replay"] = kid["replay"]
    by_phase["kidnap_own_sampler"] = kid["own"]
    by_phase["tum_driver"] = phase_tum(main_cfg, poses, frames, sems, card)
    for row in rows:
        row["launches"] = by_phase["bench_host_in_the_loop"][row["name"]]
        row["launches_per_frame"] = row["launches"] // N_FRAMES
        row["launches_by_phase"] = {k: v[row["name"]]
                                    for k, v in by_phase.items()}
        timed = ("ms", "device_ms", "plain_ms", "bound_ms") + \
            (("library_ms",) if row["library_ms"] is not None else ())
        for k in timed:
            if not (isinstance(row[k], float) and math.isfinite(row[k])):
                fail(f"{row['name']} row field {k} is not a finite number")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
