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
  3. the slice with objects off: SlamSystem.track_rgbd on 40 rendered
     TUM-VGA frames (strict readback) on the card, with every kernel's
     launch count set to 0 before that run and read after it:
     orb_describe once per frame, extract_patches never;
  4. the main path, objects on: the same 40 frames with their detections
     (SlamSystem(enable_objects=True)), the counts again set to 0 before
     and read after; held to the JAX package's CPU run of the same frames
     (tests/torch_fixtures/objects_tum_vga.npz, make_reference.py): all
     frames tracked as the reference tracked them, the same keyframe
     frames, every frame's pose within 2 mm / 0.1 deg of the reference's,
     ATE < 0.05 m and within 0.02 mm of the reference's (below the
     0.05 mm that objects on moves it from objects off), the same object
     census, semantic constraints > 0 and within 10%;
  5. one JSON line of the kernels, the card line, and the last line
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
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "torch_fixtures", "objects_tum_vga.npz")


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


def render(cfg, n_frames):
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(n_frames, step=0.01)
    frames, sems = [], []
    for T in poses:
        gray, depth, rgb, sem = scene.render_rgbd(T)
        frames.append((gray.astype(np.float32), depth.astype(np.float32),
                       rgb.astype(np.float32)))
        sems.append(scene.sem_arrays(sem, cfg.semantic.max_instances))
    return poses, frames, sems


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


def run_path(cfg, poses, frames, sems, card, objects: bool):
    """SlamSystem.track_rgbd over the frames on the card, the kernels'
    launch counts set to 0 just before and read just after. Fails unless
    every frame tracks with no relocalization, ATE < 0.05 m and the
    launches are one orb_describe per frame and no extract_patches.
    Returns the system, the ATE, the launches, the per-frame Tcw [F, 4, 4]
    and the per-frame pose_ok flags."""
    import torch
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.ops import describe as dsc
    from object_slam_tpu_torch.ops import patch as patch_mod
    from object_slam_tpu_torch.slam.system import SlamSystem

    name = "objects on" if objects else "objects off"
    sys_ = SlamSystem(cfg, enable_objects=objects, device="cuda",
                      profile=True)
    counters = {"extract_patches": patch_mod.extract_patches,
                "orb_describe": dsc.orb_describe}
    for fn in counters.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in counters.items()}
    ate = ate_rmse(np.array(est), np.array(gt))
    steady = np.asarray(times[WARMUP:])
    n_kf, n_pts = sys_.n_keyframes, sys_.n_points
    stage = {k: float(np.mean(v[1:] if len(v) > 1 else v))
             for k, v in sys_.stage_ms.items()}
    print(f"{name} [{card}]: {sum(oks)}/{len(oks)} tracked, {n_kf} KFs, "
          f"{n_pts} points, ATE {ate:.6f} m, median "
          f"{np.median(steady):.3f} ms/frame, mean {np.mean(steady):.3f} "
          f"ms/frame ({1e3 / np.median(steady):.3f} frames/s median) after "
          f"{WARMUP} warm-up frames; reloc skipped {sys_.n_reloc_skipped}; "
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
    if sys_.n_reloc_skipped != 0:
        fail(f"{name}: {sys_.n_reloc_skipped} frames needed relocalization")
    if not ate < 0.05:
        fail(f"{name}: ATE {ate} m >= 0.05 m")
    want = {"extract_patches": 0, "orb_describe": len(frames)}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    return sys_, ate, launches, np.stack(tcws), oks


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
    sys_, ate, launches, tcws, tracked = run_path(cfg, poses, frames, sems,
                                                  card, True)
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
    _, _, launches_off, _, _ = run_path(cfg, poses, frames, sems, card, False)
    launches = phase_objects(cfg, poses, frames, sems, card)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_per_frame"] = row["launches"] // N_FRAMES
        row["launches_objects_off"] = launches_off[row["name"]]
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
