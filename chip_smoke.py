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
     tracking paths since orb_describe took its place; its path is the
     BRIEF-pattern learner of 11, through extract_patches_levels: one
     launch per render) and orb_describe (one launch for the frame; one
     for a KITTI pair, beside the pair's two one-image launches);
  3. strict readback, objects off: SlamSystem.track_rgbd on 40 rendered
     TUM-VGA frames (pipelined_readback=False) on the card, its
     StageProfiler report printed (as in 4), with every
     kernel's launch count set to 0 before that run and read after it:
     orb_describe once per frame (and per stereo pair), extract_patches
     never (the same holds, counted the same way, for every run below);
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
     writer), decoding through the native prefetcher
     (object_slam_tpu_torch/native, built here with g++): the three
     output files and the JSON summary; then that directory decoded by
     the prefetcher at the driver's settings, every array equal to the
     port's PNG reader's byte for byte; then with --viz-dir (strict
     readback): an overlay PNG per frame, the scrubber and map pages;
     then graft_entry.entry() on the card and dryrun_multichip(card
     count), one sharded GBA step over spawned NCCL ranks;
  7b. loop closing at full width (SlamSystem(SlamConfig.tum_rgbd(),
     enable_objects=True, enable_loop=True), the 10^4-word vocabulary):
     the JAX circuit's accepted closure stage by stage from the JAX state
     just before it (loop_pass_tum_vga.npz, the Sim3 draws replayed; each
     check's limit at LOOP_PASS_LIMITS and beside it), then with three
     planted faults (the pose graph skipped, the GBA skipped, T12
     inverted), each of which must fail a check; the circuit
     (loop_trajectory, LOOP_FRAMES frames over LOOP_TURNS turns, blobs as
     bench.py packs them, pipelined, objects on) replayed against
     loop_circuit_tum_vga.npz (flags, keyframes, census and events equal;
     records, records after the closure and ATE within LOOP_NOISE_MARGIN
     times the JAX run's one-ulp noise spread), with its own decisions (an
     accepted closure within 2 keyframes of one the JAX package accepts on
     this circuit, ATE below the JAX run's with the loop off), and with
     the loop off on its first 40 frames (the ms/frame baseline);
     scripts/diag_loop_torch.py's closure probe rides the replay (each
     closure's (q, l, accepted) as the JAX run's, its Sim3 and drift
     errors within the circuit's record band of the JAX closure's, and
     the probe with q and l exchanged shown to miss that band); the
     replayed circuit once more with the closure's correction dropped,
     which must fail a band; the kidnap of 6
     with the loop on, the LOST frames relocalizing through the BoW
     candidates (kidnap_loop_tum_vga.npz, the PnP draws replayed); then
     run_tum_torch.py --loop on the 12 frames of 7;
  8. KITTI stereo at full width (SlamConfig.kitti_stereo(): 1241x376,
     2000 features, n_kp 2048, 65536 points, 1024 keyframes): first one
     local-mapping pass of the JAX sync drive stage by stage on the card
     (kitti_pass.npz: each stage on the JAX stage's input, held to its
     output; the local BA's keyframes within the JAX BA's own one-ulp
     spread, and the BA skipped shown to fail that limit); then the first
     24 frames of scripts/make_synth_kitti.py's street canyon, rendered by
     a pool of processes (render seconds printed; orb_describe is also
     held to its plain version at the left image's shapes, as in 2);
     track_stereo(gray_l, gray_r, rgb=None, detections), objects on, the
     default fused pipelined path, with inline mapping, then with the
     mapping pass on a worker thread and side stream (async), each twice:
     with the JAX CPU run's keyframe decisions replayed (held to that run,
     kitti_stereo.npz: identical tracked flags and keyframe frames, the
     census equal, semantic constraints within 10%, 0.1 deg, records and
     ATE within KITTI_NOISE_MARGIN times the distance of the farthest of
     the JAX run's own one-ulp noise runs that kept its keyframes), and
     with its own decisions (the main path: flags, census and constraints
     held, the keyframes against the CPU port's where KITTI_WITNESS_KFS
     holds them, else printed with the first differing decision's inputs,
     ATE < 0.1 m); at least one abbreviated-schedule pass and, async, one
     keyframe-barrier merge; one orb_describe per stereo pair; ms/frame of the
     runs side by side. Then the replayed drive three times with a fault
     planted in the mapping path (local BA skipped, sync and async; the
     pass's result dropped at the async merge), each of which must fail a
     check; then 32 frames of a longer drive on which cars pass within
     ThDepth x baseline, async, replayed, held to kitti_objects.npz
     (objects form: census identical, constraints within 10%);
  9. scripts/run_kitti_torch.py on 10 of those frames written as a KITTI
     directory with a YOLACT-format semantic folder under build/;
 10. in a second process on the same card, started after the build and
     run beside 2-7b (the card is idle most of the time in every phase:
     the port is bound by host dispatch; its output is printed when it
     ends, and this process fails with it), first the phases below, then
     8 and 9:
     mono at EuRoC width (SlamConfig.euroc_stereo(), sensor "mono":
     752x480, 1200 features, n_kp 1280, 49,152 points, 768 keyframes,
     objects off): the two-view initializer on the JAX run's matched pair
     with its winning index sets, held to the JAX run handed the same
     (mono_euroc.npz "pinned") within MONO_NOISE_MARGIN times the spread
     of the JAX runs with one-ulp noise in the pixels, with all its 200 +
     200 sets (the same ok), and two planted faults (the rotation
     transposed, the H/F selection dropped) that must fail; the mono drive
     (40 frames of bench.py's room at the EuRoC camera, track_mono, fused
     pipelined), replayed (those bands; keyframes within 2 frames of those
     of one of the JAX runs) and with its own sampler (initialized within a frame of JAX,
     as many frames tracked, Sim(3) ATE within 2x JAX's); localization
     mode at TUM VGA, objects on (30 frames map, 14 pan past the mapped
     region and back in the mode, 8 map again), held to
     localization_tum_vga.npz (flags, VO frames, no map growth in the
     mode, records 2 mm / 0.1 deg, keyframes, census), then two planted
     faults (the mode's gate left open, the temporal points dropped) that
     must fail; a checkpoint round trip (shutdown(path) then
     load_into_system on the same system, TUM VGA objects on, deterministic
     algorithms) bit-identical to a flush-only run, and the file equal to
     the map field for field; scripts/run_euroc_torch.py stereo (held to
     the JAX run of the same decoded frames, euroc_driver.npz) and --mono
     on a 10-frame mav0 directory written under build/, each through the
     prefetcher, and that directory's arrays held to the PNG reader's;
     then 8 and 9 (the KITTI directory's arrays held to the PNG reader's
     too); then the four KITTI retention probes of slice 12
     (phase_probe_kitti) on a KITTI directory of the 24 street pairs of 8:
     scripts/diag_kitti_retention_torch.py over 12 frames,
     diag_kitti_torch.py, diag_local_recovery_torch.py and
     diag_motion_chain_torch.py over 8, the drives with the reference
     run's keyframe decisions replayed, each held to the JAX CPU run
     (probes_vga.npz) beside its pinned one-ulp noise runs, one
     orb_describe per pair asserted, one launch at a probe frame's shapes
     held to its plain version, and the motion search's level window made
     symmetric (must fail);
 10b. batched tracking (phase_batched) of 4 sequences at TUM-VGA width
     in the second process after the mono phases, each element held to
     the single-sequence calls, two maps swapped (must fail), 4
     orb_describe per step; and in the fourth process after its probes
     (moved from the second, for the time limit), the sharded
     GBA (phase_sharded_ba) on the loop pass's GBA input at full caps:
     one process, run_sharded_global_ba over NCCL at the card count (one
     card: bit-identical), over 2 gloo ranks spawned on one card (held to
     the loop pass's GBA band and to the one-process result within
     tests/test_torch_parallel.py's tolerance), and with a rank that
     keeps its own per-point sums (must fail);
 11. in a third process on the same card, started beside the second,
     the offline tools (tools_child_main): scripts/make_synth_tum_torch.py
     (40 frames) and make_synth_kitti_torch.py (24) under build/, every
     file held to the reference scripts' (experiments.npz: the text byte
     for byte, each PNG's decoded array bit for bit); the experiment
     battery of scripts/run_experiments_torch.py on those directories, 24
     frames per variant (t200_a, t200_b, objects off, the semantic
     optimizer off, async, the loop; KITTI inline and async), each held
     to the reference's functions on the same directories (phase
     docstring), one orb_describe per TUM frame and per KITTI pair;
     scripts/train_vocab_torch.py at full size (80 renders, 80
     orb_describe; the harvest's pyramid in the reference's order, one
     render's levels bit-equal to the CPU port's, the rows parting from
     the reference's only the CPU port's), the file byte for byte the
     reference's CPU run's;
     scripts/train_brief_pattern_torch.py at full size: the harvest (one
     orb_describe and one extract_patches_levels per render, each launch
     bit-exact to its plain version, 48 of each asserted), the selection
     over ~60.7k tests x 50,000 patches on the card, its quality line
     beside the committed pattern's; then the selection on an integer
     corpus of 8000 patches held row for row to the reference's main()
     (a parting row must sit on a float tie);
 6 and 7b's kidnap with the loop on run in the third and the fourth
     process, beside the main process's other phases (the time limit);
 11b. in a fourth process, started beside the others, the accuracy
     studies at TUM-VGA width (studies_child_main, against
     studies_vga.npz): scripts/ab_deviations_torch.py's four mapping
     variants (--scale 1) on 40 frames of its circuit (flags, keyframes,
     records, ATE) and no_reelect with its flag ignored (must fail);
     scripts/diag_loop_alias_torch.py's corridor through the JAX run's
     first rejection, replayed (events exact, numbers within the JAX
     one-ulp spread) and with its own decisions (no accepted closure,
     each rejection by the JAX run's gate within 2 keyframes), with
     orb_describe held to its plain version on a corridor frame, then the
     first candidate's recorded input through the pre-gate and, with the
     pre-gate disabled (a planted fault), the post-gates; the two
     semantic probes (scripts/diag_semopt_torch.py,
     diag_semopt_ragged_torch.py) on 24 frames of a TUM directory written
     under build/ (poses before and after the refinement, summary,
     census; the pose before the refinement thrown away, and masks from
     another seed, must fail); one orb_describe per frame asserted in
     every run; then the retention and pose-solver probes of slice 12
     (phase_probe_retention, phase_probe_pose):
     scripts/diag_retention_torch.py at TUM VGA on its 30-frame orbit
     (OSLAM_DUMP's writer on) and --loc-only on 12 frames, held to
     probes_vga.npz beside the pinned noise runs, the loc-only run again
     with debug_last's motion result replaced by the local one (must
     fail); diag_poseopt_torch.py's 18 initializations; diag_replay_torch
     and diag_gnsteps_torch on the reference's two VGA dumps, and the
     replays with the pose gates exchanged (must fail);
 11c. the single-card stage timers of slice 13, each held by what its
     timed calls compute to the JAX CPU runs in stages.npz
     (torch_fixtures/stage_bands.py): at the end of the main process,
     scripts/diag_fullpipe_torch.py on the first 16 of its TUM-VGA renders
     (the bytes line, flags, keyframes, poses within 2 mm / 0.1 deg, the
     reference's profiler spans; counted bit-packed, the bytes line must
     miss); at the end of the second process (the one that ends first),
     diag_ba_profile_torch.py at its own size (the seven
     ba_iterate variants, scatter forms included, within the bands of the
     reference's one-ulp noise runs, their kernel launches per call; the
     per-point scatter sums over obs_kf must miss); in the third process
     after the battery, diag_kitti_stages_torch.py on 12 frames of the
     make_synth_kitti_torch.py directory with the reference's keyframe
     decisions replayed (the map's census and the eleven stages' counts,
     the tracking step's flags and the keyframe counts with no floor; two
     stages on the map from before the 12th frame, and the fused stage
     with its keyframe decision negated, must miss); and in
     11's BRIEF harvest, the first render's IC angles from orb_describe
     held to 2's describe tolerance (offset by one bin, they must miss);
 11d. the multi-device scripts and the op-level stage trace of slice 14:
     in a fifth process, started beside the others (it ends first),
     scripts/ab_async_device_torch.py
     at --scale 2 (320x240, objects on) on 16 frames of its circuit
     (phase_async_device: orb_describe held at the circuit's shapes; sync,
     async, and async through _AsyncMapping's second-device branch with
     cuda:0 on both sides, ready() pinned, each held to async_device.npz
     with multidevice_bands.py; the merge dropping the pass's result on
     8 frames must miss; one unpinned async run printed), then
     scripts/bench_ba_scaling_torch.py at the
     reference's size (phase_ba_scaling: NCCL at the card count, 2 gloo
     ranks on cuda:0, every rank bit-equal to rank 0 and within
     the BA band of the one-process global_ba; a rank without the point
     all-reduce must miss); in the third process after 11c's KITTI stage
     timer, on its drive, scripts/diag_trace_stage_torch.py's three
     stages traced under torch.profiler (phase_trace_stage: the build
     stage lists one orb_describe launch, each stage's kernels sum to at
     most its wall time);
 12. one JSON line of the kernels (orb_describe: launches from the main
     path of 5, host-in-the-loop, and per phase, with its KITTI-pair,
     EuRoC-, corridor-, KITTI-probe-frame and ab-circuit numbers;
     extract_patches: its
     launches on the BRIEF
     harvest of 11 and its numbers at the harvest's shapes, one render's
     launch beside the 8 per-level launches it took before, with the
     frame-shape numbers of 2 beside them), the phase
     seconds, the card line, and the last line {"ok": true, "device":
     {...}}.

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
# KITTI stereo (SlamConfig.kitti_stereo(), full width): the JAX CPU runs of
# make_synth_kitti.py's first 24 frames, sync and async mapping
KITTI_REF = os.path.join(FIXTURES, "kitti_stereo.npz")
KITTI_FRAMES = 24
KITTI_WARMUP = 4
KITTI_DRIVER_FRAMES = 10
# the bands: the street canyon is at scale 8 (points 10-100 units away),
# where the JAX package's own local BA moves a keyframe by millimetres
# when its input points move by one float32 ulp (kitti_pass.npz: 3.8-5.3
# mm), and each pass feeds the next; the fixture holds the JAX run under
# such noise (make_reference.py ulp_noise), and a record or the ATE may
# lie KITTI_NOISE_MARGIN times as far from the JAX run as the farthest of
# its noise runs that kept its keyframes (kitti_bands). Readings (PERF.md
# section 6): working ports land at 0.36 (the CPU) and 0.72 (the card) of
# that farthest record distance in sync, 0.54 and 1.34 in async; faults
# planted in the mapping path (phase_kitti_controls) at 2.5 and more, with
# ATEs of 109-111 mm against ATE limits of 48.6 / 37.8 mm
KITTI_NOISE_MARGIN = 2.0
# one mapping pass of the sync drive, stage by stage (make_reference.py
# kitti_pass). Every field not named here must equal the JAX stage's
# output: the culls and the fusion decide by counts and thresholds. Named:
# the largest absolute difference of a float field in scene units (the
# triangulated points lie 10-100 units away; the CPU port reads 4.2e-4,
# 4.5e-4, 1.6e-3 and 4.2e-7 for xyz, min / max distance and normal), or
# None: printed only (the local BA's points and outlier decisions move as
# chaotically as its keyframes; its keyframes are held by phase_kitti_pass
# to KITTI_NOISE_MARGIN times the JAX BA's own one-ulp spread, where the
# BA skipped lands 204 mm away)
KITTI_PASS_REF = os.path.join(FIXTURES, "kitti_pass.npz")
KITTI_PASS_LIMITS = {
    "triangulate": {"pt_xyz": 5e-3, "pt_min_dist": 5e-3,
                    "pt_max_dist": 2e-2, "pt_normal": 1e-5},
    "point_stats": {"pt_normal": 1e-5},
    "local_ba": {"pt_xyz": None, "pt_valid": None, "pt_n_obs": None,
                 "kf_kp_pt": None, "kf_pose": None},
}
# the witness for the card's own keyframe decisions: the port's run of
# the same drive on the CPU (scripts/diag_kitti_card_cpu.py dump --device
# cpu --frames 24 [--async-mapping]), which keeps the JAX run's keyframes
# in both modes. The card agrees with it to one float32 ulp up to the
# local BA, whose passes on keyframes 2 and 3 land 0.7 and 4.6 mm apart
# (the JAX BA against itself under one ulp: 3.8-5.3 mm); in sync, frame 7
# then reads 336 inliers on the card against 340 on the CPU, at a
# threshold of 336.6, and the runs part. So sync is not held (None); the
# async run's decisions do not come that close and are held
KITTI_WITNESS_KFS = {"sync": None, "async": (0, 1, 2, 3, 8, 13, 18, 22)}
# the drive on which objects form (make_reference.py kitti_objects)
KITTI_OBJ_REF = os.path.join(FIXTURES, "kitti_objects.npz")
KITTI_OBJ_DRIVE = 40
KITTI_OBJ_FIRST = 8
# the port's own keyframe decisions: a sanity bound on the ATE (the JAX
# runs and their noise runs read 12.9-39.9 mm)
KITTI_OWN_ATE_M = 0.1
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


def device_ms(fn, kernel: str, reps: int = 20, attempts: int = 5) -> float:
    """Device time of the CUDA kernels whose name holds `kernel`, per call
    of fn(), summed over their launches, from torch.profiler's trace. A
    trace that holds none of them is taken again, up to `attempts` times
    (with three processes on the card a trace has come back without its
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if spans:
            return sum(spans) / reps / 1e3
        print(f"the profiler traced no {kernel} on the card (trace "
              f"{attempt + 1} of {attempts})", flush=True)
    fail(f"the profiler traced no {kernel} on the card")


def tum_cfg():
    from object_slam_tpu_torch.config import SlamConfig, TrackingConfig
    return SlamConfig.tum_rgbd().replace(
        tracking=TrackingConfig(pipelined_readback=False))


def render(cfg, n_frames):
    """orbit_poses(n_frames, step=0.01) in bench.py's room, rendered by a
    pool of processes: (poses, [(gray, depth, rgb) float32], [sem])."""
    from object_slam_tpu_torch.datasets.synthetic import (orbit_poses,
                                                          render_room)
    poses = orbit_poses(n_frames, step=0.01)
    out, _ = render_room(cfg, poses)
    return poses, [f[:3] for f in out], [f[3] for f in out]


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
    from object_slam_tpu_torch.features import pyramid as pyr

    calls = []
    for l, ys_t, xs_t in corners:
        for im in (levels[l], pyr.gaussian_blur(levels[l]).contiguous()):
            calls.append((im, ys_t, xs_t))
    row = patch_row(calls, "one TUM frame's 16 windows per level")
    return {"name": "extract_patches", "route": "cuda",
            "source": "object_slam_tpu_torch/csrc/patch_extract.cu",
            "replaces": "object_slam_tpu/ops/patch_pallas.py:74",
            "launches": 0, **row}


def patch_row(calls, tag):
    """extract_patches on the calls [(img, ys, xs)], each launch held
    bit-exact to its plain version on the same inputs, then timed as one
    batch of launches (CUDA events; the device time from torch.profiler),
    beside the plain version, an advanced-indexing gather and the bound."""
    import torch
    from object_slam_tpu_torch.ops import patch as patch_mod

    max_err = 0.0
    for im, ys_t, xs_t in calls:
        k = patch_mod.extract_patches_cuda(im, ys_t, xs_t)
        p = patch_mod.extract_patches_ref(im, ys_t, xs_t)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail("extract_patches kernel differs from its plain version")
        max_err = max(max_err, float((k - p).abs().max()))

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
    # touch read once (the union of an image's windows; each corner array
    # once, shared by the calls that pass it)
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
    print(f"extract_patches ({tag}): {len(calls)} launches, {n_patches} "
          f"windows; kernel {ms * 1e3:.1f} us ({dev_ms * 1e3:.2f} us on "
          f"the device), plain {plain_ms * 1e3:.1f} us, gather "
          f"{library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us "
          f"({n_bytes / 2 ** 20:.2f} MiB); bit-exact", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def patch_levels_row(levels, ys, xs, lvl, tag):
    """extract_patches_levels on one call (a pyramid's windows over every
    level), held bit-exact to its plain version on the same inputs, then
    timed (CUDA events; the device time from torch.profiler) beside the
    per-level launches of extract_patches that the same windows took
    before (one per level; also held bit-exact), the plain version, one
    advanced-indexing gather per level and the bound."""
    import torch
    from object_slam_tpu_torch.ops import patch as patch_mod

    k = patch_mod.extract_patches_levels_cuda(levels, ys, xs, lvl)
    p = patch_mod.extract_patches_levels_ref(levels, ys, xs, lvl)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        fail("extract_patches_levels kernel differs from its plain version")
    max_err = float((k - p).abs().max()) if k.numel() else 0.0
    per_level = []
    for l, im in enumerate(levels):
        sel = torch.nonzero(lvl == l)[:, 0]
        if sel.numel():
            per_level.append((im, ys[sel].contiguous(),
                              xs[sel].contiguous(), sel))
    for im, y, x, sel in per_level:
        if not torch.equal(patch_mod.extract_patches_cuda(im, y, x), k[sel]):
            fail("extract_patches differs from extract_patches_levels")

    def run_kernel():
        patch_mod.extract_patches_levels_cuda(levels, ys, xs, lvl)

    def run_per_level():
        for im, y, x, _ in per_level:
            patch_mod.extract_patches_cuda(im, y, x)

    def run_plain():
        patch_mod.extract_patches_levels_ref(levels, ys, xs, lvl)

    gathers = []
    for im, y, x, _ in per_level:
        H, W = im.shape
        d = torch.arange(32, device="cuda")
        y0 = y.long().clamp(0, H - 32)
        x0 = x.long().clamp(0, W - 32)
        gathers.append((im, y0[:, None, None] + d[None, :, None],
                        x0[:, None, None] + d[None, None, :]))

    def run_library():
        for im, yy, xx in gathers:
            im[yy, xx]

    ms = cuda_time_ms(run_kernel)
    dev_ms = device_ms(run_kernel, "patch_extract_levels_kernel")
    per_level_ms = cuda_time_ms(run_per_level)
    per_level_dev_ms = device_ms(run_per_level, "patch_extract_kernel")
    plain_ms = cuda_time_ms(run_plain)
    library_ms = cuda_time_ms(run_library)
    # bound: every output byte written once, every pixel the windows touch
    # read once (the union per level), the three index arrays read once
    n_bytes = 3 * ys.shape[0] * 4
    for im, yy, xx in gathers:
        touched = torch.zeros(im.shape, dtype=torch.bool, device="cuda")
        touched[yy, xx] = True
        n_bytes += yy.shape[0] * 32 * 32 * 4 + int(touched.sum()) * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"extract_patches_levels ({tag}): 1 launch, {ys.shape[0]} windows "
          f"over {len(per_level)} levels; kernel {ms * 1e3:.1f} us "
          f"({dev_ms * 1e3:.2f} us on the device), the {len(per_level)} "
          f"per-level launches {per_level_ms * 1e3:.1f} us "
          f"({per_level_dev_ms * 1e3:.2f} us on the device), plain "
          f"{plain_ms * 1e3:.1f} us, gather {library_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({n_bytes / 2 ** 20:.2f} MiB); "
          f"bit-exact", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "per_level_launches": len(per_level),
            "per_level_ms": per_level_ms,
            "per_level_device_ms": per_level_dev_ms}


def angle_bins(a):
    """The steered-BRIEF rotation bin of each angle."""
    import torch
    from object_slam_tpu_torch.ops import describe as dsc
    return torch.remainder(torch.round(
        a / (2.0 * math.pi) * dsc.N_ANGLE_BINS).to(torch.int64),
        dsc.N_ANGLE_BINS)


def angle_hold(k_ang, p_ang, near, valid=None):
    """orb_describe's angles k_ang against its plain version's p_ang, as
    phase_describe states the tolerance: (the largest difference mod 2 pi
    outside the keypoints near the plain version's stability gate, the
    share of keypoints whose rotation bins agree, the number near the
    gate, the number of those that differ by more than 1e-5), over the
    keypoints of valid (all if None)."""
    import torch
    if valid is not None:
        k_ang, p_ang, near = k_ang[valid], p_ang[valid], near[valid]
    err = (torch.remainder(k_ang.double() - p_ang.double() + math.pi,
                           2 * math.pi) - math.pi).abs()
    max_err = float(err[~near].max()) if bool((~near).any()) else 0.0
    same = angle_bins(k_ang) == angle_bins(p_ang)
    return (max_err, float(same.double().mean()), int(near.sum()),
            int((near & (err > 1e-5)).sum()), same)


def angle_misses(max_err, same_frac):
    """The describe tolerance's misses: angles beyond 1e-5 rad outside the
    near-gate keypoints, bins agreeing for less than 99.9%."""
    out = []
    if not max_err <= 1e-5:
        out.append(f"angle error {max_err:.3e} rad > 1e-5")
    if same_frac < 0.999:
        out.append(f"bins agree for only {same_frac:.6f}")
    return out


def phase_describe(ex, levels, corners, tag: str = "TUM VGA",
                   halves=None, timed: bool = True):
    """orb_describe against its plain version at the main path's shapes:
    one launch for an image's keypoints over all levels (or, for a stereo
    pair, both images' in one launch of a 16-level table: `halves` then
    splits corners into the two images', and the two one-image launches
    the pair took before are timed beside it).

    Tolerance: angles within 1e-5 rad (mod 2 pi) except where the plain
    version's stability margin |mag - tau * mass| is below 1e-4 tau mass
    (counted and printed); descriptors bit-exact wherever the two angles
    fall in the same bin; bins equal for >= 99.9% of keypoints. The kernel
    sums the moments in another order than torch, and the bin rounding
    and the gate see that; the blur and bf16 rounding are bit-exact.
    timed=False checks the launch only (no timings in the row)."""
    import torch
    from object_slam_tpu_torch.ops import describe as dsc

    lv = [levels[l] for l, _, _ in corners]
    cy = torch.cat([ys for _, ys, _ in corners])
    cx = torch.cat([xs for _, _, xs in corners])
    lvl = torch.cat([torch.full_like(ys, i)
                     for i, (_, ys, _) in enumerate(corners)])
    args = (lv, cy, cx, lvl, ex.brief_idx1, ex.brief_idx2)
    radius = ex.cfg.orb.half_patch
    # the launch as the extractor keeps it (OrbDescribe: checked once, only
    # the level pointers rewritten per call), which the event clock times
    call = dsc.OrbDescribe([tuple(t.shape) for t in lv], "cuda",
                           ex.brief_idx1, ex.brief_idx2, radius)
    k_ang, k_desc = call(lv, cy, cx, lvl)
    p_ang, p_desc = dsc.orb_describe_ref(*args, radius=radius)
    near = dsc.near_gate(lv, cy, cx, lvl, radius=radius)
    torch.cuda.synchronize()

    max_err, same_frac, n_near, n_near_diff, same = angle_hold(
        k_ang, p_ang, near)
    bad_bits = int(torch.sum(k_desc[same] != p_desc[same]))
    n = cy.shape[0]

    ms = dev_ms = plain_ms = float("nan")
    if timed:
        ms = cuda_time_ms(lambda: call(lv, cy, cx, lvl))
        dev_ms = device_ms(lambda: call(lv, cy, cx, lvl),
                           "orb_describe_kernel")
        plain_ms = cuda_time_ms(lambda: dsc.orb_describe_ref(
            *args, radius=radius))
    two = {}
    if halves is not None:
        calls = []
        for part in halves:
            p_lv = [levels[l] for l, _, _ in part]
            calls.append((
                dsc.OrbDescribe([tuple(t.shape) for t in p_lv], "cuda",
                                ex.brief_idx1, ex.brief_idx2, radius),
                p_lv, torch.cat([ys for _, ys, _ in part]),
                torch.cat([xs for _, _, xs in part]),
                torch.cat([torch.full_like(ys, i)
                           for i, (_, ys, _) in enumerate(part)])))
        for (call, *a), lo in zip(calls, (0, calls[0][2].shape[0])):
            h_ang, h_desc = call(*a)
            torch.cuda.synchronize()
            hi = lo + h_ang.shape[0]
            if not (torch.equal(h_ang, k_ang[lo:hi])
                    and torch.equal(h_desc, k_desc[lo:hi])):
                fail(f"orb_describe ({tag}): the pair's launch differs from "
                     f"the one-image launch")

        def run_two():
            for call, *a in calls:
                call(*a)
        if timed:
            two = {"two_launches_ms": cuda_time_ms(run_two),
                   "two_launches_device_ms": device_ms(
                       run_two, "orb_describe_kernel")}
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
    n_bytes += int(torch.unique(angle_bins(k_ang)).numel()) * 2 * 256 * 2
    n_bytes += n * 3 * 4 + n * (4 + 8 * 4)
    d = np.arange(32) - 15
    n_circ = int(np.sum(d[:, None] ** 2 + d[None, :] ** 2 <= radius ** 2))
    f32_ops = n * ((38 * 32 + 32 * 32) * 7 * 2 + 256)
    f64_ops = n * n_circ * 5
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = (f32_ops / F32_FLOP_PER_S + f64_ops / F64_FLOP_PER_S) * 1e3
    bound_ms = max(byte_ms, op_ms)
    print(f"orb_describe ({tag}): 1 launch, {n} keypoints over {len(lv)} "
          f"levels; "
          f"kernel {ms * 1e3:.1f} us ({dev_ms * 1e3:.2f} us on the device), "
          f"plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.3f} us ({n_bytes / 2 ** 20:.2f} MiB, "
          f"{byte_ms * 1e3:.3f} us; {(f32_ops + f64_ops) / 1e6:.1f} MFLOP, "
          f"{op_ms * 1e3:.3f} us); max angle error {max_err:.3e} rad outside "
          f"{n_near} near-gate keypoints ({n_near_diff} of them differ); "
          f"bins agree {same_frac:.6f}; {bad_bits} descriptor words differ "
          f"where bins agree"
          + ("" if not two else
             f"; the two one-image launches {two['two_launches_ms'] * 1e3:.1f}"
             f" us ({two['two_launches_device_ms'] * 1e3:.2f} us on the "
             f"device), each bit-equal to its half of the pair's"),
          flush=True)
    bad = angle_misses(max_err, same_frac)
    if bad:
        fail("orb_describe: " + "; ".join(bad))
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
            "library_ms": None, **two,
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


def read_counts(name: str, n_frames: int, per_frame: int = 1):
    """The launches since zero_counts(); fails unless they are per_frame
    orb_describe per frame (one per image: dark frames too, since the
    extractor describes its whole fixed-size keypoint slab, so the grid is
    never empty; one for a stereo pair's two images) and no
    extract_patches."""
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"extract_patches": 0, "orb_describe": per_frame * n_frames}
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
    # profile: the stage profiler, under the reference's span names
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
    stage = {k: float(np.mean(v[1:] if len(v) > 1 else v)) * 1e3
             for k, v in sys_.profiler.samples.items()}
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
    print(f"{name} StageProfiler report [{card}] (each span synchronizes "
          f"the card at both ends):\n{sys_.profiler.report()}", flush=True)
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


_KIDNAP_FRAMES = {}


def kidnap_frames(cfg, ref):
    """The kidnap's frames (float32 gray, depth, rgb, detections; dark
    frames zero) in bench.py's room, each view rendered once by a pool of
    processes and kept for the next phase on the same poses."""
    from object_slam_tpu_torch.datasets.synthetic import render_room
    poses, blank = ref["poses"], ref["blank"]
    key = (poses.tobytes(), blank.tobytes())
    if key in _KIDNAP_FRAMES:
        return _KIDNAP_FRAMES[key]
    H, W = cfg.camera.height, cfg.camera.width
    views = {T.tobytes(): T for T, dark in zip(poses, blank) if not dark}
    rendered, secs = render_room(cfg, list(views.values()))
    cache = dict(zip(views, rendered))
    dark = (np.zeros((H, W), np.float32), np.zeros((H, W), np.float32),
            np.zeros((H, W, 3), np.float32), None)
    frames = [dark if d else cache[T.tobytes()] for T, d in zip(poses, blank)]
    print(f"kidnap: rendered {len(cache)} views for {len(frames)} frames in "
          f"{secs:.1f} s with a pool of processes", flush=True)
    _KIDNAP_FRAMES[key] = frames
    return frames


def phase_kidnap(cfg, card):
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
    poses = ref["poses"]
    frames = kidnap_frames(cfg, ref)
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


def phase_tum(cfg, poses, frames, sems, card, n_frames: int = TUM_FRAMES,
              loop: bool = False, extra=(), out: str = "out",
              write: bool = True):
    """scripts/run_tum_torch.py, in this process, on a TUM-format
    directory of the first n_frames frames with their masks (written under
    build/ unless write is False), the counts set to 0 just before and
    read just after. Checks the three output files and the JSON summary;
    with loop, run_tum_torch.py runs with --loop: every keyframe gets a
    BoW row and no loop closes on these 12 frames of an orbit. extra: more
    driver arguments; out: the output directory's name. Returns the
    launches."""
    import contextlib
    import io
    import runpy
    import shutil
    from object_slam_tpu_torch.datasets.tum import write_sequence

    root = os.path.dirname(os.path.abspath(__file__))
    seq = os.path.join(root, "build", "tum_smoke", "seq")
    res_dir = os.path.join(root, "build", "tum_smoke", out)
    t0 = time.perf_counter()
    if write:
        shutil.rmtree(os.path.dirname(seq), ignore_errors=True)
        write_sequence(seq, poses[:n_frames],
                       [(d, rgb, sems[i]) for i, (_, d, rgb)
                        in enumerate(frames[:n_frames])],
                       cfg.camera.depth_map_factor)
    write_s = time.perf_counter() - t0
    argv = sys.argv
    sys.argv = ["run_tum_torch.py", "--seq", seq, "--semantic-dir",
                os.path.join(seq, "semantic"), "--out", res_dir] + (
                    ["--loop"] if loop else []) + list(extra)
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
    name = " ".join(["TUM driver"] + (["--loop"] if loop else [])
                    + list(extra))
    launches = read_counts(name, n_frames)
    lines = buf.getvalue().strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"TUM driver: no JSON summary in {lines[-3:]}")
    print(f"{name} [{card}]: wrote {n_frames} frames in {write_s:.1f} s, "
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
    if loop and not (res.get("bow_rows") == res["keyframes"]
                     and res.get("loops_closed") == 0
                     and res.get("loop_events") == []):
        fail(f"TUM driver --loop: summary {res}")
    return launches


def hold_prefetch_decode(name, jobs, card, capacity):
    """The drivers' native prefetcher at their settings (4 worker threads,
    capacity images ahead, every job submitted up front under its index
    and taken in order) on a directory's files: each decoded array must
    equal the port's PNG reader's (datasets/png.py::read_png) byte for
    byte, dtype and shape too. jobs: [(image path, depth path or None)]."""
    from object_slam_tpu_torch.datasets.png import read_png
    from object_slam_tpu_torch.native.loader import FramePrefetcher
    t0 = time.perf_counter()
    pf = FramePrefetcher(n_workers=4, capacity=capacity)
    try:
        for i, (img, depth) in enumerate(jobs):
            pf.submit(i, img, depth)
        got = [pf.get(i) for i in range(len(jobs))]
    finally:
        pf.close()
    ms = (time.perf_counter() - t0) * 1e3
    for i, ((img, depth), (a, d, _)) in enumerate(zip(jobs, got)):
        pairs = [(img, a)] + ([(depth, d)] if depth else [])
        for path, arr in pairs:
            ref = read_png(path)
            if not (arr.dtype == ref.dtype and np.array_equal(arr, ref)):
                fail(f"{name}: the prefetcher's {os.path.basename(path)} "
                     f"({arr.dtype} {arr.shape}) differs from read_png's "
                     f"({ref.dtype} {ref.shape})")
    print(f"{name} prefetcher [{card}]: {len(jobs)} jobs decoded in "
          f"{ms:.1f} ms, every array equal to read_png's byte for byte",
          flush=True)


def phase_prefetch_driver(cfg, poses, frames, sems, card):
    """The TUM driver phase's directory (the driver decodes through the
    native prefetcher) decoded by the prefetcher at the driver's settings
    and held to the port's PNG reader, array by array; then
    run_tum_torch.py with --viz-dir: an overlay PNG per frame, the
    scrubber page and the map page. Returns the --viz-dir run's
    launches."""
    from object_slam_tpu_torch.datasets import tum
    root = os.path.dirname(os.path.abspath(__file__))
    seq = os.path.join(root, "build", "tum_smoke", "seq")
    hold_prefetch_decode("TUM driver", [
        (fr.rgb_path, fr.depth_path) for fr in tum.load_sequence(seq)],
        card, capacity=8)
    viz = os.path.join(root, "build", "tum_smoke", "viz")
    viz_launches = phase_tum(cfg, poses, frames, sems, card,
                                extra=["--viz-dir", viz], out="out_viz",
                                write=False)
    want = [f"frame_{i:05d}.png" for i in range(TUM_FRAMES)] + [
        "index.html", "map.html"]
    files = sorted(os.listdir(viz))
    if files != want:
        fail(f"TUM driver --viz-dir wrote {files}")
    page = open(os.path.join(viz, "index.html")).read()
    if f"({TUM_FRAMES} frames)" not in page:
        fail("TUM driver --viz-dir: the scrubber page lacks its frames")
    print(f"TUM driver --viz-dir [{card}]: wrote {len(files)} files",
          flush=True)
    return viz_launches


# ---------------------------------------------------------------------------
# KITTI stereo at full width: one mapping pass stage by stage, the drive
# sync and async (with planted faults that must fail), objects, the driver
# ---------------------------------------------------------------------------

def kitti_bands(ref, mode: str):
    """(record band m, ATE band m) of one mode: KITTI_NOISE_MARGIN times
    the largest distance from the JAX run of its own one-ulp noise runs
    (make_reference.py ulp_noise), per record and in ATE. Only noise runs
    that tracked the frames and kept the keyframes the JAX run kept count:
    a flipped decision is another trajectory, not noise."""
    rec = ref[f"{mode}.rec_tcw"][:, :3, 3]
    runs = sorted({k.split(".")[2] for k in ref.files
                   if k.startswith(f"noise.{mode}.")})
    kept = [k for k in runs
            if np.array_equal(ref[f"noise.{mode}.{k}.kf_frames"],
                              ref[f"{mode}.kf_frames"])
            and np.array_equal(ref[f"noise.{mode}.{k}.tracked"],
                               ref[f"{mode}.tracked"])]
    if len(kept) < 3:
        fail(f"KITTI: {KITTI_REF} holds {len(kept)} {mode} noise runs with "
             f"the reference's keyframes (of {len(runs)}); 3 are needed")
    d_rec = max(float(np.linalg.norm(
        ref[f"noise.{mode}.{k}.rec_tcw"][:, :3, 3] - rec, axis=1).max())
        for k in kept)
    d_ate = max(abs(float(ref[f"noise.{mode}.{k}.ate"])
                    - float(ref[f"{mode}.ate"])) for k in kept)
    return KITTI_NOISE_MARGIN * d_rec, KITTI_NOISE_MARGIN * d_ate


def kitti_drive(poses, frames, async_mapping: bool, ref_kfs=(),
                replay: bool = False, control=None):
    """SlamSystem(SlamConfig.kitti_stereo(), the default fused pipelined
    path).track_stereo(gray_l, gray_r, rgb=None, detections) over frames,
    then flush_mapping. replay=True gives each frame the keyframe decision
    of the reference (frame in ref_kfs) at resolve time, as the kidnap
    phase replays its RANSAC sets; either way each frame's own decision
    and its inputs are kept. control plants a fault in the mapping path:
    "no_local_ba" (every pass skips its local BA) or, async, "drop_pass"
    (every pass's result is dropped at the merge). Returns the run's
    records, keyframes, ATE, object census and timings."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.slam import local_mapping
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(SlamConfig.kitti_stereo(), enable_objects=True,
                      async_mapping=async_mapping, device="cuda")
    decisions = {}          # frame -> (own decision, n_inliers, peak)
    own = sys_._need_keyframe

    def need_keyframe(pend, p):
        d = own(pend, p)
        decisions[pend["fid"]] = (d, int(p[trk.PACKED_N_INLIERS]),
                                  int(sys_._kf_inliers))
        return (pend["fid"] in ref_kfs) if replay else d
    sys_._need_keyframe = need_keyframe
    run_local_ba = local_mapping.run_local_ba
    if control == "no_local_ba":
        local_mapping.run_local_ba = lambda **kw: kw["m"]
    elif control == "drop_pass":
        sys_._async._merge_impl = lambda res, m_now, *a: m_now
    elif control is not None:
        raise ValueError(control)
    try:
        torch.cuda.synchronize()
        times = []
        t_all = time.perf_counter()
        for i, (gl, gr, sa) in enumerate(frames):
            t0 = time.perf_counter()
            sys_.track_stereo(gl, gr, None, sa, timestamp=i / 10.0)
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sys_.flush_mapping()
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        total_s = time.perf_counter() - t_all
    finally:
        local_mapping.run_local_ba = run_local_ba
    recs = sys_.trajectory
    m = sys_.map
    fin = np.stack([t[1] for t in sys_.final_trajectory()])
    ok = np.asarray([r.tracked for r in recs])
    est = np.stack([np.linalg.inv(T)[:3, 3] for T in fin])[ok]
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])[ok]
    labels = m.obj_label[m.obj_valid].cpu().numpy()
    lab, cnt = np.unique(labels, return_counts=True)
    res = {"tracked": ok.tolist(),
           "rec_tcw": np.stack([r.Tcw for r in recs]),
           "kf_frames": m.kf_frame_id[m.kf_valid].cpu().numpy().tolist(),
           "ate": float(ate_rmse(est, gt)),
           "census": dict(zip(lab.tolist(), cnt.tolist())),
           "n_sem": int(sys_.objects.semantic_constraints),
           "mapping": dict(sys_.mapping_stats),
           "worker_ms": list(sys_._async.worker_ms
                             if sys_._async is not None else []),
           "decisions": decisions, "times": times, "flush_ms": flush_ms,
           "total_s": total_s}
    sys_.shutdown()
    return res


def kitti_checks(res, ref, mode: str, replay: bool, bands):
    """The checks a KITTI drive is held to against the JAX run of
    ref[mode]: [(name, reading, limit, passed)]. Tracked flags, the census
    and semantic constraints (within 10%) always; with replay, also the
    keyframe frames and every record within 0.1 deg and the record band,
    the ATE within the ATE band of the JAX ATE (bands: kitti_bands; None:
    not held); with the port's own decisions, the keyframes against the
    witness, if one is given (bands[2]); the ATE below KITTI_OWN_ATE_M.
    Returns the checks and each record's distance from the JAX record."""
    rec_band, ate_band, witness = bands
    ref_rec = ref[f"{mode}.rec_tcw"]
    d_t = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
           for a, b in zip(res["rec_tcw"], ref_rec)]
    d_r = [rot_deg(a[:3, :3], b[:3, :3])
           for a, b in zip(res["rec_tcw"], ref_rec)]
    ref_census = dict(zip(ref[f"{mode}.census_labels"].tolist(),
                          ref[f"{mode}.census_counts"].tolist()))
    ref_sem = int(ref[f"{mode}.semantic_constraints"])
    ref_kfs = ref[f"{mode}.kf_frames"].tolist()
    ref_ate = float(ref[f"{mode}.ate"])
    out = [("tracked flags", sum(res["tracked"]),
            f"{sum(ref[f'{mode}.tracked'].tolist())} (identical)",
            res["tracked"] == ref[f"{mode}.tracked"].tolist()),
           ("census", res["census"], ref_census,
            res["census"] == ref_census),
           ("semantic constraints", res["n_sem"], f"{ref_sem} +- 10%",
            abs(res["n_sem"] - ref_sem) <= 0.1 * ref_sem)]
    if replay:
        out += [("keyframes", res["kf_frames"], ref_kfs,
                 res["kf_frames"] == ref_kfs),
                ("record deg", round(max(d_r), 5), 0.1, max(d_r) < 0.1)]
    if replay and rec_band is not None:
        out += [("record mm", round(max(d_t) * 1e3, 4),
                 round(rec_band * 1e3, 4), max(d_t) < rec_band),
                ("ATE mm", round(res["ate"] * 1e3, 4),
                 f"{ref_ate * 1e3:.4f} +- {ate_band * 1e3:.4f}",
                 abs(res["ate"] - ref_ate) <= ate_band)]
    elif witness is not None:
        out.append(("keyframes against the witness", res["kf_frames"],
                    witness, res["kf_frames"] == list(witness)))
    out.append(("ATE below", round(res["ate"] * 1e3, 4),
                KITTI_OWN_ATE_M * 1e3, res["ate"] < KITTI_OWN_ATE_M))
    return out, d_t


def phase_kitti(poses, frames, card, async_mapping: bool, replay: bool,
                witness=None):
    """The KITTI drive on the card (kitti_drive), the counts set to 0 just
    before and read just after (one orb_describe per pair), held to the
    JAX CPU run of the same frames (KITTI_REF, sync or async) by
    kitti_checks; at least one abbreviated-schedule pass and, async, one
    keyframe-barrier merge. Returns the launches and (median, mean)
    ms/frame."""
    mode = "async" if async_mapping else "sync"
    name = f"KITTI {mode} " + ("replay" if replay else "own decisions")
    ref = np.load(KITTI_REF)
    ref_kfs = ref[f"{mode}.kf_frames"].tolist()
    zero_counts()
    res = kitti_drive(poses, frames, async_mapping, ref_kfs, replay)
    launches = read_counts(name, len(frames))
    steady = np.asarray(res["times"][KITTI_WARMUP:])
    print(f"{name} [{card}]: median {np.median(steady):.3f} ms/frame, mean "
          f"{np.mean(steady):.3f} ms/frame after {KITTI_WARMUP} warm-up "
          f"frames; {len(frames)} frames in {res['total_s']:.2f} s; flush "
          f"{res['flush_ms']:.3f} ms; mapping {json.dumps(res['mapping'])}; "
          f"mapping-thread pass ms "
          f"{json.dumps([round(x, 1) for x in res['worker_ms']])}; launches "
          f"{launches}", flush=True)
    print(f"{name} frame ms: "
          + json.dumps([round(t, 3) for t in res["times"]]), flush=True)
    checks, d_t = kitti_checks(res, ref, mode, replay,
                               kitti_bands(ref, mode) + (witness,))
    dec = res["decisions"]
    differ = [f for f in sorted(dec) if dec[f][0] != (f in ref_kfs)]
    first = (f"first at frame {differ[0]}: own decision {dec[differ[0]][0]}"
             f", n_inliers {dec[differ[0]][1]}, peak since the last "
             f"keyframe {dec[differ[0]][2]}" if differ else "none")
    print(f"{name}: KFs at {res['kf_frames']} (reference {ref_kfs}); the "
          f"port's own decisions differ from the reference's at frames "
          f"{differ} ({first}); per record mm "
          f"{json.dumps([round(d * 1e3, 4) for d in d_t])}; checks "
          + "; ".join(f"{n} {r} (limit {lim}){'' if ok else ' FAILED'}"
                      for n, r, lim, ok in checks), flush=True)
    bad = [n for n, _, _, ok in checks if not ok]
    if bad:
        fail(f"{name}: {', '.join(bad)} outside the limits")
    st = res["mapping"]
    if st["abbreviated"] < 1:
        fail(f"{name}: no mapping pass ran the abbreviated schedule")
    if async_mapping and st["barrier_merges"] < 1:
        fail(f"{name}: no keyframe-barrier merge happened")
    return launches, (float(np.median(steady)), float(np.mean(steady)))


def phase_kitti_controls(poses, frames, card):
    """The replayed drive with a fault planted in the mapping path
    (kitti_drive's controls): each must fail at least one of the checks
    that phase_kitti holds the real runs to, or those checks could not
    tell a broken mapping path from a working one."""
    ref = np.load(KITTI_REF)
    for mode, control in (("sync", "no_local_ba"), ("async", "no_local_ba"),
                          ("async", "drop_pass")):
        res = kitti_drive(poses, frames, mode == "async",
                          ref[f"{mode}.kf_frames"].tolist(), True, control)
        checks, _ = kitti_checks(res, ref, mode, True,
                                 kitti_bands(ref, mode) + (None,))
        failed = [f"{n} {r} (limit {lim})" for n, r, lim, ok in checks
                  if not ok]
        print(f"KITTI control {mode} {control} [{card}]: fails "
              f"{'; '.join(failed) or 'nothing'}", flush=True)
        if not failed:
            fail(f"KITTI control {mode} {control}: a mapping path with this "
                 f"fault passes every check")


def phase_kitti_objects(card):
    """The KITTI drive on which objects form (KITTI_OBJ_REF: frames
    KITTI_OBJ_FIRST.. of the KITTI_OBJ_DRIVE-frame street canyon, cars
    passing within ThDepth x baseline), async mapping, objects on, the JAX
    run's keyframe decisions replayed, the counts set to 0 just before and
    read just after (one orb_describe per pair): tracked flags, keyframes
    and the object census identical to the JAX CPU run's, semantic
    constraints within 10%, records within 0.1 deg; the records' distance
    and the ATE against the JAX run's are printed."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import render_street
    ref = np.load(KITTI_OBJ_REF)
    poses, frames, secs = render_street(SlamConfig.kitti_stereo(),
                                        KITTI_OBJ_DRIVE, KITTI_OBJ_FIRST)
    sums = [float(np.sum(f[0], dtype=np.float64)) for f in frames]
    if not np.allclose(sums, ref["gray_sum"], rtol=1e-12, atol=0):
        fail("KITTI objects: the rendered frames differ from the "
             "reference run's")
    zero_counts()
    res = kitti_drive(poses, frames, True, ref["async.kf_frames"].tolist(),
                      True)
    launches = read_counts("KITTI objects", len(frames))
    checks, d_t = kitti_checks(res, ref, "async", True, (None, None, None))
    steady = np.asarray(res["times"][KITTI_WARMUP:])
    print(f"KITTI objects async replay [{card}]: rendered {len(frames)} "
          f"pairs in {secs:.1f} s; median {np.median(steady):.3f} ms/frame, "
          f"mean {np.mean(steady):.3f}; mapping "
          f"{json.dumps(res['mapping'])}; census {res['census']}, "
          f"semantic constraints {res['n_sem']}; ATE "
          f"{res['ate'] * 1e3:.4f} mm (JAX "
          f"{float(ref['async.ate']) * 1e3:.4f}); records at most "
          f"{max(d_t) * 1e3:.4f} mm from the JAX run's; launches "
          f"{launches}; checks "
          + "; ".join(f"{n} {r} (limit {lim}){'' if ok else ' FAILED'}"
                      for n, r, lim, ok in checks), flush=True)
    bad = [n for n, _, _, ok in checks if not ok]
    if bad:
        fail(f"KITTI objects: {', '.join(bad)} outside the limits")
    if not res["census"] or res["n_sem"] < 1:
        fail("KITTI objects: no object formed")
    return launches


def map_diff(got, want, fields):
    """{field: largest absolute difference (float) or count of differing
    entries (integer)} over fields, the equal ones left out."""
    out = {}
    for f in fields:
        a, b = got[f], want[f]
        if a.dtype.kind == "f":
            e = float(np.max(np.abs(a - b))) if a.size else 0.0
            if e > 0:
                out[f] = e
        elif not np.array_equal(a, b):
            out[f] = int(np.sum(a != b))
    return out


def phase_kitti_pass(card):
    """One local-mapping pass of the KITTI sync drive (the pass on keyframe
    3, abbreviated schedule), stage by stage on the card: each stage of
    local_mapping.pass_stages runs on the JAX stage's output before it
    (kitti_pass.npz) and is held to the JAX stage's output. The decision
    stages (point culling, fusion, keyframe culling) must agree exactly;
    triangulation and the point statistics in KITTI_PASS_LIMITS; the local
    BA's keyframe poses within KITTI_NOISE_MARGIN times the farthest that
    the JAX BA moves them from itself under one-ulp input noise. A planted
    fault, the BA skipped, must fail that limit."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.slam import local_mapping
    from object_slam_tpu_torch.slam.frame import FrameBuilder
    from object_slam_tpu_torch.slam.map_state import init_map

    fx = np.load(KITTI_PASS_REF)
    cfg = SlamConfig.kitti_stereo()
    base = interop.map_state_to_numpy(init_map(
        cfg.caps, cfg.objects.history_capacity, device="cpu"))
    kf, fast = int(fx["kf"]), bool(fx["fast"])
    names = fx["stages"].tolist()
    states = interop.stage_maps(fx, base, names)
    tb = FrameBuilder(cfg, device="cuda")

    def T(d):
        return interop.map_state_from_numpy(d, device="cuda")
    W = local_mapping.covisibility(T(states["in"]))[kf]
    stages = dict(local_mapping.pass_stages(
        tb.K, kf, tb.scale_factors, tb.inv_sigma2, cfg, W,
        tuple(cfg.mapping.ba_abort_iters) if fast else None))
    if list(stages) != names:
        fail(f"KITTI pass: stages {list(stages)}, fixture {names}")
    prev, readings, bad = "in", {}, []
    for n in names:
        t0 = time.perf_counter()
        got = interop.map_state_to_numpy(stages[n](T(states[prev])))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = states[n]
        changed = sorted({k.split(".", 1)[1].split("@")[0] for k in fx.files
                          if k.startswith(n + ".")})
        d = map_diff(got, want, list(want))
        readings[n] = d
        lim = KITTI_PASS_LIMITS.get(n, {})
        for f, v in d.items():
            if lim.get(f, 0) is not None and v > lim.get(f, 0):
                bad.append(f"{n} {f} {v} (limit {lim.get(f, 0)})")
        print(f"KITTI pass on keyframe {kf} [{card}], {n} ({ms:.1f} ms; "
              f"the JAX stage changed {changed}): against the JAX stage "
              f"{json.dumps(d)}", flush=True)
        prev = n
    kv = states["local_ba"]["kf_valid"]

    def kf_move(a, b):
        return float(np.max(np.linalg.norm(
            a["kf_pose"][kv][:, :3, 3] - b["kf_pose"][kv][:, :3, 3],
            axis=1)))
    ba_limit = KITTI_NOISE_MARGIN * float(np.max(fx["ba_ulp_kf_move"]))
    got_ba = interop.map_state_to_numpy(
        stages["local_ba"](T(states["point_stats"])))
    port_move = kf_move(got_ba, states["local_ba"])
    skipped = kf_move(states["point_stats"], states["local_ba"])
    print(f"KITTI pass local BA [{card}]: keyframes {port_move * 1e3:.4f} "
          f"mm from the JAX BA's (limit {ba_limit * 1e3:.4f} mm: "
          f"{KITTI_NOISE_MARGIN} x the JAX BA against itself under one-ulp "
          f"input noise, "
          f"{json.dumps([round(x * 1e3, 4) for x in fx['ba_ulp_kf_move']])}"
          f" mm); control, the BA skipped: {skipped * 1e3:.4f} mm",
          flush=True)
    if port_move > ba_limit:
        bad.append(f"local_ba kf_pose {port_move} m (limit {ba_limit} m)")
    if not skipped > ba_limit:
        bad.append(f"control: the BA skipped lands {skipped} m from the "
                   f"JAX BA, within the limit {ba_limit} m")
    if bad:
        fail("KITTI pass: " + "; ".join(bad))
    return readings, port_move, skipped


def phase_kitti_driver(poses, frames, card,
                       n_frames: int = KITTI_DRIVER_FRAMES):
    """scripts/run_kitti_torch.py, in this process, on a KITTI directory of
    the first n_frames frames with a YOLACT-format semantic folder
    (written under build/), the counts set to 0 just before and read just
    after (one orb_describe per pair). Checks the three output files and
    the JSON summary."""
    import contextlib
    import io
    import runpy
    import shutil
    from object_slam_tpu_torch.datasets.kitti import write_sequence

    root = os.path.dirname(os.path.abspath(__file__))
    seq = os.path.join(root, "build", "kitti_smoke", "seq")
    res_dir = os.path.join(root, "build", "kitti_smoke", "out")
    shutil.rmtree(os.path.dirname(seq), ignore_errors=True)
    t0 = time.perf_counter()
    write_sequence(seq, poses[:n_frames], frames[:n_frames])
    write_s = time.perf_counter() - t0
    argv = sys.argv
    sys.argv = ["run_kitti_torch.py", "--seq", seq, "--gt",
                os.path.join(seq, "gt.txt"), "--semantic-dir",
                os.path.join(seq, "semantic"), "--out", res_dir]
    buf = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(root, "scripts",
                                        "run_kitti_torch.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    run_s = time.perf_counter() - t0
    launches = read_counts("KITTI driver", n_frames)
    lines = buf.getvalue().strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"KITTI driver: no JSON summary in {lines[-3:]}")
    print(f"KITTI driver [{card}]: wrote {n_frames} frames in {write_s:.1f} "
          f"s, ran in {run_s:.1f} s; summary {json.dumps(res)}; launches "
          f"{launches}", flush=True)
    cam = open(os.path.join(res_dir, "CameraTrajectory.txt")).read()
    kf = open(os.path.join(res_dir, "KeyFrameTrajectory.txt")).read()
    info = open(os.path.join(res_dir, "ObjectInfo.txt")).read().splitlines()
    if len(cam.splitlines()) != n_frames or not kf.strip():
        fail(f"KITTI driver: {len(cam.splitlines())} camera poses, keyframe "
             f"file {len(kf)} bytes")
    if not (info and info[-1].startswith("semantic_constraints: ")):
        fail(f"KITTI driver: ObjectInfo.txt reads {info}")
    if (res.get("frames") != n_frames or res.get("tracked") != n_frames
            or not res.get("keyframes", 0) >= 2 or not res["async_mapping"]):
        fail(f"KITTI driver: summary {res}")
    if not res.get("ate_rmse", 1.0) < 0.05:
        fail(f"KITTI driver: ATE {res.get('ate_rmse')}")
    return launches


def phase_kitti_prefetch(card):
    """The KITTI driver phase's directory decoded by the native prefetcher
    at run_kitti_torch.py's settings (left image under 2i, right under
    2i + 1), held to the port's PNG reader array by array."""
    from object_slam_tpu_torch.datasets import kitti
    root = os.path.dirname(os.path.abspath(__file__))
    seq = os.path.join(root, "build", "kitti_smoke", "seq")
    jobs = []
    for fr in kitti.load_sequence(seq):
        jobs += [(fr.left_path, None), (fr.right_path, None)]
    hold_prefetch_decode("KITTI driver", jobs, card, capacity=6)


# ---------------------------------------------------------------------------
# loop closing at TUM-VGA width: one closure stage by stage, the circuit
# replayed and with its own decisions, the kidnap through the BoW
# relocalization
# ---------------------------------------------------------------------------

LOOP_PASS_REF = os.path.join(FIXTURES, "loop_pass_tum_vga.npz")
LOOP_CIRCUIT_REF = os.path.join(FIXTURES, "loop_circuit_tum_vga.npz")
KIDNAP_LOOP_REF = os.path.join(FIXTURES, "kidnap_loop_tum_vga.npz")
LOOP_STAGES = ("bow", "propagate", "fuse", "pose_graph", "gba")
# the circuit (make_reference.py loop_circuit_tum_vga): loop_trajectory
# over LOOP_FRAMES frames, LOOP_TURNS turns, in bench.py's room
LOOP_FRAMES = 120
LOOP_TURNS = 1.15
# the loop-off baseline's depth: its ms/frame is compared with the own
# decisions run's over the same frames WARMUP..LOOP_OFF_FRAMES-1 (a depth
# cut for the script's time limit; PERF.md section 4)
LOOP_OFF_FRAMES = 40
# records and ATE of the replayed circuit: LOOP_NOISE_MARGIN times the
# farthest of the JAX run's own one-ulp noise runs that kept its flags,
# keyframes and closure (the closure's input carries the noise too)
LOOP_NOISE_MARGIN = 2.0
# the closure stage by stage, each stage on the JAX stage's input (float
# limits in metres; see PERF.md section 6 for the readings): the
# propagation is a few f32 products per pose and point; the fusion's
# bindings may differ where a projection sits on a window or Hamming
# threshold; the pose graph is 20 dense GN solves; the GBA keyframes are
# held to LOOP_NOISE_MARGIN times the JAX GBA's own one-ulp spread
LOOP_PASS_LIMITS = {
    "propagate": {"kf_pose": 1e-5, "pt_xyz": 1e-5},
    "fuse_bindings": 8,
    "pose_graph": {"kf_pose": 1e-4, "pt_xyz": 1e-4},
}
# the Sim3 after Gauss-Newton (translation entries in metres; rotation
# entries), and the guided count
SIM3_T12_LIMIT = 1e-4
GUIDED_BAND = 2
# the closure's quality numbers (mean Huber cost per observation):
# relative; the gate decisions must be equal
LOOP_Q_RTOL = 1e-3


def loop_events(evs):
    return [(e["q"], e["l"], bool(e["accepted"]), bool(e.get("pre_gated",
                                                             False)))
            for e in evs]


def phase_loop_pass(card, fault=None):
    """The circuit's accepted closure stage by stage (loop_pass_tum_vga.npz:
    the JAX closer's input map and host state, every stage's output). The
    port's closer runs on_keyframe on that input with the JAX Sim3 draws
    replayed and is held, stage after stage of its own run, to: the BoW
    row's words exact and values within 1e-6; the candidates and the
    consistency groups exact; every attempt's match pairs exact; the
    RANSAC winner's inliers exact; T12 / s12 after Gauss-Newton within
    SIM3_T12_LIMIT; the guided count within GUIDED_BAND; the gate numbers,
    q before and after within LOOP_Q_RTOL, the events' decisions equal.
    Then each map stage runs again on the JAX stage's input and is held to
    its output within LOOP_PASS_LIMITS, the GBA's keyframes within
    LOOP_NOISE_MARGIN times the JAX GBA's own one-ulp spread. fault plants
    one of "no_pose_graph", "no_gba", "inverted_t12"; returns the failed
    checks (the caller fails on any, or on none for a fault)."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.geometry import sim3
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.loop.loop_closing import LoopCloser
    from object_slam_tpu_torch.slam.map_state import init_map
    from object_slam_tpu_torch.solvers import sim3_solver

    fx = np.load(LOOP_PASS_REF)
    cfg = SlamConfig.tum_rgbd()
    lc = LoopCloser(cfg, Intrinsics.from_config(cfg.camera), device="cuda")
    base = interop.map_state_to_numpy(init_map(
        cfg.caps, cfg.objects.history_capacity,
        n_bow_words=lc.vocab.n_words, device="cpu"))
    states = interop.stage_maps(fx, base, LOOP_STAGES)
    q = int(fx["q"])
    interop.loop_state_from_numpy(
        lc, {k[len("state_in."):]: fx[k] for k in fx.files
             if k.startswith("state_in.")})
    bad, readings = [], {}

    def T(d):
        return interop.map_state_from_numpy(d, device="cuda")

    def npy(m):
        return interop.map_state_to_numpy(m)

    def sync():
        torch.cuda.synchronize()

    sets = [torch.from_numpy(s).cuda() for s in fx["sim3_sets"]]
    lc._minimal_sets = lambda valid, n_trials=256: sets.pop(0)
    rec = {"match": [], "ransac": [], "gn": [], "guided": []}
    match_pairs, guided = lc.match_pairs, lc.guided_matches
    ransac, gn = sim3_solver.sim3_ransac_sets, sim3_solver.sim3_gn_refine

    def match_fn(m, q_, l_):
        out = match_pairs(m, q_, l_)
        rec["match"].append((l_, [x.cpu().numpy() for x in out]))
        return out

    def ransac_fn(*a, **kw):
        r = ransac(*a, **kw)
        rec["ransac"].append(r)
        return r

    def gn_fn(*a, **kw):
        r = gn(*a, **kw)
        if fault == "inverted_t12":
            Ti, si = sim3.inverse(r[0], r[1])
            r = (Ti, si) + tuple(r[2:])
        rec["gn"].append(r)
        return r

    def guided_fn(*a):
        n = guided(*a)
        rec["guided"].append(n)
        return n
    lc.match_pairs, lc.guided_matches = match_fn, guided_fn
    sim3_solver.sim3_ransac_sets, sim3_solver.sim3_gn_refine = \
        ransac_fn, gn_fn
    pose_graph, gba = lc.pose_graph, lc.gba
    if fault == "no_pose_graph":
        lc.pose_graph = lambda m, *a: m
    elif fault == "no_gba":
        lc.gba = lambda m: m
    elif fault not in (None, "inverted_t12"):
        raise ValueError(fault)
    sync()
    t0 = time.perf_counter()
    try:
        m_out, closed = lc.on_keyframe(T(states["in"]), q)
        sync()
    finally:
        sim3_solver.sim3_ransac_sets, sim3_solver.sim3_gn_refine = ransac, gn
    wall_ms = (time.perf_counter() - t0) * 1e3

    # the BoW row and the detection
    m_in = T(states["in"])
    word, bow = lc.vocab.transform(m_in.kf_kp_desc[q], m_in.kf_kp_valid[q])
    n_word = int(np.sum(word.cpu().numpy() != fx["bow_word"]))
    e_bow = float(np.max(np.abs(bow.cpu().numpy() - fx["bow_row"])))
    readings["bow"] = {"words_differing": n_word, "max_abs_err": e_bow}
    if n_word or e_bow > 1e-6:
        bad.append(f"bow: {n_word} words differ, values {e_bow}")
    cand, _ = lc.detect(T(states["bow"]), q)
    if not np.array_equal(cand.cpu().numpy(), fx["cand"]):
        bad.append("detect: candidates differ")
    st = interop.loop_state_to_numpy(lc)
    for k in ("group_members", "group_sizes", "group_counts",
              "last_loop_kf", "cooldown"):
        if not np.array_equal(st[k], fx["state_out." + k]):
            bad.append(f"groups: {k} {st[k]} against "
                       f"{fx['state_out.' + k]}")
    # every Sim3 attempt
    want_l = fx["attempt_l"].tolist()
    if [l for l, _ in rec["match"]] != want_l:
        bad.append(f"attempts on {[l for l, _ in rec['match']]}, "
                   f"reference {want_l}")
    for i, (l, (pc_q, pc_l, mok, midx)) in enumerate(rec["match"][
            :len(want_l)]):
        if not (np.array_equal(mok, fx[f"match{i}.ok"])
                and np.array_equal(np.where(mok, midx, -1),
                                   np.where(fx[f"match{i}.ok"],
                                            fx[f"match{i}.idx"], -1))):
            bad.append(f"attempt {i} (l={l}): match pairs differ "
                       f"({int(mok.sum())} against "
                       f"{int(fx[f'match{i}.ok'].sum())})")
    for i, r in enumerate(rec["ransac"]):
        if f"ransac{i}.inliers" not in fx.files:
            bad.append(f"RANSAC {i}: the reference has no such attempt")
            continue
        if not np.array_equal(r.inliers.cpu().numpy(),
                              fx[f"ransac{i}.inliers"]):
            bad.append(f"RANSAC {i}: winner inliers differ "
                       f"({int(r.n_inliers)} against "
                       f"{int(fx[f'ransac{i}.n_inliers'])})")
    gn_err = []
    for i, r in enumerate(rec["gn"]):
        if f"gn{i}.T12" not in fx.files:
            bad.append(f"GN {i}: the reference has no such attempt")
            continue
        e = max(float(np.max(np.abs(r[0].cpu().numpy()
                                    - fx[f"gn{i}.T12"]))),
                abs(float(r[1]) - float(fx[f"gn{i}.s12"])))
        gn_err.append(e)
        if e > SIM3_T12_LIMIT:
            bad.append(f"GN {i}: T12 / s12 {e} from the reference's "
                       f"(limit {SIM3_T12_LIMIT})")
    readings["sim3_gn_max_abs_err"] = gn_err
    g_ref = fx["guided"].tolist()
    if len(rec["guided"]) != len(g_ref) or any(
            abs(a - b) > GUIDED_BAND for a, b in zip(rec["guided"], g_ref)):
        bad.append(f"guided counts {rec['guided']}, reference {g_ref}")
    ev_ref = json.loads(str(fx["events"]))
    ev = lc.events
    if loop_events(ev) != loop_events(ev_ref) or closed != any(
            e["accepted"] for e in ev_ref):
        bad.append(f"events {loop_events(ev)}, reference "
                   f"{loop_events(ev_ref)}")
    else:
        for a, b in zip(ev, ev_ref):
            for k in ("corr_trans", "corr_rot_deg", "q_before", "q_after",
                      "budget_deg", "budget_frac"):
                if k in b and abs(a[k] - b[k]) > 1e-6 + LOOP_Q_RTOL * abs(
                        b[k]):
                    bad.append(f"event {k} {a[k]} against {b[k]}")
    readings["events"] = [{k: v for k, v in e.items()} for e in ev]

    # each map stage on the JAX stage's input
    # the accepted closure is the call's last attempt
    l_acc = [e["l"] for e in ev_ref if e["accepted"]][0]
    n_gn = sum(1 for k in fx.files if k.startswith("gn")
               and k.endswith(".T12"))
    T12 = torch.from_numpy(fx[f"gn{n_gn - 1}.T12"]).cuda()
    s12 = torch.tensor(float(fx[f"gn{n_gn - 1}.s12"]), device="cuda")
    if fault == "inverted_t12":
        T12, s12 = sim3.inverse(T12, s12)
    stage_ms = {}

    def run_stage(name, fn, m):
        sync()
        t = time.perf_counter()
        out = fn(m)
        sync()
        stage_ms[name] = (time.perf_counter() - t) * 1e3
        return out
    got = {
        "propagate": npy(run_stage("propagate", lambda m: lc.propagate(
            m, q, l_acc, T12, s12)[0], T(states["bow"]))),
        "fuse": npy(run_stage("fuse", lambda m: lc.fuse(m, q, l_acc),
                              T(states["propagate"]))),
        "pose_graph": npy(run_stage("pose_graph", lambda m: lc.pose_graph(
            m, q, l_acc, T12, s12,
            torch.from_numpy(fx["propagate.T_old"]).cuda(),
            torch.from_numpy(fx["propagate.s_init"]).cuda()),
            T(states["fuse"]))),
        "gba": npy(run_stage("gba", lambda m: lc.gba(m),
                             T(states["pose_graph"]))),
    }
    for name in ("propagate", "pose_graph"):
        d = map_diff(got[name], states[name], ("kf_pose", "pt_xyz"))
        readings[name] = d
        for f, lim in LOOP_PASS_LIMITS[name].items():
            if d.get(f, 0.0) > lim:
                bad.append(f"{name} {f} {d[f]} (limit {lim})")
    d = map_diff(got["fuse"], states["fuse"],
                 ("kf_kp_pt", "pt_valid", "pt_n_obs"))
    readings["fuse"] = d
    if d.get("kf_kp_pt", 0) > LOOP_PASS_LIMITS["fuse_bindings"] or \
            d.get("pt_valid", 0) > LOOP_PASS_LIMITS["fuse_bindings"]:
        bad.append(f"fuse: {d} (limit {LOOP_PASS_LIMITS['fuse_bindings']} "
                   f"bindings)")
    kv = states["gba"]["kf_valid"]

    def kf_move(a, b):
        return float(np.max(np.linalg.norm(
            a["kf_pose"][kv][:, :3, 3] - b["kf_pose"][kv][:, :3, 3],
            axis=1)))
    gba_limit = LOOP_NOISE_MARGIN * float(np.max(fx["gba_ulp_kf_move"]))
    port_move = kf_move(got["gba"], states["gba"])
    readings["gba_kf_move"] = port_move
    if port_move > gba_limit:
        bad.append(f"gba keyframes {port_move} m from the JAX GBA's "
                   f"(limit {gba_limit} m)")
    # the whole closure's output against the chained JAX output
    chained = kf_move(npy(m_out), states["gba"]) if closed else math.inf
    readings["chained_kf_move"] = chained
    print(f"loop pass (q={q}) [{card}{', fault ' + fault if fault else ''}]"
          f": on_keyframe {wall_ms:.1f} ms; stages on the JAX input "
          f"{json.dumps({k: round(v, 3) for k, v in stage_ms.items()})} ms;"
          f" readings {json.dumps(readings)}; GBA limit "
          f"{gba_limit * 1e3:.4f} mm ({LOOP_NOISE_MARGIN} x the JAX GBA "
          f"against itself under one-ulp input noise, "
          f"{json.dumps([round(x * 1e3, 4) for x in fx['gba_ulp_kf_move']])}"
          f" mm); failed checks {bad}", flush=True)
    lc.pose_graph, lc.gba = pose_graph, gba
    return bad, wall_ms, stage_ms


def loop_circuit_frames(cfg):
    """The circuit's frames as bench.py packs them (u16 depth from the
    renderer's float64 depth, u8 rgb), with their detections, rendered by
    a pool of processes: (poses, [(gray checksum, d16, rgb8, sem)])."""
    from object_slam_tpu_torch.datasets.synthetic import (
        loop_trajectory, render_room_blobs)
    poses = np.stack(loop_trajectory(LOOP_FRAMES,
                                     sweep=2 * np.pi * LOOP_TURNS))
    frames, _ = render_room_blobs(cfg, poses)
    return poses, frames


def run_loop_circuit(cfg, poses, frames, ref, card, loop=True, replay=True,
                     control=None, probes=None):
    """The circuit through track_rgbd_blob (pipelined readback, objects
    on), with or without loop closing; replay: the JAX run's keyframe
    decisions and Sim3 draws. control "correction_dropped" plants a fault
    in the closure: the closer decides and records its event, and the map
    it returns is the one it was given. probes: a list that receives
    scripts/diag_loop_torch.py's ClosureProbe on the closer, its
    keyframe-to-frame map kept as the script keeps it. Returns the
    system, the inserted frames, the ATE over the frames run and each
    frame's host ms."""
    import torch
    from object_slam_tpu_torch.eval.ate import ate_rmse
    from object_slam_tpu_torch.slam.system import SlamSystem

    sys_ = SlamSystem(cfg, enable_objects=True, enable_loop=loop,
                      device="cuda")
    blobs = [sys_.builder.pack_frame_blob(d16, rgb8, sa)
             for _, d16, rgb8, sa in frames]
    inserts = []
    insert = sys_._insert_impl

    def insert_impl(m, frame, Tcw, kp_pt, close_mask, frame_id):
        inserts.append(int(frame_id))
        return insert(m, frame, Tcw, kp_pt, close_mask, frame_id)
    sys_._insert_impl = insert_impl
    if replay:
        ref_kfs = set(ref["insert_frames"].tolist())
        sys_._need_keyframe = lambda pend, p: pend["fid"] in ref_kfs
        sets = [torch.from_numpy(s).cuda() for s in ref["sim3_sets"]]

        def minimal_sets(valid, n_trials=256):
            if not sets:
                fail(f"loop circuit replay: more Sim3 draws than the "
                     f"reference's {len(ref['sim3_sets'])}")
            return sets.pop(0)
        if loop:
            sys_.loop_closer._minimal_sets = minimal_sets
    if control is not None:
        if control != "correction_dropped":
            raise ValueError(control)
        correct = sys_.loop_closer._correct_loop

        def correct_loop(m, q, l, T12, s12):
            return m, correct(m, q, l, T12, s12)[1]
        sys_.loop_closer._correct_loop = correct_loop
    probe = None
    if probes is not None:
        probe = script_module("diag_loop_torch").ClosureProbe(
            sys_.loop_closer, poses, log=lambda s: None)
        probes.append(probe)
    torch.cuda.synchronize()
    zero_counts()
    times = []
    for i, (blob, iv) in enumerate(blobs):
        t0 = time.perf_counter()
        if probe is not None:
            probe.current_frame[0] = i
        sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
        if probe is not None and sys_.last_kf_id >= 0 \
                and sys_.last_kf_id not in probe.kf_frame:
            probe.kf_frame[sys_.last_kf_id] = i
        times.append((time.perf_counter() - t0) * 1e3)
    sys_.flush_mapping()
    torch.cuda.synchronize()
    traj = sys_.final_trajectory()
    ok = np.array([t[2] for t in traj])
    est = np.stack([np.linalg.inv(t[1])[:3, 3] for t in traj])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses[:len(traj)]])
    return sys_, inserts, float(ate_rmse(est[ok], gt[ok])), times


def own_basins(ref):
    """The (q, l) of every closure the JAX package accepts on this circuit:
    the unperturbed run's and those of its free one-ulp noise runs (the
    circuit's closure is bimodal under one ulp, (31, 2) or (28, 0):
    PERF.md section 6)."""
    runs = [[(e["q"], e["l"], e["accepted"])
             for e in json.loads(str(ref["events"]))]]
    runs += [ev for ev, _ in json.loads(str(ref["free_noise"]))]
    return sorted({(q, l) for ev in runs for q, l, acc in ev if acc})


def closure_frame(ref):
    """The frame whose on_keyframe call accepted the reference's closure:
    the records of the frames after it are tracked on the corrected map."""
    rows = [f for f, _, closed in ref["on_keyframe"].tolist() if closed]
    if len(rows) != 1:
        fail(f"loop circuit: {LOOP_CIRCUIT_REF} closes {len(rows)} loops; "
             f"1 is needed")
    return rows[0]


def circuit_bands(ref):
    """(record band m, record band after the closure m, ATE band m, the
    frames after the closure): LOOP_NOISE_MARGIN times the farthest of
    the JAX run's own kept one-ulp noise runs from it, over all frames and
    over the frames tracked on the corrected map. Before the closure the
    noise runs drift apart by up to 46 mm; after it they agree within
    4.7 mm, while the correction moves the records by ~50 mm."""
    n = int(ref["n_noise"])
    if n < 3:
        fail(f"loop circuit: {LOOP_CIRCUIT_REF} holds {n} kept noise runs; "
             f"3 are needed")
    rec = ref["rec_tcw"][:, :3, 3]
    post = np.arange(closure_frame(ref) + 1, len(rec))
    d = [np.linalg.norm(ref[f"noise.{k}.rec_tcw"][:, :3, 3] - rec, axis=1)
         for k in range(n)]
    d_ate = max(abs(float(ref[f"noise.{k}.ate"]) - float(ref["ate"]))
                for k in range(n))
    return (LOOP_NOISE_MARGIN * max(float(x.max()) for x in d),
            LOOP_NOISE_MARGIN * max(float(x[post].max()) for x in d),
            LOOP_NOISE_MARGIN * d_ate, post)


def circuit_checks(ref, bands, sys_, inserts, ate):
    """The replayed circuit's checks, [(name, reading, limit, ok, band)]:
    tracked flags, keyframe frames, events and census equal; the farthest
    record, the farthest record after the closure and the ATE within
    circuit_bands (band True)."""
    rec_band, post_band, ate_band, post = bands
    recs = sys_.trajectory
    lc = sys_.loop_closer
    ev = loop_events(lc.events if lc is not None else [])
    ev_ref = loop_events(json.loads(str(ref["events"])))
    m = sys_.map
    labels = m.obj_label[m.obj_valid].cpu().numpy()
    census = {int(k): int(v) for k, v in zip(*np.unique(
        labels, return_counts=True))}
    census_ref = dict(zip(ref["census_labels"].tolist(),
                          ref["census_counts"].tolist()))
    tracked = [r.tracked for r in recs]
    if len(recs) != len(ref["rec_tcw"]):
        fail(f"loop circuit: {len(recs)} records for "
             f"{len(ref['rec_tcw'])} frames")
    d = np.array([np.linalg.norm(r.Tcw[:3, 3] - b[:3, 3])
                  for r, b in zip(recs, ref["rec_tcw"])])
    return [
        ("tracked flags", tracked, "equal",
         tracked == ref["tracked"].tolist(), False),
        ("keyframes at", inserts, ref["insert_frames"].tolist(),
         inserts == ref["insert_frames"].tolist(), False),
        ("events", ev, ev_ref, ev == ev_ref, False),
        ("census", census, census_ref, census == census_ref, False),
        ("farthest record m", float(d.max()), rec_band,
         float(d.max()) <= rec_band, True),
        (f"farthest record after the closure (frames {post[0]}-"
         f"{post[-1]}) m", float(d[post].max()), post_band,
         float(d[post].max()) <= post_band, True),
        ("ATE m", ate, f"{float(ref['ate'])} +- {ate_band}",
         abs(ate - float(ref["ate"])) <= ate_band, True),
    ]


def probe_reference(probe, poses, swap=False):
    """scripts/diag_loop_torch.py's numbers for the JAX run's closure: its
    Sim3 (loop_pass_tum_vga.npz gn0.T12) and keyframe poses at the closure's
    input, with the replayed probe's keyframe-to-frame map (the replay
    inserts on the reference's frames). swap: q and l exchanged (a planted
    fault in the probe, which must miss the bands)."""
    lp = np.load(LOOP_PASS_REF)
    q, l = int(lp["q"]), int(lp["attempt_l"][-1])
    if swap:
        q, l = l, q
    Tq, Tl = lp["in.kf_pose"][q], lp["in.kf_pose"][l]
    gt_q = poses[probe.kf_frame[q]]
    gt_l = poses[probe.kf_frame[l]]
    T12_gt = gt_q @ np.linalg.inv(gt_l)
    dT = lp["gn0.T12"] @ np.linalg.inv(T12_gt)
    dD = (Tq @ np.linalg.inv(Tl)) @ np.linalg.inv(T12_gt)
    return {"sim3_trans_err_mm": float(np.linalg.norm(dT[:3, 3]) * 1e3),
            "sim3_rot_err_deg": _rot_deg(np.eye(4), dT),
            "drift_trans_mm": float(np.linalg.norm(dD[:3, 3]) * 1e3),
            "drift_rot_deg": _rot_deg(np.eye(4), dD)}


def probe_checks(probe, poses, ref, band_m):
    """The closure probe of the replayed circuit against the JAX run's
    closure: the same (q, l, accepted) per closure, the Sim3's and the
    drift's translation errors within the circuit's record band
    (circuit_bands), [(what, port, reference, held)]."""
    want = loop_events(json.loads(str(ref["events"])))
    got = [(e["q"], e["l"], e["accepted"], False) for e in probe.events]
    checks = [("closures", got, [w for w in want], got == want)]
    if got == want and got:
        jx = probe_reference(probe, poses)
        e = probe.events[0]
        for k in ("sim3_trans_err_mm", "drift_trans_mm"):
            checks.append((k, e[k], f"{jx[k]} +- {band_m * 1e3}",
                           abs(e[k] - jx[k]) <= band_m * 1e3))
    return checks


def phase_loop_circuit(card):
    """The circuit (loop_circuit_tum_vga.npz) through the main path with
    loop closing on: replayed (the JAX run's keyframe decisions and Sim3
    draws), held by circuit_checks to its tracked flags, keyframe frames,
    census and events exactly and its records, records after the closure
    and ATE within circuit_bands; with its own decisions and sampler, held
    to at least one accepted closure, every accepted closure within 2
    keyframes of a closure the JAX package accepts on this circuit
    (own_basins), and an ATE below the JAX run's with loop closing off;
    and loop closing off on the first LOOP_OFF_FRAMES frames (the ms/frame
    baseline). One orb_describe launch per frame in each run. Returns the
    launches of each run, the wall ms of each closure the run with its own
    decisions accepted and the rendered circuit."""
    from object_slam_tpu_torch.config import SlamConfig
    ref = np.load(LOOP_CIRCUIT_REF)
    cfg = SlamConfig.tum_rgbd()
    t0 = time.perf_counter()
    poses, frames = loop_circuit_frames(cfg)
    if not np.allclose([f[0] for f in frames], ref["gray_sum"], rtol=1e-12,
                       atol=0):
        fail("loop circuit: the rendered frames differ from the reference "
             "run's")
    print(f"loop circuit: rendered {len(frames)} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bands = circuit_bands(ref)
    off_ate = float(ref["off.ate"])
    out, ms = {}, {}
    times = {}
    probes = []
    for name, loop, replay, n in (
            ("replay", True, True, len(frames)),
            ("own", True, False, len(frames)),
            ("loop_off", False, False, LOOP_OFF_FRAMES)):
        sys_, inserts, ate, times[name] = run_loop_circuit(
            cfg, poses, frames[:n], ref, card, loop=loop, replay=replay,
            probes=probes if name == "replay" else None)
        out[name] = read_counts(f"loop circuit {name}", n)
        steady = times[name][WARMUP:]
        ms[name] = (float(np.median(steady)), float(np.mean(steady)))
        if name == "loop_off":
            print(f"loop circuit loop_off [{card}]: frames 0-{n - 1}: "
                  f"ms/frame median {ms[name][0]:.3f} mean "
                  f"{ms[name][1]:.3f}; keyframes at {inserts}; ATE "
                  f"{ate * 1e3:.3f} mm over these frames", flush=True)
            continue
        checks = circuit_checks(ref, bands, sys_, inserts, ate)
        ev = sys_.loop_closer.events
        print(f"loop circuit {name} [{card}]: ms/frame median "
              f"{ms[name][0]:.3f} mean {ms[name][1]:.3f}; keyframes at "
              f"{inserts}; events {json.dumps(ev)}; ATE {ate * 1e3:.3f} mm "
              f"(JAX loop on {float(ref['ate']) * 1e3:.3f}, loop off "
              f"{off_ate * 1e3:.3f}); against the replayed run's checks: "
              + "; ".join(f"{c[0]} {c[1]} ({'held' if c[3] else 'missed'}, "
                          f"limit {c[2]})" for c in checks[2:]), flush=True)
        if name == "replay":
            failed = [c for c in checks if not c[3]]
            if failed:
                fail("loop circuit replay: " + "; ".join(
                    f"{c[0]} {c[1]} (limit {c[2]})" for c in failed))
            # scripts/diag_loop_torch.py's closure probe rode this run
            pchecks = probe_checks(probes[0], poses, ref, bands[0])
            print(f"closure probe [{card}]: {json.dumps(probes[0].events)}; "
                  f"the JAX closure's {json.dumps(probe_reference(probes[0], poses))}; "
                  + "; ".join(f"{c[0]} {c[1]} ({'held' if c[3] else 'missed'}"
                              f", {c[2]})" for c in pchecks), flush=True)
            if not all(c[3] for c in pchecks):
                fail("closure probe: " + "; ".join(
                    f"{c[0]} {c[1]} ({c[2]})" for c in pchecks if not c[3]))
            swapped = probe_reference(probes[0], poses, swap=True)
            e = probes[0].events[0]
            if all(abs(e[k] - swapped[k]) <= bands[0] * 1e3
                   for k in ("sim3_trans_err_mm", "drift_trans_mm")):
                fail("closure probe: the probe with q and l exchanged "
                     "passes the bands")
        elif name == "own":
            acc = [(e["q"], e["l"]) for e in ev if e["accepted"]]
            basins = own_basins(ref)
            if not acc:
                fail("loop circuit own decisions: no accepted closure")
            near = [b for b in basins
                    if all(abs(q - b[0]) <= 2 and abs(l - b[1]) <= 2
                           for q, l in acc)]
            print(f"loop circuit own decisions [{card}]: closures {acc} "
                  f"near the JAX closure(s) {near} of {basins}; ATE "
                  f"{ate * 1e3:.3f} mm against the JAX loop-off ATE "
                  f"{off_ate * 1e3:.3f} mm", flush=True)
            if not near:
                fail(f"loop circuit own decisions: closures {acc} farther "
                     f"than 2 keyframes from every closure the JAX package "
                     f"accepts on this circuit {basins}")
            if not ate < off_ate:
                fail(f"loop circuit own decisions: ATE {ate} not below the "
                     f"JAX loop-off ATE {off_ate}")
            if not all(r.tracked for r in sys_.trajectory):
                fail("loop circuit own decisions: a frame was lost")
            accepted_ms = [e["wall_ms"] for e in ev if e["accepted"]]
    on = times["own"][WARMUP:LOOP_OFF_FRAMES]
    print(f"loop circuit [{card}]: frames {WARMUP}-{LOOP_OFF_FRAMES - 1}, "
          f"ms/frame median loop on (own) {np.median(on):.3f} against loop "
          f"off {ms['loop_off'][0]:.3f} "
          f"({(np.median(on) / ms['loop_off'][0] - 1) * 100:+.1f}%); mean "
          f"{np.mean(on):.3f} against {ms['loop_off'][1]:.3f}; all 120 "
          f"frames, loop on: median {ms['own'][0]:.3f} mean "
          f"{ms['own'][1]:.3f}", flush=True)
    return out, accepted_ms, (poses, frames)


def phase_loop_controls(card, poses, frames):
    """The replayed circuit with the closure's correction dropped
    (run_loop_circuit's control): its event stays equal, so it must fail
    one of circuit_bands's bands, or those bands could not tell a lost
    correction from a working one. (A wrong correction, T12 inverted, is
    planted in the loop pass: phase_loop_faults.)"""
    from object_slam_tpu_torch.config import SlamConfig
    ref = np.load(LOOP_CIRCUIT_REF)
    cfg = SlamConfig.tum_rgbd()
    bands = circuit_bands(ref)
    for control in ("correction_dropped",):
        sys_, inserts, ate, _ = run_loop_circuit(
            cfg, poses, frames, ref, card, control=control)
        checks = circuit_checks(ref, bands, sys_, inserts, ate)
        failed = [f"{c[0]} {c[1]} (limit {c[2]})" for c in checks
                  if not c[3]]
        print(f"loop circuit control {control} [{card}]: events "
              f"{loop_events(sys_.loop_closer.events)}; fails "
              f"{'; '.join(failed) or 'nothing'}", flush=True)
        if not any(c[4] and not c[3] for c in checks):
            fail(f"loop circuit control {control}: a closure with this "
                 f"fault passes every band")


def phase_kidnap_loop(card):
    """The 49-frame kidnap of phase_kidnap with loop closing on, so that
    every LOST frame relocalizes through the BoW candidates (one
    relocalize_try each), the JAX run's PnP draws replayed
    (kidnap_loop_tum_vga.npz): the same LOST, staged and relocalized
    frames, the same candidate keyframe accepted, keyframes equal, and
    every record within PNP_BAND_M of the reference's. Returns the
    launches and the cost of one BoW relocalization."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem

    ref = np.load(KIDNAP_LOOP_REF)
    cfg = SlamConfig.tum_rgbd()
    frames = kidnap_frames(cfg, ref)
    if not np.allclose([float(np.sum(f[0], dtype=np.float64))
                        for f in frames], ref["gray_sum"], rtol=1e-9,
                       atol=0):
        fail("kidnap loop: the rendered frames differ from the reference "
             "run's")
    sys_ = SlamSystem(cfg, enable_objects=True, enable_loop=True,
                      device="cuda")
    blobs = [to_blob(sys_.builder, cfg, d, rgb, sa)
             for _, d, rgb, sa in frames]
    pnp = [torch.from_numpy(s).cuda() for s in ref["pnp_sets"]]
    sim3s = [torch.from_numpy(s).cuda() for s in ref["sim3_sets"]]
    seen = {"staged": [], "reloc": [], "tries": []}
    staged_fn, reloc_fn = sys_._track_staged, sys_._relocalize
    try_fn = trk.relocalize_try

    def minimal_sets(valid, n_trials=256, k=6):
        if not pnp:
            fail("kidnap loop: more PnP draws than the reference's "
                 f"{len(ref['pnp_sets'])}")
        return pnp.pop(0)

    def track_staged(frame):
        seen["staged"].append(sys_.frame_id)
        return staged_fn(frame)

    def relocalize(frame):
        tr = reloc_fn(frame)
        seen["reloc"].append((round(float(frame.timestamp) * 30),
                              tr is not None))
        return tr

    def reloc_try(K, m, frame, kf, fn, s):
        tr = try_fn(K, m, frame, kf, fn, s)
        seen["tries"].append((round(float(frame.timestamp) * 30), kf,
                              int(tr.n_inliers)))
        return tr
    sys_._minimal_sets = minimal_sets
    sys_.loop_closer._minimal_sets = lambda valid, n_trials=256: sim3s.pop(0)
    sys_._track_staged, sys_._relocalize = track_staged, relocalize
    trk.relocalize_try = reloc_try
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        for i, (blob, iv) in enumerate(blobs):
            sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
        sys_.flush_mapping()
    finally:
        trk.relocalize_try = try_fn
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts("kidnap loop", len(blobs))
    recs = sys_.trajectory
    ref_tries = [tuple(x) for x in ref["reloc_tries"].tolist()]
    acc = [(f, kf) for f, kf, n in seen["tries"] if n >= 50]
    ref_acc = [(f, kf) for f, kf, n in ref_tries if n >= 50]
    d_rec = max(float(np.linalg.norm(r.Tcw[:3, 3] - b[:3, 3]))
                for r, b in zip(recs, ref["rec_tcw"]))
    print(f"kidnap loop [{card}]: {len(blobs)} frames in {secs:.1f} s; "
          f"LOST {[i for i, r in enumerate(recs) if not r.tracked]} "
          f"(reference {np.where(~ref['tracked'])[0].tolist()}); staged "
          f"{seen['staged']}; relocalizations {seen['reloc']}; BoW attempts "
          f"(frame, candidate, inliers) {seen['tries']} (reference "
          f"{ref_tries}); farthest record {d_rec * 1e3:.3f} mm; launches "
          f"{launches}", flush=True)
    if [r.tracked for r in recs] != ref["tracked"].tolist():
        fail("kidnap loop: tracked flags differ from the reference's")
    if seen["staged"] != ref["staged_frames"].tolist():
        fail(f"kidnap loop: staged frames {seen['staged']}")
    if [f for f, _ in seen["reloc"]] != ref["reloc_frames"].tolist() or \
            [ok for _, ok in seen["reloc"]] != ref["reloc_ok"].tolist():
        fail(f"kidnap loop: relocalizations {seen['reloc']}")
    if acc != ref_acc:
        fail(f"kidnap loop: accepted candidates {acc}, reference {ref_acc}")
    m = sys_.map
    kf_frames = m.kf_frame_id[m.kf_valid].cpu().numpy().tolist()
    if kf_frames != ref["kf_frames"].tolist():
        fail(f"kidnap loop: KFs at {kf_frames}")
    if d_rec > PNP_BAND_M:
        fail(f"kidnap loop: a record {d_rec} m from the reference's")
    # one BoW relocalization of the first recovered frame's view against
    # the final map (host clock; it ends in a device read)
    first = ref_acc[0][0] if ref_acc else None
    reloc_ms = None
    if first is not None:
        frame = sys_.builder.build_rgbd_blob(*blobs[first], 0.0)
        sys_._minimal_sets = lambda valid, n_trials=256, k=6: \
            SlamSystem._minimal_sets(sys_, valid, n_trials, k)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sys_._relocalize_bow(frame)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        reloc_ms = float(np.median(ts))
        print(f"kidnap loop [{card}]: one BoW relocalization of frame "
              f"{first} against the final map: {reloc_ms:.3f} ms (median "
              f"of 5, host clock)", flush=True)
    return launches, reloc_ms


def phase_loop_faults(card):
    """The closure stage by stage with a fault planted: the pose graph
    skipped, the GBA skipped, T12 inverted. Each must fail a check of
    phase_loop_pass."""
    for fault in ("no_pose_graph", "no_gba", "inverted_t12"):
        bad, _, _ = phase_loop_pass(card, fault=fault)
        if not bad:
            fail(f"loop pass: the planted fault {fault} passes every check")
        print(f"loop pass fault {fault} [{card}]: fails {len(bad)} checks, "
              f"first: {bad[0]}", flush=True)


# ---------------------------------------------------------------------------
# mono at EuRoC width, localization mode, checkpoints, the EuRoC driver
# ---------------------------------------------------------------------------

MONO_REF = os.path.join(FIXTURES, "mono_euroc.npz")
LOC_REF = os.path.join(FIXTURES, "localization_tum_vga.npz")
EUROC_DRIVER_REF = os.path.join(FIXTURES, "euroc_driver.npz")
MONO_FRAMES = 40
MONO_STEP = 0.03
MONO_WARMUP = 8
# records of the replayed mono drive: within 1e-3 of the unit baseline and
# 0.1 deg of the JAX run's, or within MONO_NOISE_MARGIN times the spread of
# the JAX run's own one-ulp noise runs
MONO_REC = 1e-3
MONO_REC_DEG = 0.1
MONO_NOISE_MARGIN = 2.0
MONO_KF_SHIFT = 2
# the initializer on the JAX run's matched pair with its winning sets:
# rotation, translation direction, or MONO_NOISE_MARGIN times the spread of
# the JAX noise runs' initializations (one-ulp noise in the matched pixels)
MONO_INIT_DEG = 0.05
MONO_INIT_COS = 0.9999
# localization mode: LOC_VGA[0] frames map, LOC_VGA[1] frames in the mode
# (a pan of LOC_VGA_YAW rad per frame away for LOC_VGA_OUT frames, then
# back), LOC_VGA[2] frames after it (make_reference.py's loc_vga_poses)
LOC_VGA = (30, 14, 8)
LOC_VGA_YAW = 0.09
LOC_VGA_OUT = 8
CKPT_FRAMES = 20
CKPT_AT = 12
EUROC_DRIVER_FRAMES = 10
EUROC_DRIVER_STEP = 0.03


def euroc_cfg(sensor: str):
    """scripts/run_euroc_torch.py's configuration for this script's
    settings YAML (whose camera block is SlamConfig.euroc_stereo()'s)."""
    from object_slam_tpu_torch.config import SlamConfig
    return SlamConfig.euroc_stereo().replace(sensor=sensor)


def centers(recs):
    """Camera centers [N, 3] of world-to-camera poses [N, 4, 4]."""
    return np.stack([np.linalg.inv(T.astype(np.float64))[:3, 3]
                     for T in recs])


def aligned_dist(est, ref):
    """Per-record distances of the camera centers est [N, 3] from ref after
    the least-squares similarity (Umeyama) of est onto ref: a monocular
    map is defined up to one, and the initializer fixes it."""
    me, mr = est.mean(0), ref.mean(0)
    e, g = est - me, ref - mr
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max(np.mean(np.sum(e * e, 1)), 1e-30)
    return np.linalg.norm(s * e @ R.T + mr - ref, axis=1)


def sim3_ate(est, gt):
    """RMSE after the least-squares similarity alignment (Umeyama) of est
    onto gt, [N, 3] each: the ATE of a trajectory whose scale is free."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    me, mg = est.mean(0), gt.mean(0)
    e, g = est - me, gt - mg
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max(np.mean(np.sum(e * e, 1)), 1e-30)
    aligned = s * e @ R.T + mg
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, 1))))


def init_bands(ref):
    """The limits on the initializer's rotation (deg) and translation
    direction (1 - cosine): MONO_INIT_DEG / MONO_INIT_COS, or
    MONO_NOISE_MARGIN times the farthest of the JAX noise runs'
    initializations from the pinned run's, whichever is wider."""
    deg, one_m_cos, k = 0.0, 0.0, 0
    T = ref["pinned.init.T21"].astype(np.float64)
    while f"noise{k}.init.T21" in ref.files:
        Tn = ref[f"noise{k}.init.T21"].astype(np.float64)
        deg = max(deg, rot_deg(Tn[:3, :3], T[:3, :3]))
        c = Tn[:3, 3] @ T[:3, 3] / (np.linalg.norm(Tn[:3, 3])
                                     * np.linalg.norm(T[:3, 3]))
        one_m_cos = max(one_m_cos, 1.0 - float(c))
        k += 1
    return (max(MONO_INIT_DEG, MONO_NOISE_MARGIN * deg),
            max(1.0 - MONO_INIT_COS, MONO_NOISE_MARGIN * one_m_cos),
            deg, one_m_cos)


def winner_sets(ref, attempt: int):
    """The JAX run's draws of an initializer attempt reduced to the trials
    its argmaxes picked (one F set, one H set). The top F scores of a
    rendered pair are near ties (4355.9 against 4349.0 on this drive's),
    and the f32 eigh of an 8-point set differs between LAPACK builds and
    cuSOLVER by up to 1e-3 of F, which reorders them: handed all 200 sets,
    the port on the CPU picks another trial than JAX."""
    bF = int(ref["attempt_bestF"][attempt])
    bH = int(ref["attempt_bestH"][attempt])
    return (ref["sets8"][attempt][bF:bF + 1],
            ref["sets4"][attempt][bH:bH + 1])


def init_checks(init, ref, K, bands, base="pinned."):
    """The initializer's outcome against the JAX run ``base`` (the pinned
    run, handed the winning sets as the card is; "" for the main run): ok,
    the rotation and the translation direction within init_bands, and the
    good set differing in no more points than MONO_NOISE_MARGIN times the
    most a JAX noise run's differs from the pinned run's (a T21 inside the
    band moves points across the two-view gates: the reprojection chi2
    against thF, the parallax cosine against 0.9998). Returns (failures,
    summary)."""
    bad = []
    T21 = init.T21.cpu().numpy().astype(np.float64)
    T21j = ref[base + "init.T21"].astype(np.float64)
    ok = bool(init.ok)
    if ok != bool(ref["init.ok"]):
        bad.append(f"ok {ok}, reference {bool(ref['init.ok'])}")
    deg = rot_deg(T21[:3, :3], T21j[:3, :3])
    cos = float(T21[:3, 3] @ T21j[:3, 3] / (np.linalg.norm(T21[:3, 3])
                                             * np.linalg.norm(T21j[:3, 3])))
    if not deg <= bands[0]:
        bad.append(f"rotation {deg:.5f} deg from the reference's "
                   f"(limit {bands[0]:.5f})")
    if not 1.0 - cos <= bands[1]:
        bad.append(f"translation direction cosine {cos:.7f} (limit "
                   f"{1.0 - bands[1]:.7f})")
    good = ref[base + "init.good"]
    flip = init.good.cpu().numpy() != good
    noisy, k = 0, 0
    while f"noise{k}.init.good" in ref.files:
        noisy = max(noisy, int(np.sum(ref[f"noise{k}.init.good"]
                                      != ref["pinned.init.good"])))
        k += 1
    if int(flip.sum()) > MONO_NOISE_MARGIN * noisy:
        bad.append(f"good set differs at {int(flip.sum())} points (limit "
                   f"{MONO_NOISE_MARGIN} x {noisy})")
    summary = (f"ok {ok}, rotation {deg:.5f} deg, direction cosine "
               f"{cos:.8f}, good {int(init.good.sum())} (reference "
               f"{int(good.sum())}), {int(flip.sum())} flips: "
               f"{np.flatnonzero(flip).tolist()[:20]}")
    return bad, summary


def phase_mono_init(card):
    """The two-view initializer on the card on the JAX mono run's matched
    pair at EuRoC width (its uv1, uv2, valid) with the JAX run's winning
    index sets (winner_sets), held by init_checks; with all 200 + 200 JAX
    sets, the same ok (the winner it picks printed); its wall ms on the
    200 + 200 sets (host clock, synchronized, median of 10); then two
    planted faults, each of which must fail: the rotation transposed, and
    the H/F model selection dropped (the homography's candidates
    forced)."""
    import torch
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.solvers.initializer import (
        initialize_mono_sets)
    ref = np.load(MONO_REF)
    cfg = euroc_cfg("mono")
    K = Intrinsics.from_config(cfg.camera)
    pair = [torch.from_numpy(ref[k]).cuda() for k in
            ("init.uv1", "init.uv2", "init.valid")]
    win = [torch.from_numpy(x).cuda()
           for x in winner_sets(ref, len(ref["attempt_ok"]) - 1)]
    full = [torch.from_numpy(ref[k]).cuda() for k in ("init.idxF",
                                                      "init.idxH")]

    def run(sets, **kw):
        return initialize_mono_sets(sets[0], sets[1], K, *pair,
                                    min_inliers=cfg.tracking.min_init_inliers,
                                    **kw)
    bands = init_bands(ref)
    init = run(win)
    bad, summary = init_checks(init, ref, K, bands)
    all_sets = run(full)
    _, all_summary = init_checks(all_sets, ref, K, bands, base="")
    if bool(all_sets.ok) != bool(ref["init.ok"]):
        bad.append(f"with all the JAX sets: ok {bool(all_sets.ok)}")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bool(run(full).ok)
        times.append((time.perf_counter() - t0) * 1e3)
    init_ms = float(np.median(times))
    print(f"mono initializer [{card}]: the JAX winners: {summary}; limits "
          f"{bands[0]:.5f} deg, cosine {1 - bands[1]:.8f} (the JAX noise "
          f"runs: {bands[2]:.5f} deg, cosine {1 - bands[3]:.8f}); all 200 + "
          f"200 JAX sets: {all_summary}; one initialization {init_ms:.3f} "
          f"ms (all sets; median of 10, host clock; "
          f"{ref['init.uv1'].shape[0]} matches)", flush=True)
    if bad:
        fail("mono initializer: " + "; ".join(bad))
    flipped = init._replace(T21=init.T21.clone())
    flipped.T21[:3, :3] = init.T21[:3, :3].T
    for fault, res in (("rotation transposed", flipped),
                       ("H/F selection dropped",
                        run(win, h_ratio_reject=-1.0))):
        fbad, fsum = init_checks(res, ref, K, bands)
        print(f"mono initializer fault {fault} [{card}]: fails "
              f"{len(fbad)} checks: {fbad[:2]}", flush=True)
        if not fbad:
            fail(f"mono initializer: the planted fault {fault} passes")
    return init_ms


def mono_bands(ref):
    """The pinned JAX run's own spread: the largest record distance (the
    camera centers after the Sim(3) alignment, aligned_dist; rotation) and
    the ATE change of its one-ulp noise runs
    that kept its tracked flags, and the keyframe frames of the pinned run
    and of each of those runs. One ulp in the initializer's matched pixels
    moves its T21 by up to 0.04 deg and a direction cosine of 0.9966, and
    with it the drive's keyframe decisions: all three noise runs keyframe
    on frames 6 / 21 / 22 / 34 where the pinned run does on 22 / 23 / 34 /
    35."""
    dt, dr, da, kept = 0.0, 0.0, 0.0, 0
    kf_sets = [ref["pinned.kf_frames"].tolist()]
    k = 0
    while f"noise{k}.rec_tcw" in ref.files:
        if np.array_equal(ref[f"noise{k}.tracked"], ref["pinned.tracked"]):
            kept += 1
            kf_sets.append(ref[f"noise{k}.kf_frames"].tolist())
            r, p = ref[f"noise{k}.rec_tcw"], ref["pinned.rec_tcw"]
            ok = ref["pinned.tracked"]
            dt = max(dt, float(aligned_dist(centers(r[ok]),
                                            centers(p[ok])).max()))
            dr = max(dr, max(rot_deg(a[:3, :3], b[:3, :3])
                             for a, b in zip(r, p)))
            da = max(da, abs(float(ref[f"noise{k}.ate_sim3"])
                             - float(ref["pinned.ate_sim3"])))
        k += 1
    if kept < 2:
        fail(f"mono: only {kept} JAX noise runs kept the reference's flags")
    return dt, dr, da, kept, kf_sets


def sampler_runs(ref):
    """(initialization frame, frames tracked, Sim(3) ATE) of the JAX runs
    with their own draws: the main run (PRNGKey(0)) and the runs from
    PRNGKey(1), (2), ...: the outcome of a mono initialization depends on
    the draws, and the port's own sampler is one more draw."""
    runs = [(int(ref["init_frame"]), int(ref["tracked"].sum()),
             float(ref["ate_sim3"]))]
    k = 1
    while f"seed{k}.ate_sim3" in ref.files:
        runs.append((int(ref[f"seed{k}.init_frame"]),
                     int(ref[f"seed{k}.tracked"].sum()),
                     float(ref[f"seed{k}.ate_sim3"])))
        k += 1
    return runs


def kf_near(kf_frames, kf_sets):
    """True if some JAX run has as many keyframes and each of them within
    MONO_KF_SHIFT frames of the one of the same rank: one ulp in the
    initializer's pixels moves the drive's keyframe decisions by a frame
    or two (mono_bands), so the JAX runs sample the decisions, they do not
    bound them."""
    return any(len(s) == len(kf_frames) and max(
        abs(a - b) for a, b in zip(kf_frames, s)) <= MONO_KF_SHIFT
        for s in kf_sets)


def mono_frames(cfg):
    from object_slam_tpu_torch.datasets.synthetic import (orbit_poses,
                                                          render_room)
    poses = orbit_poses(MONO_FRAMES, step=MONO_STEP)
    out, secs = render_room(cfg, poses)
    return poses, [f[0] for f in out], secs


def run_mono(cfg, poses, grays, ref, replay: bool, card):
    """SlamSystem(cfg, enable_objects=False).track_mono over the frames on
    the card (the default fused pipelined path), with the JAX run's RANSAC
    draws replayed or its own; a synchronized host-clock time per frame.
    Returns (system, draws, ms per frame, launches)."""
    import torch
    from object_slam_tpu_torch.slam.system import SlamSystem
    name = "mono replay" if replay else "mono own sampler"
    sys_ = SlamSystem(cfg, enable_objects=False, device="cuda")
    drawn = []
    if replay:
        # each initializer attempt gets the JAX run's winning sets
        wins = [winner_sets(ref, a) for a in range(len(ref["attempt_ok"]))]
        queues = {8: [torch.from_numpy(w[0]).cuda() for w in wins],
                  4: [torch.from_numpy(w[1]).cuda() for w in wins],
                  6: [torch.from_numpy(x).cuda() for x in ref["sets6"]]}

        def minimal_sets(valid, n_trials=256, k=6):
            drawn.append(k)
            if not queues[k]:
                fail(f"{name}: more size-{k} RANSAC draws than the "
                     f"reference's")
            return queues[k].pop(0)
        sys_._minimal_sets = minimal_sets
    times = []
    torch.cuda.synchronize()
    zero_counts()
    for i, g in enumerate(grays):
        t0 = time.perf_counter()
        sys_.track_mono(g, timestamp=i / cfg.camera.fps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    sys_.flush_mapping()
    launches = read_counts(name, len(grays))
    return sys_, drawn, times, launches


def phase_mono_drive(card):
    """The mono drive at EuRoC width (752x480, 1200 features, n_kp 1280,
    49,152 points, 768 keyframes, objects off): MONO_FRAMES frames of
    bench.py's room at the EuRoC camera along orbit_poses(step=MONO_STEP),
    track_mono of the f32 gray image. Replayed (each initializer attempt
    handed the JAX run's winning sets, winner_sets; held to the JAX run
    handed the same, mono_euroc.npz "pinned"): the same draws,
    initialization frame and tracked flags, keyframes near those of the
    pinned run or of one of its noise runs (kf_near), records (the
    tracked camera centers after the Sim(3) alignment; rotations)
    within MONO_REC / MONO_REC_DEG or MONO_NOISE_MARGIN times the spread
    of the JAX noise runs (pinned, with one-ulp noise in the initializer's
    matched pixels and in every mapping pass's input), the Sim(3) ATE
    within that margin of their ATE spread too. Own sampler: held to the
    JAX runs with their own draws (sampler_runs): initialized within 1
    frame of one of them, at least as many frames tracked as the fewest, a
    Sim(3) ATE within 2x the largest. One orb_describe per frame."""
    cfg = euroc_cfg("mono")
    ref = np.load(MONO_REF)
    poses, grays, secs = mono_frames(cfg)
    sums = [float(np.sum(g, dtype=np.float64)) for g in grays]
    if not np.allclose(sums, ref["gray_sum"], rtol=1e-12, atol=0):
        fail("mono: the rendered frames differ from the reference run's")
    print(f"rendered {len(grays)} EuRoC frames (752x480) in {secs:.1f} s",
          flush=True)
    bt, br, ba, kept, kf_sets = mono_bands(ref)
    band_t = max(MONO_REC, MONO_NOISE_MARGIN * bt)
    band_r = max(MONO_REC_DEG, MONO_NOISE_MARGIN * br)
    band_a = max(MONO_REC, MONO_NOISE_MARGIN * ba)
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    out, ms = {}, {}
    for replay in (True, False):
        name = "mono replay" if replay else "mono own sampler"
        sys_, drawn, times, launches = run_mono(cfg, poses, grays, ref,
                                                replay, card)
        recs = sys_.trajectory
        tracked = np.asarray([r.tracked for r in recs])
        init_frame = int(np.argmax(tracked)) if tracked.any() else -1
        m = sys_.map
        kf_frames = m.kf_frame_id[m.kf_valid].cpu().numpy().tolist()
        fin = np.stack([t[1] for t in sys_.final_trajectory()])
        est = np.stack([np.linalg.inv(T)[:3, 3] for T in fin])
        ate = sim3_ate(est[tracked], gt[tracked]) if tracked.sum() > 2 \
            else float("nan")
        steady = np.asarray(times[MONO_WARMUP:])
        ms[name] = (float(np.median(steady)), float(np.mean(steady)))
        # the replay is held to the pinned JAX run, the own sampler to the
        # main one
        b = "pinned." if replay else ""
        msg = (f"{name} [{card}]: initialized at frame {init_frame} "
               f"(reference {int(ref[b + 'init_frame'])}), "
               f"{int(tracked.sum())}/{len(tracked)} tracked (reference "
               f"{int(ref[b + 'tracked'].sum())}), KFs at {kf_frames} "
               f"(reference {ref[b + 'kf_frames'].tolist()}), "
               f"{sys_.n_points} points (reference "
               f"{int(ref[b + 'n_points'])}), Sim(3) ATE {ate:.6f} "
               f"(reference {float(ref[b + 'ate_sim3']):.6f}); "
               f"{ms[name][0]:.3f} / "
               f"{ms[name][1]:.3f} ms/frame median / mean after "
               f"{MONO_WARMUP} frames; launches {launches}")
        if replay:
            ok = ref["pinned.tracked"]
            d_t = aligned_dist(centers([r.Tcw for r in recs])[ok],
                               centers(ref["pinned.rec_tcw"][ok])).tolist()
            d_r = [rot_deg(r.Tcw[:3, :3], q[:3, :3])
                   for r, q in zip(recs, ref["pinned.rec_tcw"])]
            msg += (f"; records max {max(d_t):.6f} (band {band_t:.6f}), "
                    f"{max(d_r):.5f} deg (band {band_r:.5f}); the {kept} "
                    f"JAX noise runs spread {bt:.6f} / {br:.5f} deg / ATE "
                    f"{ba:.6f}; per-record distance "
                    f"{json.dumps([round(d, 6) for d in d_t])}")
        print(msg, flush=True)
        if replay:
            if drawn != ref["sets_k"].tolist():
                fail(f"{name}: RANSAC draws of sizes {drawn}, reference "
                     f"{ref['sets_k'].tolist()}")
            if init_frame != int(ref["pinned.init_frame"]):
                fail(f"{name}: initialized at frame {init_frame}")
            if tracked.tolist() != ref["pinned.tracked"].tolist():
                fail(f"{name}: tracked flags {tracked.tolist()}")
            if not kf_near(kf_frames, kf_sets):
                fail(f"{name}: KFs at {kf_frames}, not within "
                     f"{MONO_KF_SHIFT} frames of any of the JAX runs' "
                     f"{kf_sets}")
            if not (max(d_t) <= band_t and max(d_r) <= band_r):
                fail(f"{name}: records {max(d_t)} / {max(d_r)} deg outside "
                     f"{band_t} / {band_r} deg")
            if not abs(ate - float(ref["pinned.ate_sim3"])) <= band_a:
                fail(f"{name}: Sim(3) ATE {ate} not within {band_a} of the "
                     f"reference's")
        else:
            runs = sampler_runs(ref)
            print(f"{name}: the JAX runs from PRNGKey 0-{len(runs) - 1}: "
                  f"initialized at {[r[0] for r in runs]}, tracked "
                  f"{[r[1] for r in runs]}, Sim(3) ATE "
                  f"{[round(r[2], 6) for r in runs]}", flush=True)
            if min(abs(init_frame - r[0]) for r in runs) > 1:
                fail(f"{name}: initialized at frame {init_frame}")
            if tracked.sum() < min(r[1] for r in runs):
                fail(f"{name}: {int(tracked.sum())} frames tracked")
            if not ate <= 2.0 * max(r[2] for r in runs):
                fail(f"{name}: Sim(3) ATE {ate} > 2x the JAX runs' largest")
        out["replay" if replay else "own"] = launches
    return out, ms


def loc_poses():
    """make_reference.py's loc_vga_poses."""
    n_map, n_loc, n_after = LOC_VGA
    poses = []
    for i in range(n_map + n_loc + n_after):
        j = max(0, i - n_map + 1)
        off = LOC_VGA_YAW * max(0, min(j, LOC_VGA_OUT)
                                - max(0, j - LOC_VGA_OUT))
        yaw = 0.01 * i + off
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-(i * 0.01), 0.02 * np.sin(i * 0.3), 0.0]
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(T)
    return poses


def run_localization(cfg, frames, card, fault=None, n=None):
    """bench.py's protocol (blobs, pipelined, objects on) over the frames,
    localization mode from frame LOC_VGA[0] to LOC_VGA[0] + LOC_VGA[1];
    records each VO motion call's map-match count and the map's counts at
    each switch. fault: "keyframes_on" (the mode's gate left open: the
    activation only resolves the readback) or "no_temporal" (the VO call
    sees no depth in the last frame: no temporal points)."""
    import torch
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem
    sys_ = SlamSystem(cfg, enable_objects=True, device="cuda")
    vo, counts = [], {}
    orig = trk.track_motion_model_vo

    def vo_rec(K, m, frame, last, *a, **kw):
        if fault == "no_temporal":
            last = last._replace(depth=torch.full_like(last.depth, -1.0))
        tr, n_map = orig(K, m, frame, last, *a, **kw)
        vo.append((sys_.frame_id, int(n_map), int(tr.n_inliers)))
        return tr, n_map
    if fault == "keyframes_on":
        sys_.activate_localization_mode = sys_._resolve_fused_pending
    on, off = LOC_VGA[0], LOC_VGA[0] + LOC_VGA[1]
    frames = frames[:n]
    trk.track_motion_model_vo = vo_rec
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        for i, (_, d16, rgb8, sa) in enumerate(frames):
            if i == on:
                sys_.activate_localization_mode()
                counts["on"] = (sys_.n_keyframes, sys_.n_points)
            if i == off:
                counts["off"] = (sys_.n_keyframes, sys_.n_points)
                sys_.deactivate_localization_mode()
            blob, iv = sys_.builder.pack_frame_blob(d16, rgb8, sa)
            sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
        sys_.flush_mapping()
    finally:
        trk.track_motion_model_vo = orig
    secs = time.perf_counter() - t0
    name = f"localization{' fault ' + fault if fault else ''}"
    launches = read_counts(name, len(frames))
    return sys_, vo, counts, secs, launches


def loc_checks(sys_, vo, counts, ref):
    """The run against the JAX one over its frames: tracked flags, the VO
    calls and their vo_mode frames (< 10 map matches), each VO call's
    inliers (map and temporal points) within 10% of the JAX call's, the
    counts at the switches and none added while the mode is on, records
    within 2 mm / 0.1 deg. Returns the failures."""
    bad = []
    recs = sys_.trajectory
    n = len(recs)
    tracked = [r.tracked for r in recs]
    if tracked != ref["tracked"][:n].tolist():
        bad.append(f"tracked flags {tracked}")
    sel = ref["vo_frames"] < n
    vo_ref = list(zip(ref["vo_frames"][sel].tolist(),
                      ref["vo_n_map"][sel].tolist(),
                      ref["vo_n_inliers"][sel].tolist()))
    mode = [v[0] for v in vo if v[1] < 10]
    mode_ref = [v[0] for v in vo_ref if v[1] < 10]
    if [v[0] for v in vo] != [v[0] for v in vo_ref] or mode != mode_ref:
        bad.append(f"VO calls at {[v[0] for v in vo]}, vo_mode {mode} "
                   f"(reference {mode_ref})")
    else:
        off = [(v[0], v[2], w[2]) for v, w in zip(vo, vo_ref)
               if abs(v[2] - w[2]) > 0.1 * w[2]]
        if off:
            bad.append(f"VO inliers (frame, here, reference) {off[:4]}")
    for k in ("on", "off"):
        if k in counts and counts[k] != (int(ref[f"n_kf_{k}"]),
                                         int(ref[f"n_points_{k}"])):
            bad.append(f"(keyframes, points) at the switch {k} "
                       f"{counts[k]}")
    if "off" in counts and counts["off"] != counts.get("on"):
        bad.append(f"the map grew in localization mode: {counts}")
    d_t = [float(np.linalg.norm(r.Tcw[:3, 3] - b[:3, 3]))
           for r, b in zip(recs, ref["rec_tcw"])]
    d_r = [rot_deg(r.Tcw[:3, :3], b[:3, :3])
           for r, b in zip(recs, ref["rec_tcw"])]
    if not (max(d_t) < 2e-3 and max(d_r) < 0.1):
        bad.append(f"records {max(d_t) * 1e3:.4f} mm / {max(d_r):.5f} deg")
    return bad, max(d_t), max(d_r), mode


def phase_localization(card):
    """Localization mode at TUM VGA, objects on (SlamConfig.tum_rgbd(),
    bench.py's protocol): LOC_VGA[0] frames map, then the mode is on while
    the camera pans past the mapped region and back (temporal VO points
    carry the frames with few map matches), then mapping resumes. Held to
    the JAX CPU run (localization_tum_vga.npz) by loc_checks and, over the
    whole run, hold_to_reference (keyframes after deactivation, census,
    constraints, ATE). Then the two planted faults over the frames up to
    deactivation, each of which must fail loc_checks."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import render_room_blobs
    cfg = SlamConfig.tum_rgbd()
    ref = dict(np.load(LOC_REF))
    poses = loc_poses()
    frames, secs = render_room_blobs(cfg, poses)
    if not np.allclose([f[0] for f in frames], ref["gray_sum"], rtol=1e-12,
                       atol=0):
        fail("localization: the rendered frames differ from the reference's")
    sys_, vo, counts, run_s, launches = run_localization(cfg, frames, card)
    bad, dt, dr, mode = loc_checks(sys_, vo, counts, ref)
    inl = [(v[2], w) for v, w in zip(vo, ref["vo_n_inliers"].tolist())]
    print(f"localization [{card}]: {len(frames)} frames ({secs:.1f} s to "
          f"render) in {run_s:.1f} s; mode on at {LOC_VGA[0]}, off at "
          f"{sum(LOC_VGA[:2])}; (keyframes, points) at the switches "
          f"{counts}; VO calls {len(vo)}, vo_mode frames {mode}, inliers "
          f"(here, reference) {inl}; records "
          f"{dt * 1e3:.4f} mm / {dr:.5f} deg; launches {launches}",
          flush=True)
    if bad:
        fail("localization: " + "; ".join(bad))
    fin = np.stack([np.linalg.inv(T)[:3, 3] for T in ref["final_tcw"]])
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    from object_slam_tpu_torch.eval.ate import ate_rmse
    ref["ate"] = ate_rmse(fin[ref["tracked"]], gt[ref["tracked"]])
    hold_to_reference("localization", sys_, ref, poses)
    for fault in ("keyframes_on", "no_temporal"):
        fs, fvo, fc, _, _ = run_localization(cfg, frames, card, fault=fault,
                                             n=sum(LOC_VGA[:2]) + 1)
        fbad = loc_checks(fs, fvo, fc, ref)[0]
        print(f"localization fault {fault} [{card}]: fails {len(fbad)} "
              f"checks: {fbad[:3]}", flush=True)
        if not fbad:
            fail(f"localization: the planted fault {fault} passes")
    return launches


def phase_checkpoint(card, frames, sems):
    """A mid-run round trip at TUM VGA, objects on (bench.py's protocol,
    the first CKPT_FRAMES frames): shutdown(path) at frame CKPT_AT, then
    load_into_system(path) into the same system, then on; against a run
    that only calls flush_mapping there. Both runs with torch's
    deterministic algorithms (the card's atomics otherwise sum in a new
    order each run). Records and map must be bit-identical; the file, read
    back with numpy, must hold every map field as the map held it at the
    save, in the reference's layout (uint32 descriptors)."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.slam import checkpoint
    from object_slam_tpu_torch.slam.map_state import MapState
    from object_slam_tpu_torch.slam.system import SlamSystem
    cfg = SlamConfig.tum_rgbd()
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "ckpt_smoke", "mid.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    held = {}

    def run(round_trip: bool):
        sys_ = SlamSystem(cfg, enable_objects=True, device="cuda")
        blobs = [to_blob(sys_.builder, cfg, d, rgb, sems[i])
                 for i, (_, d, rgb) in enumerate(frames[:CKPT_FRAMES])]
        zero_counts()
        for i, (blob, iv) in enumerate(blobs):
            if i == CKPT_AT:
                if round_trip:
                    t0 = time.perf_counter()
                    sys_.shutdown(path)
                    held["save_ms"] = (time.perf_counter() - t0) * 1e3
                    held["map"] = interop.map_state_to_numpy(sys_.map)
                    t0 = time.perf_counter()
                    held["meta"] = checkpoint.load_into_system(path, sys_)
                    held["load_ms"] = (time.perf_counter() - t0) * 1e3
                else:
                    sys_.flush_mapping()
            sys_.track_rgbd_blob(blob, iv, timestamp=i / 30.0)
        sys_.flush_mapping()
        return sys_, read_counts("checkpoint", len(blobs))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, launches = run(True)
        b, _ = run(False)
    finally:
        torch.use_deterministic_algorithms(False)
    bad = []
    for i, (ra, rb) in enumerate(zip(a.trajectory, b.trajectory)):
        if not (ra.tracked == rb.tracked and ra.ref_kf == rb.ref_kf
                and np.array_equal(ra.Tcw, rb.Tcw)
                and np.array_equal(ra.Tcr, rb.Tcr)):
            bad.append(f"record {i}")
    if len(a.trajectory) != len(b.trajectory):
        bad.append("trajectory lengths")
    ma, mb = interop.map_state_to_numpy(a.map), interop.map_state_to_numpy(
        b.map)
    bad += [f"map field {f}" for f in MapState._fields
            if not np.array_equal(ma[f], mb[f])]
    if a.objects.semantic_constraints != b.objects.semantic_constraints:
        bad.append("semantic constraints")
    d = np.load(path)
    file_bad = [f for f in MapState._fields
                if d[f].dtype != held["map"][f].dtype
                or not np.array_equal(d[f], held["map"][f])]
    meta = json.loads(bytes(d["_oslam_meta"]).decode())
    if (meta.get("version") != 1 or meta.get("fields") != list(
            MapState._fields) or d["pt_desc"].dtype != np.uint32
            or meta.get("n_trajectory") != CKPT_AT):
        file_bad.append(f"meta {dict((k, meta[k]) for k in meta if k != 'fields')}")
    print(f"checkpoint [{card}]: round trip at frame {CKPT_AT} of "
          f"{CKPT_FRAMES}: {len(bad)} differences from the flush-only run "
          f"{bad[:5]}; file {os.path.getsize(path) / 2 ** 20:.2f} MiB, "
          f"{len(MapState._fields)} fields, {len(file_bad)} differ from the "
          f"map {file_bad[:5]}; save (with the flush) "
          f"{held['save_ms']:.1f} ms, load {held['load_ms']:.1f} ms; "
          f"{a.n_keyframes} KFs, {a.n_points} points; launches {launches}",
          flush=True)
    if bad or file_bad:
        fail(f"checkpoint: round trip {bad[:5]}, file {file_bad[:5]}")
    return launches


def phase_euroc_driver(card):
    """scripts/run_euroc_torch.py, in this process, on a EUROC_DRIVER_
    FRAMES-frame mav0 directory written under build/ (bench.py's room at
    the EuRoC camera, u8 stereo pairs, orbit_poses(step=EUROC_DRIVER_STEP),
    the ground-truth csv, a settings YAML with zero distortion and identity
    R), stereo then --mono, each decoding through the driver's native
    prefetcher, the counts set to 0 before and read after each (one
    orb_describe per stereo pair and per mono frame); then the
    directory decoded by the prefetcher at the driver's settings, held to
    the port's PNG reader array by array. The stereo run's trajectory is
    held to the JAX package's CPU run of the same
    decoded frames (euroc_driver.npz): flags, keyframe count, poses within
    2 mm / 0.1 deg. Both: the output file and the JSON summary."""
    import contextlib
    import io
    import runpy
    import shutil
    from object_slam_tpu_torch.datasets import euroc
    from object_slam_tpu_torch.datasets.synthetic import (orbit_poses,
                                                          render_room_stereo)
    ref = np.load(EUROC_DRIVER_REF)
    cfg = euroc_cfg("stereo")
    poses = orbit_poses(EUROC_DRIVER_FRAMES, step=EUROC_DRIVER_STEP)
    frames, secs = render_room_stereo(cfg, poses)
    if not np.allclose([float(np.sum(gl, dtype=np.float64))
                        for gl, _ in frames], ref["gray_sum"], rtol=1e-12,
                       atol=0):
        fail("EuRoC driver: the rendered frames differ from the reference's")
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, "build", "euroc_smoke")
    shutil.rmtree(base, ignore_errors=True)
    mav = os.path.join(base, "mav0")
    stamps = euroc.write_sequence(mav, poses, frames)
    settings = os.path.join(base, "settings.yaml")
    euroc.write_settings(settings, cfg.camera)
    if stamps != ref["stamps"].tolist():
        fail("EuRoC driver: timestamps differ from the reference's")
    out = {}
    for mono in (False, True):
        name = "EuRoC driver --mono" if mono else "EuRoC driver"
        res_dir = os.path.join(base, "out_mono" if mono else "out")
        argv = sys.argv
        sys.argv = ["run_euroc_torch.py", "--mav", mav, "--calib", settings,
                    "--out", res_dir] + (["--mono"] if mono else [])
        buf = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(root, "scripts",
                                            "run_euroc_torch.py"),
                               run_name="__main__")
        finally:
            sys.argv = argv
        run_s = time.perf_counter() - t0
        launches = read_counts(name, len(frames))
        lines = buf.getvalue().strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, ValueError):
            fail(f"{name}: no JSON summary in {lines[-3:]}")
        rows = [r.split() for r in open(os.path.join(
            res_dir, "CameraTrajectory.txt")).read().splitlines()
            if r and not r.startswith("#")]
        msg = (f"{name} [{card}]: {len(frames)} frames ({secs:.1f} s to "
               f"render) ran in {run_s:.1f} s; summary {json.dumps(res)}; "
               f"{len(rows)} trajectory rows; launches {launches}")
        if set(res) != {"frames", "fps", "keyframes", "points"} or \
                res["frames"] != len(frames) or not res["keyframes"] >= 1:
            fail(f"{name}: summary {res}")
        if not rows or any(len(r) != 8 for r in rows):
            fail(f"{name}: CameraTrajectory.txt rows {rows[:2]}")
        if not mono:
            n_ok = int(ref["tracked"].sum())
            twc = ref["final_tcw"][ref["tracked"]]
            d_t, d_r = [], []
            for r, Tcw in zip(rows, twc):
                v = np.array([float(x) for x in r])
                Twc = np.linalg.inv(Tcw.astype(np.float64))
                d_t.append(float(np.linalg.norm(v[1:4] - Twc[:3, 3])))
                x, y, z, w = v[4:8]
                R = np.array([
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]])
                d_r.append(rot_deg(R, Twc[:3, :3]))
            msg += (f"; against the JAX run: {len(rows)}/{n_ok} tracked "
                    f"rows, keyframes {res['keyframes']} (reference "
                    f"{int(ref['n_keyframes'])}), poses max "
                    f"{max(d_t) * 1e3:.4f} mm, {max(d_r):.5f} deg")
            print(msg, flush=True)
            if len(rows) != n_ok or res["keyframes"] != int(
                    ref["n_keyframes"]):
                fail(f"{name}: {len(rows)} tracked rows, "
                     f"{res['keyframes']} keyframes")
            if not (max(d_t) < 2e-3 and max(d_r) < 0.1):
                fail(f"{name}: poses {max(d_t)} m / {max(d_r)} deg from the "
                     f"reference's")
        else:
            print(msg, flush=True)
        out["euroc_driver_mono" if mono else "euroc_driver_stereo"] = \
            launches
    hold_prefetch_decode("EuRoC driver", [
        (p, None) for fr in euroc.load_sequence_mav(mav)
        for p in (fr.left_path, fr.right_path)], card, capacity=6)
    return out


# ---------------------------------------------------------------------------
# multi-process GBA, batched tracking, the prefetching drivers, the entry
# ---------------------------------------------------------------------------

# the sharded GBA against the single-process one: the CPU test's tolerance
# (tests/test_torch_parallel.py), beside the loop pass's GBA band
SHARD_POSE_TOL, SHARD_POINT_TOL = 1e-4, 1e-3
SHARD_TIMEOUT_S = 300
# batched tracking: B sequences of bench.py's room, each warmed through
# track_rgbd, then BATCH_STEPS steps
BATCH_B = 4
BATCH_OFFSETS = (0, 2, 4, 6)
BATCH_WARM = 8
BATCH_STEPS = 4
# the port's tracking tests' tolerance on poses
TRACK_ATOL, TRACK_RTOL = 1e-5, 1e-4


def gba_input():
    """The loop pass's GBA input (loop_pass_tum_vga.npz: the map after the
    JAX pose graph, at full caps) as the closer builds it, the JAX GBA's
    output map, and its one-ulp keyframe spread."""
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.loop.loop_closing import LoopCloser
    from object_slam_tpu_torch.slam.map_state import init_map
    fx = np.load(LOOP_PASS_REF)
    cfg = SlamConfig.tum_rgbd()
    K = Intrinsics.from_config(cfg.camera)
    lc = LoopCloser(cfg, K, device="cuda")
    base = interop.map_state_to_numpy(init_map(
        cfg.caps, cfg.objects.history_capacity,
        n_bow_words=lc.vocab.n_words, device="cpu"))
    states = interop.stage_maps(fx, base, ("bow", "propagate", "fuse",
                                           "pose_graph", "gba"))
    m = interop.map_state_from_numpy(states["pose_graph"], device="cuda")
    return (K, lc.ba_problem(m), m.kf_kp_pt.shape[1],
            cfg.solver.global_ba_iters, states["gba"],
            np.asarray(fx["gba_ulp_kf_move"]))


def phase_sharded_ba(card):
    """The loop pass's GBA (512 keyframes x 1024 slots = 524,288
    observation slots) in one process; run_sharded_global_ba over NCCL at
    the card count (one rank: in this process, bit-identical to the
    single-process run; more: spawned ranks, one card each); over 2 gloo
    ranks spawned on cuda:0 (NCCL refuses two ranks on one card), held to
    the loop pass's GBA band (LOOP_NOISE_MARGIN times the JAX GBA's
    one-ulp spread) and to the single-process result within the CPU
    test's tolerance; then the same with rank 1 keeping its own
    per-point partial sums (tests/torch_fixtures/faults.py), which must
    fail. Prints ms per GBA of each run (the gloo all-reduce of CUDA
    tensors goes through the host)."""
    import torch
    import torch.distributed as dist
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.parallel import distributed, sharded_ba
    from object_slam_tpu_torch.solvers.ba import global_ba
    sys.path.insert(0, FIXTURES)
    import faults

    K, prob, block_n, iters, gba_ref, ulp = gba_input()
    kv = gba_ref["kf_valid"]
    limit = LOOP_NOISE_MARGIN * float(np.max(ulp))

    def kf_move(kf_pose):
        return float(np.max(np.linalg.norm(
            kf_pose[kv][:, :3, 3] - gba_ref["kf_pose"][kv][:, :3, 3],
            axis=1)))

    def timed_gba(fn, reps=2):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kf, pt = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return kf.cpu().numpy(), pt.cpu().numpy(), ms

    bad, readings = [], {}
    kf0, pt0, ms0 = timed_gba(lambda: global_ba(K, prob, iters,
                                                block_n=block_n))
    readings["single_kf_move"] = kf_move(kf0)
    if readings["single_kf_move"] > limit:
        bad.append(f"single-process GBA {readings['single_kf_move']} m "
                   f"from the JAX GBA's (limit {limit})")
    arrays = interop.ba_problem_to_numpy(prob)
    world = torch.cuda.device_count()
    if world == 1:
        store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "nccl_store")
        if os.path.exists(store):
            os.remove(store)
        distributed.maybe_initialize_distributed(
            "file://" + store, 1, 0, device="cuda",
            timeout_s=SHARD_TIMEOUT_S)
        try:
            if dist.get_backend() != "nccl":
                fail(f"sharded BA: backend {dist.get_backend()}, not nccl")
            kf1, pt1, ms1 = timed_gba(lambda: sharded_ba.run_sharded_global_ba(
                K, prob, iters, block_n=block_n))
        finally:
            dist.destroy_process_group()
        if not (np.array_equal(kf1, kf0) and np.array_equal(pt1, pt0)):
            bad.append("NCCL world size 1 is not bit-identical to the "
                       "single-process GBA")
        readings["nccl_bit_identical"] = bool(
            np.array_equal(kf1, kf0) and np.array_equal(pt1, pt0))
    else:
        outs = sharded_ba.spawn_sharded_global_ba(
            K, arrays, world, block_n=block_n, n_iters=iters, device="cuda",
            reps=2, timeout_s=SHARD_TIMEOUT_S)
        kf1, pt1, ms1 = outs[0]["kf_pose"], outs[0]["pt_xyz"], \
            outs[0]["ms"].tolist()
        readings["nccl_kf_move"] = kf_move(kf1)
        if readings["nccl_kf_move"] > limit:
            bad.append(f"NCCL x{world}: {readings['nccl_kf_move']} m")

    def gloo_checks(outs, tag):
        out = []
        for r, o in enumerate(outs[1:], 1):
            if not (np.array_equal(o["kf_pose"], outs[0]["kf_pose"])
                    and np.array_equal(o["pt_xyz"], outs[0]["pt_xyz"])):
                out.append(f"{tag}: rank {r} differs from rank 0")
        kf, pt = outs[0]["kf_pose"], outs[0]["pt_xyz"]
        move = kf_move(kf)
        e_kf = float(np.abs(kf - kf0).max())
        e_pt = float(np.abs(pt - pt0).max())
        readings[tag] = {"kf_move": move, "pose_vs_single": e_kf,
                         "point_vs_single": e_pt}
        if move > limit:
            out.append(f"{tag}: keyframes {move} m from the JAX GBA's "
                       f"(limit {limit})")
        if e_kf > SHARD_POSE_TOL or e_pt > SHARD_POINT_TOL:
            out.append(f"{tag}: {e_kf} / {e_pt} from the single-process "
                       f"GBA (limits {SHARD_POSE_TOL} / {SHARD_POINT_TOL})")
        return out

    outs = sharded_ba.spawn_sharded_global_ba(
        K, arrays, 2, block_n=block_n, n_iters=iters, device="cuda:0",
        backend="gloo", reps=2, timeout_s=SHARD_TIMEOUT_S)
    bad += gloo_checks(outs, "gloo x2")
    ms2 = outs[0]["ms"].tolist()
    readings["gloo x2 live observations per rank"] = [int(o["live"])
                                                      for o in outs]
    if min(readings["gloo x2 live observations per rank"]) == 0:
        bad.append("gloo x2: a rank holds no live observation")
    try:
        fouts = sharded_ba.spawn_sharded_global_ba(
            K, arrays, 2, block_n=block_n, n_iters=iters, device="cuda:0",
            backend="gloo", timeout_s=SHARD_TIMEOUT_S,
            setup=faults.skip_point_reduce)
        caught = gloo_checks(fouts, "fault: rank 1 without the point "
                                    "all-reduce")
    except Exception as e:                  # a rank raised: caught too
        caught = [f"the faulted run raised {type(e).__name__}: {e}"]
    print(f"sharded GBA [{card}]: {int(kv.sum())} keyframes, "
          f"{int(arrays['obs_valid'].sum())} live of {arrays['obs_kf'].size}"
          f" observation slots; ms per GBA (warm-up, timed): one process "
          f"{json.dumps([round(x, 3) for x in ms0])}, NCCL x{world} "
          f"{json.dumps([round(x, 3) for x in ms1])}, gloo x2 on one card "
          f"(its all-reduce through the host) "
          f"{json.dumps([round(x, 3) for x in ms2])}; readings "
          f"{json.dumps(readings)}; GBA limit {limit * 1e3:.4f} mm; the "
          f"planted fault failed {caught}", flush=True)
    if bad:
        fail("sharded GBA: " + "; ".join(bad))
    if not caught:
        fail("sharded GBA: a rank without the point all-reduce passed")
    return {"single_ms": ms0[-1], "nccl_ms": ms1[-1], "gloo2_ms": ms2[-1]}


def phase_batched(card, frames):
    """BatchedTracker at full width (SlamConfig.tum_rgbd(): 640x480, n_kp
    1024, 32,768 points, 512 keyframes per element), B = BATCH_B: each
    sequence is bench.py's room from its own offset of the orbit
    (BATCH_OFFSETS), warmed through SlamSystem.track_rgbd (strict, objects
    off) for BATCH_WARM frames; then BATCH_STEPS steps on frames built by
    FrameBuilder.build_rgbd, the counts set to 0 before and read after
    (B orb_describe per step). Each element is held to the port's
    single-sequence track_motion_model -> track_local_map on the same
    inputs (kp_pt and n_inliers exact, Tcw within TRACK_ATOL /
    TRACK_RTOL); then one step with two elements' maps swapped, which must
    fail. Returns the launches and ms per step at B = 1 and B."""
    import torch
    from object_slam_tpu_torch.geometry import se3
    from object_slam_tpu_torch.parallel.batched_tracking import (
        BatchedTracker, stack_pytrees)
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.frame import FrameBuilder
    from object_slam_tpu_torch.slam.system import SlamSystem

    cfg = tum_cfg()
    need = max(BATCH_OFFSETS) + BATCH_WARM + BATCH_STEPS
    if len(frames) < need:
        fail(f"batched: {len(frames)} frames rendered, {need} needed")
    systems = []
    for off in BATCH_OFFSETS:
        s = SlamSystem(cfg, enable_objects=False, device="cuda")
        for i in range(off, off + BATCH_WARM):
            gray, depth, rgb = frames[i]
            s.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        if not all(r.tracked for r in s.trajectory):
            fail(f"batched: the sequence from frame {off} lost tracking "
                 f"while warming")
        systems.append(s)
    s0 = systems[0]
    builder = FrameBuilder(cfg, device="cuda")
    bt = BatchedTracker(s0.K, s0.scale_factors, s0.inv_sigma2, s0.log_scale)
    lasts = [s.last_frame for s in systems]
    vels = [s.velocity for s in systems]
    # each element's own map, carried by its own single-sequence calls
    ref_maps = [s.map for s in systems]
    maps = stack_pytrees(ref_maps)

    def reference(m, frame, last, T_pred):
        tr = trk.track_motion_model(
            s0.K, m, frame, last.uv, last.kp_pt, last.level, last.valid,
            T_pred, s0.scale_factors, s0.inv_sigma2, radius_th=15.0)
        res, m2, _ = trk.track_local_map(s0.K, m, frame, tr,
                                         s0.scale_factors, s0.inv_sigma2,
                                         s0.log_scale)
        return res, m2

    def held(res, b, ref):
        return (torch.equal(res.kp_pt[b], ref.kp_pt)
                and int(res.n_inliers[b]) == int(ref.n_inliers)
                and torch.allclose(res.Tcw[b], ref.Tcw, atol=TRACK_ATOL,
                                   rtol=TRACK_RTOL))

    def pick(x, b):
        """Element b of the batch, keeping its axis (B = 1)."""
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[None if v is None else pick(v, b) for v in x])
        return x[b:b + 1]

    bad, ms_b, ms_1, inliers, caught = [], [], [], [], []
    zero_counts()
    for step in range(BATCH_STEPS):
        fr = []
        for off in BATCH_OFFSETS:
            i = off + BATCH_WARM + step
            gray, depth, rgb = frames[i]
            fr.append(builder.build_rgbd(gray, depth, rgb, None, i / 30.0))
        T_pred = [v @ l.Tcw for v, l in zip(vels, lasts)]
        a = (stack_pytrees(fr), torch.stack([l.uv for l in lasts]),
             torch.stack([l.kp_pt for l in lasts]),
             torch.stack([l.level for l in lasts]),
             torch.stack([l.valid for l in lasts]), torch.stack(T_pred))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, maps2 = bt.step(maps, *a)
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t0) * 1e3)
        for b in range(BATCH_B):        # each element alone, B = 1
            one = [pick(x, b) for x in (maps,) + a]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.step(*one)
            torch.cuda.synchronize()
            ms_1.append((time.perf_counter() - t0) * 1e3)
        refs = [reference(ref_maps[b], fr[b], lasts[b], T_pred[b])
                for b in range(BATCH_B)]
        for b, (ref, m2) in enumerate(refs):
            if not (held(res, b, ref)
                    and torch.equal(maps2.pt_visible[b], m2.pt_visible)
                    and torch.equal(maps2.pt_found[b], m2.pt_found)):
                bad.append(f"step {step}, element {b}: kp_pt equal "
                           f"{torch.equal(res.kp_pt[b], ref.kp_pt)}, "
                           f"inliers {int(res.n_inliers[b])} against "
                           f"{int(ref.n_inliers)}")
        inliers.append(res.n_inliers.tolist())
        if step == 0:
            order = torch.tensor([1, 0] + list(range(2, BATCH_B)),
                                 device="cuda")
            fres, _ = bt.step(type(maps)(*[v[order] for v in maps]), *a)
            caught = [b for b in range(BATCH_B)
                      if not held(fres, b, refs[b][0])]
        for b in range(BATCH_B):
            vels[b] = res.Tcw[b] @ se3.inverse(lasts[b].Tcw)
            lasts[b] = fr[b]._replace(Tcw=res.Tcw[b], kp_pt=res.kp_pt[b])
            ref_maps[b] = refs[b][1]
        maps = maps2
    # the single-element steps and the planted fault launch no kernel: the
    # frames are built once per step
    launches = read_counts("batched", BATCH_STEPS, per_frame=BATCH_B)
    print(f"batched tracking [{card}]: B={BATCH_B} sequences from frames "
          f"{list(BATCH_OFFSETS)} warmed {BATCH_WARM} frames, {BATCH_STEPS} "
          f"steps; inliers {inliers}; ms per step (tracking, frames built) "
          f"B={BATCH_B} {json.dumps([round(x, 3) for x in ms_b])}, B=1 "
          f"(each element alone, step by step) "
          f"{json.dumps([round(x, 3) for x in ms_1])}; B={BATCH_B} against "
          f"the sum of its elements' B=1 steps {sum(ms_b) / sum(ms_1):.3f}; "
          f"maps swapped failed "
          f"elements {caught}; launches {launches}", flush=True)
    if bad:
        fail("batched: " + "; ".join(bad))
    if not caught:
        fail("batched: swapped maps passed the check")
    if min(min(x) for x in inliers) < 30:
        fail(f"batched: inliers {inliers}")
    return launches, {"B1_ms": float(np.median(ms_1)),
                      f"B{BATCH_B}_ms": float(np.median(ms_b))}


def phase_graft(card):
    """graft_entry.entry() on the card (the motion-model tracking step) and
    dryrun_multichip(torch.cuda.device_count()): one sharded GBA step over
    spawned NCCL ranks."""
    import torch
    from object_slam_tpu_torch import graft_entry
    fn, args = graft_entry.entry("cuda")
    if args[0].pt_xyz.device.type != "cuda":
        fail("graft entry: its inputs are not on the card")
    Tcw, n_inl = fn(*args)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(Tcw).all()) and int(n_inl) > 100):
        fail(f"graft entry: Tcw finite {bool(torch.isfinite(Tcw).all())}, "
             f"{int(n_inl)} inliers")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n, device="cuda", timeout_s=SHARD_TIMEOUT_S)
    print(f"graft entry [{card}]: entry ok {tuple(Tcw.shape)} {int(n_inl)} "
          f"inliers; dryrun_multichip({n}) ok in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def euroc_describe_row():
    """orb_describe against its plain version at the EuRoC shapes (the
    first mono drive frame, 752x480, 1280 keypoints over 8 levels)."""
    from object_slam_tpu_torch.datasets.synthetic import (bench_room,
                                                          orbit_poses)
    cfg = euroc_cfg("mono")
    gray = bench_room(cfg).render_rgbd(orbit_poses(1)[0])[0]
    ex, levels, corners = main_path_inputs(cfg, gray.astype(np.float32))
    row = phase_describe(ex, levels, corners, tag="EuRoC")
    return {k: row[k] for k in ("max_abs_err", "ms", "device_ms",
                                "plain_ms", "bound_ms", "bound_by")}


def mono_phases(by_phase, card, frames, sems):
    """Mono at EuRoC width (the initializer stage, the drive replayed and
    with its own sampler), localization mode and the checkpoint round trip
    at TUM VGA, the EuRoC driver in both modes. Returns the mono drive's
    ms per frame and one initialization's ms."""
    init_ms = phase_timed("mono_init", phase_mono_init, card)
    mono, mono_ms = phase_timed("mono_drive", phase_mono_drive, card)
    by_phase["mono_replay"] = mono["replay"]
    by_phase["mono_own_sampler"] = mono["own"]
    by_phase["localization"] = phase_timed("localization",
                                           phase_localization, card)
    by_phase["checkpoint"] = phase_timed("checkpoint", phase_checkpoint,
                                         card, frames, sems)
    by_phase.update(phase_timed("euroc_driver", phase_euroc_driver, card))
    print(f"mono [{card}]: ms/frame median / mean after {MONO_WARMUP} "
          f"frames, replayed {mono_ms['mono replay'][0]:.3f} / "
          f"{mono_ms['mono replay'][1]:.3f}, own sampler "
          f"{mono_ms['mono own sampler'][0]:.3f} / "
          f"{mono_ms['mono own sampler'][1]:.3f}; one initialization "
          f"{init_ms:.3f} ms", flush=True)
    return mono_ms, init_ms


# ---------------------------------------------------------------------------
# the offline tools (a third process): the dataset generators, the
# experiment battery, the vocabulary trainer, the BRIEF-pattern learner
# ---------------------------------------------------------------------------

EXP_REF = os.path.join(FIXTURES, "experiments.npz")
VOCAB_REF = os.path.join(FIXTURES, "vocab_train.npz")
BRIEF_REF = os.path.join(FIXTURES, "brief.npz")
SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
# the generators' directories and the battery's depth (make_reference.py
# experiments ran the reference's functions on the same)
SYNTH_TUM_FRAMES = 40
SYNTH_KITTI_FRAMES = 24
EXP_DEPTH = 24
# the battery's KITTI scratch prewarm (its system is thrown away: the
# results do not depend on it; the reference's takes 12 frames)
EXP_KITTI_PREWARM = 2
# the BRIEF selection held row for row on an integer corpus of this size
# (brief_cases.integer_corpus; the reference's main() on the same)
BRIEF_CARD_CORPUS = 8000
# a row where the card's selection parts from the reference's must sit on
# a float tie: some test's |correlation| within this of the threshold
BRIEF_TIE = 1e-5
BRIEF_QUALITY_TOL = 1e-3
# the BRIEF harvest's renders (6 scenes x 8 poses hold fewer than its
# 50,000 patches): one orb_describe and one extract_patches_levels each
BRIEF_RENDERS = 48
# the vocabulary harvest's rows that may part from the reference's: the
# card's harvest parts in 18 of its 67,246 (the port's CPU harvest, whose
# pyramid sums as XLA:CPU does, in 4: keypoints on a rotation-bin boundary
# or the angle's stability gate; the card's pyramid takes the matrix
# products, whose last-ulp differences move a few FAST responses across a
# quarter step), plus a margin of 6 for such keypoints that another card's
# arithmetic may tip
# the card's vocabulary harvest takes the reference's pyramid order
# (features/pyramid.py, order="xla"), so it parts from the reference's
# only where the CPU port's does: in at most the CPU port's 4 rows
# (vocab_train.npz cpu_port.diff_rows, keypoints on a bin boundary or the
# angle's stability gate), and only in those rows
VOCAB_DESC_DIFF = 4
VOCAB_LEVELS_RENDER = (1, 0)       # scene seed, loop_trajectory(8) pose
TOOLS_ARG = "--tools-phases"


def tools_root():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "tools_smoke")


def script_module(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import importlib
    return importlib.import_module(name)


def counts_now():
    return {k: fn.launches for k, fn in counters().items()}


def file_digests(root):
    """make_reference.py's synth_digests with the port's PNG reader: {path
    under root: sha256 of a PNG's decoded array (dtype, shape, bytes) or
    of another file's bytes}."""
    import hashlib
    from object_slam_tpu_torch.datasets.png import read_png
    out = {}
    for sub in ("tum", "kitti"):
        for dirpath, _, files in os.walk(os.path.join(root, sub)):
            for f in files:
                path = os.path.join(dirpath, f)
                if f.endswith(".png"):
                    a = read_png(path)
                    data = f"{a.dtype.str}{a.shape}".encode() + a.tobytes()
                else:
                    data = open(path, "rb").read()
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    data).hexdigest()
    return out


def phase_synth_dirs(card):
    """scripts/make_synth_tum_torch.py (SYNTH_TUM_FRAMES frames) and
    make_synth_kitti_torch.py (SYNTH_KITTI_FRAMES) under build/, each file
    held to the reference scripts' (experiments.npz "synth_digests"):
    text byte for byte, every PNG's decoded array bit for bit."""
    import shutil
    root = tools_root()
    shutil.rmtree(root, ignore_errors=True)
    secs = {}
    for script, sub, n in (("make_synth_tum_torch", "tum", SYNTH_TUM_FRAMES),
                           ("make_synth_kitti_torch", "kitti",
                            SYNTH_KITTI_FRAMES)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(
            SCRIPTS, script + ".py"), "--out", os.path.join(root, sub),
            "--frames", str(n)], capture_output=True, text=True, timeout=600)
        secs[sub] = round(time.perf_counter() - t0, 1)
        if out.returncode != 0:
            fail(f"{script}.py exited {out.returncode}: {out.stderr[-2000:]}")
    want = json.loads(str(np.load(EXP_REF)["synth_digests"]))
    got = file_digests(root)
    missing = sorted(set(want) ^ set(got))
    bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    n_png = sum(k.endswith(".png") for k in want)
    print(f"synth dirs [{card}]: {SYNTH_TUM_FRAMES} TUM frames in "
          f"{secs['tum']} s, {SYNTH_KITTI_FRAMES} KITTI pairs in "
          f"{secs['kitti']} s; {len(got)} files ({n_png} PNGs) against the "
          f"reference scripts': {len(missing)} missing or extra, "
          f"{len(bad)} differ {bad[:5]}", flush=True)
    if missing or bad:
        fail(f"synth dirs: {len(missing)} files missing or extra "
             f"{missing[:5]}, {len(bad)} differ {bad[:5]}")
    return root


def phase_experiments(root, card):
    """scripts/run_experiments_torch.py's functions on the generated
    directories, EXP_DEPTH frames per variant: every TUM variant of its
    list, then run_kitti inline and async, each held to the reference's
    run of its functions on the same directories (experiments.npz). TUM
    sync variants: tracked flags and keyframe frames equal, objects and
    semantic constraints within 10%, ATE within ATE_BAND_M of the
    reference's; t200_async (the mapping thread merges when it is
    ready): flags, objects, constraints, ATE < 0.05 m, its keyframes
    printed; KITTI: as phase_kitti holds a drive on its own decisions
    (flags, objects, constraints, the async keyframes against the
    witness, ATE < KITTI_OWN_ATE_M), the ATE beside the reference's and
    the noise-ensemble band printed. One orb_describe per TUM frame and
    per KITTI pair (prewarm included). Prints the t200_a / t200_b
    spread."""
    from object_slam_tpu_torch.config import SlamConfig
    rex = script_module("run_experiments_torch")
    ref = np.load(EXP_REF)
    cfg = SlamConfig.tum_rgbd()
    tum_dir, kitti_dir = (os.path.join(root, s) for s in ("tum", "kitti"))
    t0 = time.perf_counter()
    metas, frames = rex.load_tum_frames(tum_dir, cfg, EXP_DEPTH)
    load_s = time.perf_counter() - t0
    # a short prewarm (the allocator's caches; no result depends on it)
    rex.run_tum_variant(tum_dir, cfg, frames[:4], metas[:4], device="cuda",
                        enable_objects=True)
    bad, lines, launches, recs = [], [], {}, {}

    def check(name, what, got, want, ok):
        lines.append(f"{what} {got} (reference {want})"
                     + ("" if ok else " FAILED"))
        if not ok:
            bad.append(f"{name}: {what}")

    def held(name, res, sys_, strict):
        want = json.loads(str(ref[f"{name}.json"]))
        tracked = [r.tracked for r in sys_.trajectory]
        kv = sys_.map.kf_valid.cpu().numpy()
        kfs = sys_.map.kf_frame_id.cpu().numpy()[kv].tolist()
        lines.append(f"{name}:")
        check(name, "tracked", sum(tracked), want["tracked"],
              tracked == ref[f"{name}.tracked"].tolist())
        kf_ok = kfs == ref[f"{name}.kf_frames"].tolist()
        check(name, "keyframes", kfs, ref[f"{name}.kf_frames"].tolist(),
              kf_ok or not strict)
        for k in ("objects", "semantic_constraints"):
            if k in want:
                check(name, k, res[k], want[k],
                      abs(res[k] - want[k]) <= 0.1 * want[k])
        return want, tracked, kfs

    for name, vcfg, kw in rex.tum_variants(cfg):
        zero_counts()
        systems = []
        res = rex.run_tum_variant(tum_dir, vcfg, frames, metas,
                                  device="cuda", systems=systems, **kw)
        launches[name] = read_counts(f"experiments {name}", len(frames))
        sys_ = systems[-1]
        strict = not kw.get("async_mapping", False)
        want, _, _ = held(name, res, sys_, strict)
        ate, ate_j = res["ate_rmse"], want["ate_rmse"]
        if strict:
            check(name, "ATE mm", round(ate * 1e3, 5),
                  f"{ate_j * 1e3:.5f} +- {ATE_BAND_M * 1e3}",
                  abs(ate - ate_j) <= ATE_BAND_M)
        else:
            check(name, "ATE mm", round(ate * 1e3, 5),
                  f"{ate_j * 1e3:.5f}; limit 50", ate < 0.05)
        if "loops_closed" in want:
            check(name, "loops closed / rejected",
                  (res["loops_closed"], res["loops_rejected"]),
                  (want["loops_closed"], want["loops_rejected"]),
                  (res["loops_closed"], res["loops_rejected"])
                  == (want["loops_closed"], want["loops_rejected"]))
        lines.append(f"median {res['median_track_ms']:.3f} ms/frame, "
                     f"{res['fps']:.3f} frames/s")
        recs[name] = np.stack([r.Tcw for r in sys_.trajectory])
    spread = float(np.max(np.linalg.norm(
        recs["t200_a"][:, :3, 3] - recs["t200_b"][:, :3, 3], axis=1)))
    kref = np.load(KITTI_REF)
    for name, amap in (("kitti", False), ("kitti_async", True)):
        zero_counts()
        systems = []
        res = rex.run_kitti(kitti_dir, EXP_DEPTH, async_mapping=amap,
                            device="cuda", prewarm=EXP_KITTI_PREWARM,
                            systems=systems)
        launches[name] = read_counts(f"experiments {name}",
                                     EXP_DEPTH + EXP_KITTI_PREWARM)
        want, _, kfs = held(name, res, systems[-1], strict=False)
        mode = "async" if amap else "sync"
        witness = KITTI_WITNESS_KFS[mode]
        if witness is not None:
            check(name, "keyframes against the witness", kfs, list(witness),
                  kfs == list(witness))
        ate_band = kitti_bands(kref, mode)[1]
        check(name, "ATE mm", round(res["ate_rmse"] * 1e3, 4),
              f"{want['ate_rmse'] * 1e3:.4f}, noise band "
              f"{ate_band * 1e3:.4f}; limit {KITTI_OWN_ATE_M * 1e3}",
              res["ate_rmse"] < KITTI_OWN_ATE_M)
        lines.append(f"median {res['median_track_ms']:.3f} ms/frame, "
                     f"{res['fps']:.3f} frames/s")
    print(f"experiments [{card}]: {len(frames)} TUM frames (decoded in "
          f"{load_s:.1f} s), {EXP_DEPTH} KITTI pairs; t200_a / t200_b "
          f"records at most {spread * 1e3:.6f} mm apart; "
          + "; ".join(lines), flush=True)
    if bad:
        fail("experiments: " + "; ".join(bad))
    return launches


def hold_harvest_levels(card):
    """One vocabulary-harvest render's 8 pyramid levels (VOCAB_LEVELS_RENDER)
    in the reference's order on the card (pyramid.build_pyramid(...,
    order="xla"), what the harvests take) bit-equal to the CPU port's
    levels of the same render and to the reference's recorded sha256
    (xla_resize_check.npz); the tracking paths' matrix products printed
    beside them."""
    import hashlib
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    from object_slam_tpu_torch.features import pyramid as pyr
    seed, pose = VOCAB_LEVELS_RENDER
    cfg = SlamConfig.tum_rgbd()
    scene = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                                plane_z=3.2 + 0.3 * seed)
    gray = np.asarray(scene.render_rgbd(loop_trajectory(8)[pose])[0],
                      np.float32)
    img = torch.from_numpy(gray)
    card_lv = [x.cpu() for x in pyr.build_pyramid(img.cuda(), 8, 1.2,
                                                  order="xla")]
    prod_lv = [x.cpu() for x in pyr.build_pyramid(img.cuda(), 8, 1.2)]
    cpu_lv = pyr.build_pyramid(img, 8, 1.2)
    want = np.load(os.path.join(FIXTURES, "xla_resize_check.npz"))[
        f"{seed}_{pose}.level_sha256"].tolist()
    sha = [hashlib.sha256(np.ascontiguousarray(x.numpy()).tobytes())
           .hexdigest() for x in card_lv]
    equal = [torch.equal(a, b) for a, b in zip(card_lv, cpu_lv)]
    prod = [int((a != b).sum()) for a, b in zip(prod_lv, cpu_lv)]
    print(f"train_vocab [{card}]: render (scene {seed}, pose {pose}): the "
          f"card's levels in the reference's order equal the CPU port's "
          f"{equal}, the reference's sha256 {[a == b for a, b in zip(sha, want)]}"
          f"; the matrix products' levels differ from them in {prod} "
          f"pixels", flush=True)
    if not all(equal) or sha != want:
        fail("train_vocab: the card's harvest pyramid is not the CPU port's "
             "(the reference's) bit for bit")


def phase_train_vocab(card):
    """scripts/train_vocab_torch.py at full size: first hold_harvest_levels;
    then its harvest on the card (10 scenes x 8 poses of loop_trajectory,
    one orb_describe per render, the reference's pyramid order) against
    the reference's CPU harvest (vocab_train.npz): at most VOCAB_DESC_DIFF
    rows may differ, each one where the CPU port's harvest parts from the
    reference's (cpu_port.diff_rows: 4 of 67,246 rows, keypoints on a bin
    boundary or the angle's stability gate). Then the host training on the
    reference's descriptors, byte for byte the reference's file (its
    sha256); and on the card's own, its file's sha256 printed beside it
    (byte-equal only when no row differs, and then held)."""
    import hashlib
    hold_harvest_levels(card)
    tv = script_module("train_vocab_torch")
    ref = np.load(VOCAB_REF)
    zero_counts()
    t0 = time.perf_counter()
    descs = tv.harvest(device="cuda", log=lambda *a: None)
    harvest_s = time.perf_counter() - t0
    launches = counts_now()
    want_launches = {"extract_patches": 0, "orb_describe": 80}
    if launches != want_launches:
        fail(f"train_vocab: kernel launches {launches}, expected "
             f"{want_launches}")
    want = ref["full.desc"]
    if descs.shape != want.shape:
        fail(f"train_vocab: {descs.shape[0]} descriptors, the reference "
             f"{want.shape[0]}")
    diff_rows = np.flatnonzero(np.any(descs != want, axis=1))
    n_diff = int(diff_rows.size)
    cpu_rows = ref["cpu_port.diff_rows"]
    # keypoints of equal response come out of the top-k in either order:
    # the rows of the card's harvest missing from the reference's multiset
    from collections import Counter
    n_set = sum((Counter(map(bytes, descs))
                 - Counter(map(bytes, want))).values())
    os.makedirs(tools_root(), exist_ok=True)

    def trained(d, name):
        t0 = time.perf_counter()
        voc = tv.train(d)
        path = os.path.join(tools_root(), name)
        voc.save_dbow2_text(path)
        return (hashlib.sha256(open(path, "rb").read()).hexdigest(),
                time.perf_counter() - t0, voc.n_words)
    sha_ref_descs, _, _ = trained(want, "vocab_reference_descs.txt")
    sha, train_s, n_words = trained(descs, "vocab_synth.txt")
    want_sha = str(ref["full.sha256"])
    print(f"train_vocab [{card}]: {descs.shape[0]} descriptors harvested "
          f"in {harvest_s:.1f} s, {n_diff} rows differ from the reference "
          f"harvest's ({diff_rows.tolist()}; the CPU port's "
          f"{cpu_rows.tolist()}; limit {VOCAB_DESC_DIFF}; {n_set} not in it "
          f"at any row); {n_words} words trained in "
          f"{train_s:.1f} s; the file from the reference's descriptors "
          f"{sha_ref_descs} (the reference CPU run's {want_sha}: equal "
          f"{sha_ref_descs == want_sha}); from the card's {sha} (equal "
          f"{sha == want_sha}); the committed vocab_synth.txt "
          f"{str(ref['committed.sha256'])}; launches {launches}",
          flush=True)
    if n_diff > VOCAB_DESC_DIFF or not set(diff_rows) <= set(cpu_rows):
        fail(f"train_vocab: descriptor rows {diff_rows.tolist()} differ "
             f"from the reference's (limit {VOCAB_DESC_DIFF}, only the CPU "
             f"port's {cpu_rows.tolist()})")
    if sha_ref_descs != want_sha:
        fail("train_vocab: the training on the reference's descriptors "
             "differs from the reference's file")
    if n_diff == 0 and sha != want_sha:
        fail("train_vocab: equal descriptors, another vocabulary")
    return launches, {"harvest_s": harvest_s, "train_s": train_s,
                      "desc_rows_differ": n_diff}


def brief_tie(sel, chosen, at, want_tests):
    """The first row where chosen parts from want_tests, and the margin
    there: the smaller distance from the threshold of the two tests'
    largest |correlation| with the rows before (None, None if equal)."""
    differ = np.flatnonzero(np.asarray(chosen) != np.asarray(want_tests))
    if differ.size == 0:
        return None, None
    k = int(differ[0])
    if k == 0:
        return k, float("inf")
    r = sel.corr([chosen[k], want_tests[k]], chosen[:k]).max(1)
    return k, float(np.min(np.abs(r - at[k])))


def harvest_angle_hold():
    """The BRIEF harvest's first render on the card: orb_describe's IC
    angle of every valid keypoint against its plain version's on the same
    levels and corners, held to phase_describe's tolerance (within 1e-5
    rad mod 2 pi but where the plain version's stability margin is below
    1e-4 tau mass; bins equal for >= 99.9%). The kernel sums the moments
    in another order, so the bits of the angles differ; the windows,
    rotated by these angles, differ from the CPU port's at least there.
    Then the angles offset by one bin's width (a planted fault) must miss.
    One launch, outside the counted harvest. Returns (the share of angles
    that differ in some bit, max error, bins' agreement, near-gate count,
    those of them that differ by more than 1e-5)."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    from object_slam_tpu_torch.ops import describe as dsc
    cfg = SlamConfig.tum_rgbd()
    scene = SyntheticScene.make(cfg, seed=0, n_objects=2, plane_z=3.0)
    gray = scene.render_rgbd(orbit_poses(8, radius=0.5, step=0.05)[0])[0]
    ex = OrbExtractor(cfg, device="cuda", pyramid_order="xla")
    img = torch.from_numpy(np.asarray(gray, np.float32)).cuda()
    levels, det, cy, cx, counts = ex._detect(img)
    lvl = ex._level_ids(counts, img.device)
    radius = cfg.orb.half_patch
    k_ang, _ = ex._kernel(1, img.device)(levels, cy, cx, lvl)
    p_ang, _ = dsc.orb_describe_ref(levels, cy, cx, lvl, ex.brief_idx1,
                                    ex.brief_idx2, radius=radius)
    near = dsc.near_gate(levels, cy, cx, lvl, radius=radius)
    valid = det[2]
    share = float((k_ang != p_ang)[valid].double().mean())
    max_err, same_frac, n_near, n_near_diff, _ = angle_hold(
        k_ang, p_ang, near, valid)
    bad = angle_misses(max_err, same_frac)
    if bad:
        fail("train_brief: the harvest's IC angles on the card miss the "
             "describe tolerance: " + "; ".join(bad))
    shifted = k_ang + 2.0 * math.pi / dsc.N_ANGLE_BINS
    if not angle_misses(*angle_hold(shifted, p_ang, near, valid)[:2]):
        fail("train_brief: the harvest's angles offset by one bin's width "
             "pass the describe tolerance")
    return share, max_err, same_frac, n_near, n_near_diff


def phase_train_brief(card):
    """scripts/train_brief_pattern_torch.py at full size on the card: the
    harvest (per render one orb_describe, then one extract_patches_levels
    launch for the keypoints' windows on every level's blurred image; each
    launch held bit-exact to its plain version on the same inputs, the
    BRIEF_RENDERS launches of each kernel asserted and the per-level
    counts beside the reference's harvest), then the selection over the
    50,000 patches (the
    bits of ~60.7k tests kept centred in f32 on the card), its quality
    line and the pattern against the committed brief_pattern.npy
    (printed). Then the selection held row for row to the reference's
    main() on brief_cases.integer_corpus(BRIEF_CARD_CORPUS), in the
    reference's scan order: where a row parts, some test's |correlation|
    must lie within BRIEF_TIE of the threshold; the quality within
    BRIEF_QUALITY_TOL. Returns the launches, the timings and
    extract_patches' row at the harvest's shapes (one render's launch)."""
    import torch
    from object_slam_tpu_torch.ops import patch as patch_mod
    tb = script_module("train_brief_pattern_torch")
    sys.path.insert(0, FIXTURES)
    import brief_cases
    ref = np.load(BRIEF_REF)
    zero_counts()
    calls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    patches = tb.harvest_patches(device="cuda", levels_out=calls)
    torch.cuda.synchronize()
    harvest_s = time.perf_counter() - t0
    launches = counts_now()
    renders = len(calls)
    want_launches = {"extract_patches": BRIEF_RENDERS,
                     "orb_describe": BRIEF_RENDERS}
    if launches != want_launches or renders != BRIEF_RENDERS:
        fail(f"train_brief: kernel launches {launches} for {renders} "
             f"renders, expected {want_launches}")
    for blurred, ys, xs, lv, p in calls:
        if not torch.equal(p, patch_mod.extract_patches_levels_ref(
                blurred, ys, xs, lv)):
            fail("train_brief: an extract_patches_levels launch differs "
                 "from its plain version")
    got_calls = [[int(b[l].shape[0]), int((lv == l).sum())]
                 for b, _, _, lv, _ in calls for l in range(len(b))
                 if int((lv == l).sum())]
    ref_calls = ref["full.calls"].tolist()
    sums = patches.reshape(patches.shape[0], -1).sum(1).cpu().numpy()
    # the windows that differ from the CPU port's (its windows' hashes:
    # the same pyramid order, so the same windows where the rest rounds
    # alike)
    hashes = brief_cases.window_hashes(patches.cpu().numpy())
    cpu_hash = ref["cpu_port.window_hash"]
    n_win_diff = (int((hashes != cpu_hash).sum())
                  if hashes.shape == cpu_hash.shape else -1)
    angle_share, angle_err, bins_frac, n_near, n_near_diff = \
        harvest_angle_hold()
    rel = (np.abs(sums - ref["full.sums"]) / np.abs(ref["full.sums"])
           if sums.shape == ref["full.sums"].shape else np.array([np.inf]))
    # extract_patches at these shapes: the first render's launch, beside
    # the per-level launches it replaces
    row = patch_levels_row(*calls[0][:4], "the BRIEF harvest, one render")
    row["windows_per_render"] = int(calls[0][1].shape[0])
    # the selection at full size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sel = tb.TestSelector(patches)
    torch.cuda.synchronize()
    bits_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    relax = []
    chosen, at = sel.select(log=relax.append)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    pattern = sel.pattern(chosen)
    q = sel.quality(chosen)
    committed = np.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "object_slam_tpu_torch",
        "features", "brief_pattern.npy"))
    same_rows = int(np.sum(np.all(pattern == committed, axis=1)))
    c_tests = sel.pattern_tests(committed)
    q_committed = sel.quality(c_tests) if (c_tests >= 0).all() else None
    bits_bytes = sel.T * sel.n * 4
    del sel
    # the exact hold on the integer corpus
    corpus = torch.from_numpy(brief_cases.integer_corpus(
        BRIEF_CARD_CORPUS)).cuda()
    sel8 = tb.TestSelector(corpus)
    ref_order = ref[f"corpus{BRIEF_CARD_CORPUS}.order"]
    own_order = bool(np.array_equal(sel8.order(), ref_order))
    t0 = time.perf_counter()
    chosen8, at8 = sel8.select(order=ref_order, log=lambda *a: None)
    torch.cuda.synchronize()
    select8_s = time.perf_counter() - t0
    want8 = ref[f"corpus{BRIEF_CARD_CORPUS}.pattern"]
    k, margin = brief_tie(sel8, chosen8, at8, sel8.pattern_tests(want8))
    q8 = np.asarray(sel8.quality(chosen8))
    q8_ref = ref[f"corpus{BRIEF_CARD_CORPUS}.quality"]
    print(f"train_brief [{card}]: harvest {patches.shape[0]} patches from "
          f"{renders} renders in {harvest_s:.1f} s, {renders} "
          f"extract_patches_levels launches, each bit-exact to its plain "
          f"version; "
          f"per-level counts equal to the reference harvest's "
          f"{got_calls == ref_calls} ({len(got_calls)} / {len(ref_calls)} "
          f"calls); {n_win_diff} of {hashes.size} windows differ from the "
          f"CPU port's harvest (window hashes; the first render's IC angles "
          f"from the kernel differ from its plain version's in some bit in "
          f"{angle_share:.4f} of its keypoints, and each window is rotated "
          f"by its angle; held to the describe tolerance: max error "
          f"{angle_err:.3e} rad outside {n_near} near-gate keypoints "
          f"({n_near_diff} of them differ), bins agree {bins_frac:.6f}; "
          f"offset by one bin's width, they miss); patch sums against the reference's: max relative "
          f"{float(rel.max()):.3e}, median {float(np.median(rel)):.3e}; "
          f"selection over {tb.N_CANDIDATES} draws -> {len(sel8.ia)} tests x "
          f"{patches.shape[0]} patches ({bits_bytes / 2 ** 30:.2f} GiB of "
          f"centred f32 bits) built in {bits_s:.2f} s, selected in "
          f"{select_s:.2f} s ({relax}); learned: |mean-0.5| avg "
          f"{q[0]:.6f}, corr avg {q[1]:.6f} / p95 {q[2]:.6f}; the committed "
          f"pattern on this corpus "
          f"{'not a candidate set' if q_committed is None else [round(x, 6) for x in q_committed]}"
          f", {same_rows} of 256 rows equal; integer corpus "
          f"{BRIEF_CARD_CORPUS}: own scan order equal to the reference's "
          f"{own_order}, selected in {select8_s:.2f} s, first row parting "
          f"from the reference's {k} (margin {margin}), quality "
          f"{q8.tolist()} against {q8_ref.tolist()}; launches {launches}",
          flush=True)
    if pattern.shape != (256, 4) or len(set(map(int, chosen))) != 256:
        fail("train_brief: the learned pattern is not 256 distinct tests")
    if k is not None and not margin <= BRIEF_TIE:
        fail(f"train_brief: row {k} parts from the reference's with margin "
             f"{margin} > {BRIEF_TIE}")
    if not np.all(np.abs(q8 - q8_ref) <= BRIEF_QUALITY_TOL):
        fail(f"train_brief: quality {q8.tolist()} against {q8_ref.tolist()}")
    row["launches"] = launches["extract_patches"]
    return launches, {"harvest_s": harvest_s, "bits_s": bits_s,
                      "angle_share": angle_share, "angle_max_err": angle_err,
                      "angle_bins": bins_frac,
                      "select_s": select_s, "select8_s": select8_s,
                      "bits_bytes": bits_bytes,
                      "windows_differ_from_cpu": n_win_diff}, row


def tools_child_main(out_json: str):
    """The third process: the generators, the battery, the KITTI stage
    timer (phase_stage_kitti) and the op-level trace on its drive
    (phase_trace_stage), the vocabulary trainer and the BRIEF-pattern
    learner on the card, then the main path's kidnap (phase_kidnap); the
    launches by phase, the phase seconds, the timings, the stage timer's
    ms, the traced stages and extract_patches' row at the harvest's
    shapes written to out_json."""
    import torch
    from object_slam_tpu_torch.ops import build
    if not torch.cuda.is_available():
        fail("no CUDA device")
    build.load_all(KERNELS)
    card = card_line()
    by_phase = {}
    root = phase_timed("synth_dirs", phase_synth_dirs, card)
    exp = phase_timed("experiments", phase_experiments, root, card)
    by_phase.update({f"experiments_{k}": v for k, v in exp.items()})
    # the KITTI stage timer of slice 13 on the battery's KITTI directory
    by_phase["stage_kitti"], kitti_stage_ms, kitti_state = phase_timed(
        "stage_kitti", phase_stage_kitti, card, root, keep=True)
    # the op-level stage trace of slice 14 on that drive
    try:
        trace = phase_timed("trace_stage", phase_trace_stage, card,
                            kitti_state)
    finally:
        kitti_state["sys"].shutdown()
    by_phase["train_vocab"], vocab_s = phase_timed(
        "train_vocab", phase_train_vocab, card)
    by_phase["train_brief"], brief_s, brief_row = phase_timed(
        "train_brief", phase_train_brief, card)
    # the main path's kidnap (6) runs here, beside the main process's
    # other phases, for the time limit
    from object_slam_tpu_torch.config import SlamConfig
    kid = phase_timed("kidnap", phase_kidnap, SlamConfig.tum_rgbd(), card)
    by_phase["kidnap_replay"] = kid["replay"]
    by_phase["kidnap_own_sampler"] = kid["own"]
    with open(out_json, "w") as f:
        json.dump({"by_phase": by_phase, "phase_s": PHASE_S,
                   "vocab_s": vocab_s, "brief_s": brief_s,
                   "brief_row": brief_row,
                   "kitti_stage_ms": kitti_stage_ms, "trace": trace}, f)


# ---------------------------------------------------------------------------
# the accuracy studies of scripts/*_torch.py (a fourth process): the mapping
# variants, the aliased corridor, the semantic-refinement probes; the
# closure probe rides the circuit's replay in this process
# ---------------------------------------------------------------------------

STUDIES_REF = os.path.join(FIXTURES, "studies_vga.npz")
STUDIES_CAND_REF = os.path.join(FIXTURES, "studies.npz")
STUDIES_ARG = "--studies-phases"
STUDY_VARIANTS = ("base", "recency_off", "no_reelect", "scale_cond_on")
# the variants on the first STUDY_VAR_FRAMES frames of the script's
# 120-frame circuit (a depth cut for the time limit; the 120 frames ran
# once at full length, PERF.md section 6); the planted fault (the
# re-election flag ignored) on the first STUDY_VAR_FAULT_FRAMES, where the
# JAX no_reelect run's keyframes already part from base's (frame 10)
STUDY_VAR_FRAMES = 40
STUDY_VAR_FAULT_FRAMES = 16
# the TUM checks' limits: records, ATE (mm); the variants' circuit is
# chaotic, so its limits widen to STUDY_NOISE_MARGIN times the spread of
# the JAX run's STUDY_NOISE_RUNS pinned one-ulp noise runs where that is
# wider (study_variant_bands)
STUDY_REC_M = 2e-3
STUDY_REC_DEG = 0.1
STUDY_ATE_MM = 0.02
STUDY_NOISE_MARGIN = 2.0
STUDY_NOISE_RUNS = 8
# the corridor's event numbers: 1e-3 relative, or ALIAS_NOISE_MARGIN times
# the JAX run's own spread under one-ulp noise with its decisions pinned
ALIAS_RTOL = 1e-3
ALIAS_NOISE_MARGIN = 2.0
# the semantic probes: the first STUDY_SEM_FRAMES frames of a
# make_synth_tum_torch.py directory at SlamConfig.tum_rgbd(); the probe's
# planted faults (the pose before the refinement thrown away, as the port
# did before SlamSystem._last_presem_Tcw; the refinement handing back the
# pose it was given) on the first STUDY_SEM_FAULT_FRAMES. Each refined
# frame's shift (its camera centre after the refinement less before it,
# 0.05-0.5 mm) is held to the JAX run's: the median over the frames of
# |port - JAX| / |JAX| at most STUDY_SHIFT_RTOL (a refinement that
# hands back its input reads 1)
STUDY_SEM_FRAMES = 24
STUDY_SEM_FAULT_FRAMES = 6
STUDY_SHIFT_RTOL = 0.1


def _rot_deg(a, b):
    R = np.asarray(a)[:3, :3].T.astype(np.float64) @ np.asarray(b)[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


class _InsertTap:
    """Records the frame of every keyframe insertion of every SlamSystem
    while it is active (SlamSystem._insert_impl wrapped on the class)."""

    def __enter__(self):
        from object_slam_tpu_torch.slam.system import SlamSystem
        self.frames, self._orig = [], SlamSystem._insert_impl
        tap = self

        def insert_impl(sys_, m, frame, Tcw, kp_pt, close_mask, frame_id):
            tap.frames.append(int(frame_id))
            return tap._orig(sys_, m, frame, Tcw, kp_pt, close_mask,
                             frame_id)
        SlamSystem._insert_impl = insert_impl
        return self

    def __exit__(self, *exc):
        from object_slam_tpu_torch.slam.system import SlamSystem
        SlamSystem._insert_impl = self._orig


def study_variant_bands(ref, name, n):
    """One mapping variant's limits over its first n frames: per frame,
    (records m, records deg), the TUM checks' 2 mm / 0.1 deg or
    STUDY_NOISE_MARGIN times the farthest that the JAX run's pinned one-ulp
    noise runs (STUDY_NOISE_RUNS or more) land from it by that frame,
    whichever is wider; and the ATE's (mm), 0.02 or STUDY_NOISE_MARGIN
    times the noise runs' farthest ATE. The circuit is chaotic: a one-ulp
    change grows along it (the card's base run parted from the JAX CPU run
    by 32.9 mm / 0.84 deg on the same keyframes, PERF.md section 6), so a
    frame is held to the spread of the frames up to it and no later."""
    p = f"var.{name}."
    k_runs = int(ref[p + "n_noise"])
    if k_runs < STUDY_NOISE_RUNS:
        fail(f"study variant {name}: {STUDIES_REF} holds {k_runs} noise "
             f"runs; {STUDY_NOISE_RUNS} are needed")
    rec = ref[p + "rec_tcw"][:n]
    want_ate = json.loads(str(ref[p + "result"]))["ate_rmse_mm"]
    d, a, e = np.zeros(n), np.zeros(n), 0.0
    for k in range(k_runs):
        q = f"{p}noise.{k}."
        nz = ref[q + "rec_tcw"][:n]
        d = np.maximum(d, np.abs(nz[:, :3, 3] - rec[:, :3, 3]).max(1))
        a = np.maximum(a, [_rot_deg(x, y) for x, y in zip(nz, rec)])
        e = max(e, abs(json.loads(str(ref[q + "result"]))["ate_rmse_mm"]
                       - want_ate))
    return (np.maximum(STUDY_REC_M,
                       STUDY_NOISE_MARGIN * np.maximum.accumulate(d)),
            np.maximum(STUDY_REC_DEG,
                       STUDY_NOISE_MARGIN * np.maximum.accumulate(a)),
            max(STUDY_ATE_MM, STUDY_NOISE_MARGIN * e))


def study_variant_checks(ref, name, res, sys_, inserts, n):
    """[(what, port, reference, held)] of one mapping variant over its
    first n frames against the JAX run (studies_vga.npz), each frame's
    record and the ATE within study_variant_bands (the records reported at
    the frame nearest its limit)."""
    p = f"var.{name}."
    want = json.loads(str(ref[p + "result"]))
    rec_m, rec_deg, ate_mm = study_variant_bands(ref, name, n)
    sys_._resolve_fused_pending()
    recs = sys_.trajectory
    tracked = [r.tracked for r in recs]
    want_tr = ref[p + "tracked"][:n].tolist()
    want_ins = [f for f in ref[p + "insert_frames"].tolist() if f < n]
    wrec = ref[p + "rec_tcw"][:n]
    d = np.array([float(np.abs(r.Tcw[:3, 3] - w[:3, 3]).max())
                  for r, w in zip(recs, wrec)])
    a = np.array([_rot_deg(r.Tcw, w) for r, w in zip(recs, wrec)])
    fm, fa = int(np.argmax(d / rec_m)), int(np.argmax(a / rec_deg))
    checks = [("tracked", tracked, want_tr, tracked == want_tr),
              ("keyframes at", inserts, want_ins, inserts == want_ins),
              (f"records m (frame {fm})", d[fm], rec_m[fm],
               bool(np.all(d <= rec_m))),
              (f"records deg (frame {fa})", a[fa], rec_deg[fa],
               bool(np.all(a <= rec_deg)))]
    if n == len(ref[p + "tracked"]):
        checks += [
            ("ATE mm", res["ate_rmse_mm"],
             f"{want['ate_rmse_mm']} +- {ate_mm}",
             abs(res["ate_rmse_mm"] - want["ate_rmse_mm"]) <= ate_mm),
            ("keyframes", res["n_keyframes"], want["n_keyframes"],
             res["n_keyframes"] == want["n_keyframes"])]
    print(f"study variant {name}: records m by frame "
          f"{np.round(d, 6).tolist()} against {np.round(rec_m, 6).tolist()}",
          flush=True)
    return checks


def phase_study_variants(card):
    """scripts/ab_deviations_torch.py's four mapping-policy variants at
    --scale 1 (640x480, 8 levels, 1000 features, n_kp 1024) on the first
    STUDY_VAR_FRAMES frames of its circuit, through its run_variant, each
    held to the JAX CPU run of the same frames (studies_vga.npz; flags,
    keyframe frames, keyframe count exact, each frame's records and the
    script's ATE within study_variant_bands), one orb_describe per frame;
    then
    no_reelect with its flag ignored (faults.ignore_reelect_flag), which
    must fail a check. Returns the launches of each run."""
    import torch
    from object_slam_tpu_torch.datasets.synthetic import render_room
    sys.path.insert(0, FIXTURES)
    import faults
    ab = script_module("ab_deviations_torch")
    ref = np.load(STUDIES_REF)
    cfg = ab.build_cfg(1)
    scene, poses = ab.circuit(cfg, 3, 120, 1.15)
    poses = poses[:STUDY_VAR_FRAMES]
    rendered, render_s = render_room(cfg, poses)
    frames = [f[:3] for f in rendered]
    print(f"study variants: rendered {len(frames)} frames in "
          f"{render_s:.1f} s", flush=True)
    out = {}
    for name in STUDY_VARIANTS + ("no_reelect_fault",):
        fault = name.endswith("_fault")
        vname = "no_reelect" if fault else name
        n = STUDY_VAR_FAULT_FRAMES if fault else len(frames)
        vcfg = ab.variant_cfg(cfg, vname)
        if fault:
            vcfg = faults.ignore_reelect_flag(vcfg)
        systems = []
        torch.cuda.synchronize()
        zero_counts()
        with _InsertTap() as tap:
            res = ab.run_variant(vcfg, scene, poses[:n], device="cuda",
                                 frames=frames[:n], systems=systems)
        torch.cuda.synchronize()
        out[name] = read_counts(f"study variant {name}", n)
        checks = study_variant_checks(ref, vname, res, systems[0],
                                      tap.frames, n)
        failed = [c for c in checks if not c[3]]
        print(f"study variant {name} [{card}]: {json.dumps(res)}; "
              f"{res['wall_s'] / n * 1e3:.1f} ms/frame; keyframes at "
              f"{tap.frames}; "
              + "; ".join(f"{c[0]} {c[1] if not isinstance(c[1], list) else ''}"
                          f" ({'held' if c[3] else 'missed'}, limit {c[2] if not isinstance(c[2], list) else 'equal'})"
                          for c in checks), flush=True)
        if fault and not failed:
            fail("study variants: no_reelect with its flag ignored passes "
                 "every check")
        if not fault and failed:
            fail(f"study variant {name}: " + "; ".join(
                f"{c[0]} {c[1]} (reference {c[2]})" for c in failed))
    return out


def alias_bands(ref, n_events):
    """Each corridor event's numbers: the farthest that the JAX run's
    pinned one-ulp noise runs land from it, per key, over the events they
    share with it."""
    main = json.loads(str(ref["alias.events"]))[:n_events]
    spread = [dict() for _ in main]
    for k in range(int(ref["alias.n_noise"])):
        ev = json.loads(str(ref[f"alias.noise.{k}.events"]))
        for i, (e, m) in enumerate(zip(ev, main)):
            if loop_events([e]) != loop_events([m]):
                continue
            for key, v in m.items():
                if isinstance(v, float) and key != "wall_ms":
                    spread[i][key] = max(spread[i].get(key, 0.0),
                                         abs(e[key] - v))
    return main, spread


def alias_event_misses(got, want, spread):
    """The numbers of an event outside 1e-3 relative and outside
    ALIAS_NOISE_MARGIN times the reference's spread."""
    bad = []
    for key, v in want.items():
        if not isinstance(v, float) or key == "wall_ms":
            continue
        lim = max(1e-9 + ALIAS_RTOL * abs(v),
                  ALIAS_NOISE_MARGIN * spread.get(key, 0.0))
        if abs(got.get(key, float("nan")) - v) > lim:
            bad.append((key, got.get(key), v, lim))
    return bad


def alias_candidate(cfg, cand, fault=None):
    """The port's _correct_loop on the corridor's recorded first candidate
    (studies.npz alias.pre.*: map rows, q, l, T12, s12) on the card:
    (event, accepted)."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.slam.system import SlamSystem
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cuda")
    lc = sys_.loop_closer
    if fault is not None:
        fault(lc)
    base = interop.map_state_to_numpy(sys_.map)
    rows = {k[len("alias.pre.m."):]: cand[k] for k in cand.files
            if k.startswith("alias.pre.m.")}
    m = interop.map_state_from_numpy(interop.overlay_rows(base, rows),
                                     device="cuda")
    _, accepted = lc._correct_loop(
        m, int(cand["alias.pre.q"]), int(cand["alias.pre.l"]),
        torch.from_numpy(cand["alias.pre.T12"]).cuda(),
        float(cand["alias.pre.s12"]))
    return lc.events[-1], accepted


_ALIAS_WORKER = {}


def _alias_worker_init(scale):
    al = script_module("diag_loop_alias_torch")
    cfg = al.build_cfg(scale)
    _ALIAS_WORKER.update(al=al, cfg=cfg, scene=al.build_alias_scene(cfg))


def _alias_render(Twc):
    w = _ALIAS_WORKER
    gray, depth, rgb, sem = w["al"].render_frame(w["scene"], w["cfg"], Twc)
    return (gray.astype(np.float32), depth.astype(np.float32),
            rgb.astype(np.float32), sem)


def render_corridor(poses_wc, scale=1, workers=4):
    """Start rendering the corridor's frames (float32 gray, depth, rgb and
    the sem arrays, as diag_loop_alias_torch.render_frame gives them) at
    the camera-to-world poses in a pool of spawned processes (the scene's
    numpy draws are seeded, so every worker builds the same corridor),
    beside the phases before the corridor's: (pool, pending result)."""
    import multiprocessing as mp
    pool = mp.get_context("spawn").Pool(
        min(os.cpu_count() or 1, workers), initializer=_alias_worker_init,
        initargs=(scale,))
    return pool, pool.map_async(_alias_render, list(poses_wc), chunksize=1)


def corridor_path():
    """The corridor's camera-to-world poses through the frames of the JAX
    CPU run's first rejection (studies_vga.npz alias.depth)."""
    al = script_module("diag_loop_alias_torch")
    return al.straight_path(int(np.load(STUDIES_REF)["alias.depth"]),
                            step=0.2)


def phase_study_corridor(card, rendering):
    """scripts/diag_loop_alias_torch.py's corridor at --scale 1 (640x480)
    on its frames (render_corridor's pending result, rendered beside the
    variants): orb_describe against its plain version on a corridor frame;
    the corridor through the frames of the JAX CPU run's first rejection
    (corridor_path), objects off, the default pipelined readback, replayed
    (the JAX run's keyframe decisions and Sim3 draws: flags, keyframes,
    events (q, l, accepted, pre-gated), loops closed and rejected exact,
    each event's numbers within 1e-3 relative or ALIAS_NOISE_MARGIN times
    the JAX run's pinned one-ulp spread) and with its own decisions through
    the script's run_alias (no accepted closure; each rejection by the gate
    the JAX run used, on a candidate within 2 keyframes of one of its
    events); one orb_describe per frame in each; then the first candidate's
    recorded input (studies.npz): the pre-gate's event as the
    reference's, and with the pre-gate disabled (faults.disable_pre_gate,
    a planted fault that must miss the pre-gated event) the post-gates
    deciding gate by gate as the reference's with its absolute pre-gate
    limits lifted. Returns (launches by run, orb_describe's row at the
    corridor's shapes, the own run's events with their wall ms)."""
    import argparse
    import torch
    from object_slam_tpu_torch.slam.system import SlamSystem
    sys.path.insert(0, FIXTURES)
    import faults
    al = script_module("diag_loop_alias_torch")
    ref = np.load(STUDIES_REF)
    cand = np.load(STUDIES_CAND_REF)
    poses_wc = corridor_path()
    depth = len(poses_wc)
    cfg = al.build_cfg(1)
    pool, pending = rendering
    t0 = time.perf_counter()
    try:
        frames = pending.get()
    finally:
        pool.terminate()
        pool.join()
    sums = [float(np.sum(f[0], dtype=np.float64)) for f in frames]
    if not np.allclose(sums, ref["alias.gray_sum"][:depth], rtol=1e-12,
                       atol=0):
        fail("corridor: the rendered frames differ from the reference run's")
    print(f"corridor: {depth} frames rendered beside the variants; waited "
          f"{time.perf_counter() - t0:.1f} s for them", flush=True)
    ex, levels, corners = main_path_inputs(cfg, frames[depth // 2][0])
    row = phase_describe(ex, levels, corners, tag="corridor VGA")
    main_ev, spread = alias_bands(ref, len([
        f for f in ref["alias.event_frames"].tolist() if f < depth]))
    ref_kfs = set(ref["alias.insert_frames"].tolist())
    # the reference's defaults at --scale 1, over the replayed frames
    args = argparse.Namespace(frames=depth, periods=16, period=3.2, step=0.2,
                              scale=1, seed=7)
    out, events = {}, {}
    for name in ("replay", "own"):
        systems = []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with _InsertTap() as tap:
            if name == "replay":
                sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                                  device="cuda")
                sys_._need_keyframe = lambda pend, p: pend["fid"] in ref_kfs
                sets = [torch.from_numpy(s).cuda()
                        for s in ref["alias.sim3_sets"]]
                sys_.loop_closer._minimal_sets = \
                    lambda valid, n_trials=256: sets.pop(0)
                for i, (g, d, rgb, _) in enumerate(frames):
                    sys_.track_rgbd(g, d, rgb, None, timestamp=i / 30.0)
                sys_.flush_mapping()
                summ = al.alias_summary(sys_, poses_wc, depth)
            else:
                summ = al.run_alias(args, device="cuda", systems=systems,
                                    frames=frames)
                sys_ = systems[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = read_counts(f"corridor {name}", depth)
        ev = summ["events"]
        events[name] = ev
        tracked = [r.tracked for r in sys_.trajectory]
        print(f"corridor {name} [{card}]: {depth} frames, "
              f"{secs / depth * 1e3:.1f} ms/frame; keyframes at "
              f"{tap.frames}; events {json.dumps(ev)}; "
              f"{json.dumps({k: v for k, v in summ.items() if k != 'events'})}",
              flush=True)
        if summ["loops_closed"] or any(e["accepted"] for e in ev):
            fail(f"corridor {name}: a false closure was accepted: {ev}")
        if name == "replay":
            want_tr = ref["alias.tracked"][:depth].tolist()
            want_ins = [f for f in ref["alias.insert_frames"].tolist()
                        if f < depth]
            bad = []
            if tracked != want_tr:
                bad.append(f"tracked flags {tracked}")
            if tap.frames != want_ins:
                bad.append(f"keyframes at {tap.frames}, reference "
                           f"{want_ins}")
            if loop_events(ev) != loop_events(main_ev):
                bad.append(f"events {loop_events(ev)}, reference "
                           f"{loop_events(main_ev)}")
            if summ["loops_rejected"] != len(main_ev):
                bad.append(f"rejected {summ['loops_rejected']}")
            for e, w, s in zip(ev, main_ev, spread):
                miss = alias_event_misses(e, w, s)
                if miss:
                    bad.append(f"event ({w['q']}, {w['l']}) numbers {miss}")
            if bad:
                fail("corridor replay: " + "; ".join(bad))
        else:
            jax_ev = json.loads(str(ref["alias.events"]))
            for e in ev:
                near = [w for w in jax_ev
                        if abs(w["q"] - e["q"]) <= 2
                        and abs(w["l"] - e["l"]) <= 2]
                if not near or bool(e.get("pre_gated")) != bool(
                        near[0].get("pre_gated")):
                    fail(f"corridor own decisions: rejection {e} not by the "
                         f"gate of a JAX candidate within 2 keyframes "
                         f"({near})")
            print(f"corridor own decisions [{card}]: {len(ev)} rejection(s) "
                  f"{loop_events(ev)}, each by the JAX run's gate on a "
                  f"candidate within 2 keyframes; no accepted closure",
                  flush=True)
    # the first candidate's recorded input: the pre-gate, then the
    # post-gates behind a disabled pre-gate
    want_pre = json.loads(str(cand["alias.pre.event"]))
    ev, acc = alias_candidate(cfg, cand)
    miss = alias_event_misses(ev, want_pre, {})
    if acc or loop_events([ev]) != loop_events([want_pre]) or miss:
        fail(f"corridor candidate: pre-gate event {ev} against {want_pre} "
             f"({miss})")
    post, acc = alias_candidate(cfg, cand, fault=faults.disable_pre_gate)
    want_post = json.loads(str(cand["alias.postgate.event"]))
    if loop_events([post]) == loop_events([want_pre]):
        fail("corridor candidate: with the pre-gate disabled the event "
             "still reads pre-gated")

    def gates(e):
        loop = cfg.loop
        return (e["q_after"] <= e["q_before"]
                * (1.0 + loop.benefit_gate_tolerance)
                + loop.benefit_gate_abs_floor,
                e["bend_deg"] <= e["budget_deg"],
                e["bend_frac"] <= e["budget_frac"])
    print(f"corridor candidate [{card}]: pre-gate {json.dumps(ev)}; with "
          f"the pre-gate disabled {json.dumps(post)} (the reference "
          f"{json.dumps(want_post)}); gates (benefit, bend deg, bend frac) "
          f"{gates(post)} against {gates(want_post)}", flush=True)
    if acc or gates(post) != gates(want_post):
        fail("corridor candidate: the post-gates decide otherwise than the "
             "reference's")
    return out, row, events["own"]


def _centre(T):
    return np.linalg.inv(np.asarray(T, np.float64))[:3, 3]


def misfit(got, want):
    """Per row of two [n, 3] arrays of camera-centre differences (m),
    |got - want| / |want|, over the rows where want is not 0."""
    got = np.asarray(got, np.float64).reshape(-1, 3)
    want = np.asarray(want, np.float64).reshape(-1, 3)
    norm = np.linalg.norm(want, axis=1)
    keep = norm > 0
    return np.linalg.norm(got - want, axis=1)[keep] / norm[keep]


def shift_misfit(poses, pre_ref, post_ref):
    """Each refined frame's shift (the camera centre after the semantic
    refinement less the one before it) against the reference run's."""
    return misfit([_centre(post) - _centre(pre) for _, pre, post in poses],
                  [_centre(w1) - _centre(w0)
                   for w0, w1 in zip(pre_ref, post_ref)][:len(poses)])


def study_sem_dir():
    """A STUDY_SEM_FRAMES-frame make_synth_tum_torch.py directory under
    build/studies_smoke/ (the first frames of the reference's 40-frame
    directory: orbit poses do not depend on the count)."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "studies_smoke", "tum")
    if os.path.isdir(root):
        import shutil
        shutil.rmtree(root)
    script_module("make_synth_tum_torch").write(root,
                                                frames=STUDY_SEM_FRAMES)
    return root


def phase_study_semantic(card):
    """scripts/diag_semopt_torch.py's probe and
    scripts/diag_semopt_ragged_torch.py's A/B at SlamConfig.tum_rgbd() on
    a STUDY_SEM_FRAMES-frame TUM directory, held to the JAX CPU runs of
    the same frames (studies_vga.npz): the probe's frames, each frame's
    pose before and after the refinement within 2 mm / 0.1 deg, the
    refinement's shifts within STUDY_SHIFT_RTOL (shift_misfit's median),
    the summary's keys and frame count exact and its millimetres within
    2 mm, the census exact; then the probe with the pose before the
    refinement thrown away and with the refinement handing back its input
    (faults.skip_semantic_refinement), planted faults which must each fail;
    the ragged masks bit-equal to the reference's (and with another seed,
    a planted fault, not), both arms without the script's prewarm (its
    systems are thrown away): flags, keyframes, counts and census exact,
    records within 2 mm / 0.1 deg, points and constraints within 10%. One
    orb_describe per frame in each run. Returns the launches of each
    run."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    sys.path.insert(0, FIXTURES)
    import faults
    sem_mod = script_module("diag_semopt_torch")
    rag_mod = script_module("diag_semopt_ragged_torch")
    rex = script_module("run_experiments_torch")
    ref = np.load(STUDIES_REF)
    seq = study_sem_dir()
    cfg = SlamConfig.tum_rgbd()
    metas, frames = rex.load_tum_frames(seq, cfg, STUDY_SEM_FRAMES)
    ts_gt, pos_gt, _ = tum.load_groundtruth(seq)
    gt = {round(t, 4): p for t, p in zip(ts_gt, pos_gt)}
    out = {}

    def census(sys_):
        m = sys_.map
        lab, cnt = np.unique(m.obj_label[m.obj_valid].cpu().numpy(),
                             return_counts=True)
        return lab.tolist(), cnt.tolist()

    def probe(n, fault=None):
        from object_slam_tpu_torch.slam import objects as obj_mod
        orig = obj_mod.ObjectEngine.track_local_map_semantic
        undo = None
        if fault == "thrown away":
            def thrown_away(self, m, frame, tr):
                return orig(self, m, frame, tr)[:3] + (None,)
            obj_mod.ObjectEngine.track_local_map_semantic = thrown_away
        elif fault == "skipped":
            undo = faults.skip_semantic_refinement()
        try:
            systems = []
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            deltas, poses, summ = sem_mod.run_probe(
                cfg, metas[:n], frames[:n], gt, device="cuda", log_every=0,
                systems=systems)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            obj_mod.ObjectEngine.track_local_map_semantic = orig
            if undo is not None:
                undo()
        bad = []
        want_frames = [f for f in ref["semopt.frames"].tolist() if f < n]
        if [i for i, _, _ in poses] != want_frames:
            bad.append(f"frames {[i for i, _, _ in poses]}")
        for (i, pre, post), wpre, wpost in zip(
                poses, ref["semopt.pre_tcw"], ref["semopt.post_tcw"]):
            for tag, a, b in (("pre", pre, wpre), ("post", post, wpost)):
                d = float(np.abs(a[:3, 3] - b[:3, 3]).max())
                if d > STUDY_REC_M or _rot_deg(a, b) > STUDY_REC_DEG:
                    bad.append(f"frame {i} {tag} {d:.6f} m "
                               f"{_rot_deg(a, b):.4f} deg")
        misfit = shift_misfit(poses, ref["semopt.pre_tcw"],
                              ref["semopt.post_tcw"])
        print(f"semopt probe{' ' + fault if fault else ''} [{card}]: shift "
              f"misfit by frame {np.round(misfit, 4).tolist()}", flush=True)
        if not len(misfit) or np.median(misfit) > STUDY_SHIFT_RTOL:
            bad.append(f"shift misfit median "
                       f"{np.median(misfit) if len(misfit) else None} "
                       f"(limit {STUDY_SHIFT_RTOL})")
        return systems[0], summ, secs, bad

    sys_, summ, secs, bad = probe(STUDY_SEM_FRAMES)
    out["semopt"] = read_counts("semopt probe", STUDY_SEM_FRAMES)
    want = json.loads(str(ref["semopt.summary"]))
    if set(summ) != set(want) or \
            summ["n_semopt_frames"] != want["n_semopt_frames"]:
        bad.append(f"summary {summ}")
    bad += [f"{k} {summ[k]} against {v}" for k, v in want.items()
            if k.endswith("_mm") and abs(summ[k] - v) > STUDY_REC_M * 1e3]
    if census(sys_) != (ref["semopt.census_labels"].tolist(),
                        ref["semopt.census_counts"].tolist()):
        bad.append(f"census {census(sys_)}")
    print(f"semopt probe [{card}]: {STUDY_SEM_FRAMES} frames, "
          f"{secs / STUDY_SEM_FRAMES * 1e3:.1f} ms/frame; {json.dumps(summ)} "
          f"(JAX CPU {json.dumps(want)}); census {census(sys_)}", flush=True)
    if bad:
        fail("semopt probe: " + "; ".join(bad))
    for fault in ("thrown away", "skipped"):
        _, _, _, bad = probe(STUDY_SEM_FAULT_FRAMES, fault=fault)
        out[f"semopt_fault_{fault.replace(' ', '_')}"] = read_counts(
            f"semopt probe, the refinement {fault}", STUDY_SEM_FAULT_FRAMES)
        if not bad:
            fail(f"semopt probe: the refinement {fault} passes every check")
        print(f"semopt probe, the refinement {fault} [{card}]: misses "
              f"{bad[:2]}", flush=True)

    ragged, n_deg = rag_mod.degrade(cfg, frames)
    masks = np.concatenate([r[2][0].reshape(-1) for r in ragged
                            if r[2] is not None])
    if not np.array_equal(masks, ref["ragged.ragged_masks"]):
        fail("ragged masks differ from the reference's")
    other, _ = rag_mod.degrade(cfg, frames, seed=12)
    if np.array_equal(np.concatenate([r[2][0].reshape(-1) for r in other
                                      if r[2] is not None]),
                      ref["ragged.ragged_masks"]):
        fail("ragged masks: another seed's masks pass the check")
    def arms(n, fault=False):
        """Both arms on the first n frames: (problems, seconds)."""
        undo = faults.skip_semantic_refinement() if fault else None
        try:
            systems = []
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = rag_mod.run_arms(seq, cfg, ragged[:n], metas[:n],
                                   device="cuda", prewarm=0, systems=systems)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            if undo is not None:
                undo()
        bad, gaps = [], []
        for (name, r), sys_ in zip(res.items(), systems):
            p = f"ragged.{name}."
            w = json.loads(str(ref[p + "result"]))
            if n == STUDY_SEM_FRAMES:
                if set(r) - {"fps", "median_track_ms"} != set(w):
                    bad.append(f"{name} keys {sorted(r)}")
                for k in ("frames", "tracked", "keyframes", "objects"):
                    if r[k] != w[k]:
                        bad.append(f"{name} {k} {r[k]} against {w[k]}")
                for k in ("points", "semantic_constraints"):
                    if abs(r[k] - w[k]) > 0.1 * w[k]:
                        bad.append(f"{name} {k} {r[k]} against {w[k]}")
                if census(sys_) != (ref[p + "census_labels"].tolist(),
                                    ref[p + "census_counts"].tolist()):
                    bad.append(f"{name} census {census(sys_)}")
            if [x.tracked for x in sys_.trajectory] != \
                    ref[p + "tracked"][:n].tolist():
                bad.append(f"{name} tracked flags")
            d = max(float(np.abs(x.Tcw[:3, 3] - y[:3, 3]).max())
                    for x, y in zip(sys_.trajectory, ref[p + "rec_tcw"]))
            a = max(_rot_deg(x.Tcw, y)
                    for x, y in zip(sys_.trajectory, ref[p + "rec_tcw"]))
            if d > STUDY_REC_M or a > STUDY_REC_DEG:
                bad.append(f"{name} records {d:.6f} m {a:.4f} deg")
            gaps.append(([_centre(x.Tcw) for x in sys_.trajectory],
                         [_centre(y) for y in ref[p + "rec_tcw"][:n]]))
            print(f"ragged {name}{' (refinement skipped)' if fault else ''} "
                  f"[{card}]: {json.dumps(r)} (JAX CPU {json.dumps(w)}); "
                  f"records within {d * 1e3:.3f} mm / {a:.4f} deg",
                  flush=True)
        # what the refinement moves: the on arm's records less the off
        # arm's, against the JAX runs'
        (on, jon), (off, joff) = gaps
        m = misfit(np.subtract(on, off), np.subtract(jon, joff))
        print(f"ragged arms{' (refinement skipped)' if fault else ''} "
              f"[{card}]: on less off misfit by frame "
              f"{np.round(m, 4).tolist()}", flush=True)
        if np.median(m) > STUDY_SHIFT_RTOL:
            bad.append(f"on less off misfit median {np.median(m):.4f} "
                       f"(limit {STUDY_SHIFT_RTOL})")
        return bad, secs

    bad, secs = arms(STUDY_SEM_FRAMES)
    out["ragged"] = read_counts("ragged arms", 2 * STUDY_SEM_FRAMES)
    print(f"ragged arms [{card}]: {n_deg} masks degraded; "
          f"{2 * STUDY_SEM_FRAMES} frames in {secs:.1f} s", flush=True)
    if bad:
        fail("ragged arms: " + "; ".join(bad))
    bad, _ = arms(STUDY_SEM_FAULT_FRAMES, fault=True)
    out["ragged_fault"] = read_counts("ragged arms, the refinement skipped",
                                      2 * STUDY_SEM_FAULT_FRAMES)
    if not bad:
        fail("ragged arms: the refinement skipped passes every check")
    print(f"ragged arms, the refinement skipped [{card}]: misses {bad[:2]}",
          flush=True)
    return out


def studies_child_main(out_json: str):
    """The fourth process: the accuracy studies (phase_study_variants,
    phase_study_corridor, phase_study_semantic) on the card, the retention
    and pose-solver probes (phase_probe_retention, phase_probe_pose), the
    sharded GBA, then the kidnap with loop closing on
    (phase_kidnap_loop); the launches by
    phase, the phase seconds, the corridor's own events and orb_describe's
    row at the corridor's shapes written to out_json."""
    import torch
    from object_slam_tpu_torch.ops import build
    if not torch.cuda.is_available():
        fail("no CUDA device")
    build.load_all(KERNELS)
    card = card_line()
    by_phase = {}
    # the corridor's frames render beside the variants' runs
    rendering = render_corridor(corridor_path())
    var = phase_timed("study_variants", phase_study_variants, card)
    by_phase.update({f"study_variant_{k}": v for k, v in var.items()})
    cor, row, cor_events = phase_timed("study_corridor", phase_study_corridor,
                                       card, rendering)
    by_phase.update({f"study_corridor_{k}": v for k, v in cor.items()})
    sem = phase_timed("study_semantic", phase_study_semantic, card)
    by_phase.update({f"study_{k}": v for k, v in sem.items()})
    # the retention and pose-solver probes of slice 12
    by_phase.update(phase_timed("probe_retention", phase_probe_retention,
                                card))
    by_phase.update(phase_timed("probe_pose", phase_probe_pose, card))
    # the sharded GBA (10) runs here, beside the second process's KITTI
    # phases, for the time limit
    phase_timed("sharded_ba", phase_sharded_ba, card)
    # the kidnap with loop closing on (7b) runs here, beside the main
    # process's other phases, for the time limit
    by_phase["kidnap_loop"], _ = phase_timed("kidnap_loop",
                                             phase_kidnap_loop, card)
    with open(out_json, "w") as f:
        json.dump({"by_phase": by_phase, "phase_s": PHASE_S,
                   "corridor_events": cor_events,
                   "corridor_row": {k: row[k] for k in (
                       "max_abs_err", "ms", "device_ms", "plain_ms",
                       "bound_ms", "bound_by")}}, f)


# ---------------------------------------------------------------------------
# the tracking-retention probes (scripts/diag_*_torch.py of slice 12)
# ---------------------------------------------------------------------------

PROBES_REF = os.path.join(FIXTURES, "probes_vga.npz")
# the fixture's depths (make_reference.py PROBE_*_VGA, PROBE_*NOISE*)
# the depths run here, for the time limit: the first frames of the
# fixture's runs (30 / 12 TUM, 12 KITTI), held frame by frame
PROBE_RET_FRAMES, PROBE_LOC_FRAMES, PROBE_LOC_FAULT_FRAMES = 20, 8, 4
PROBE_KRET_FRAMES, PROBE_KITTI_FRAMES, PROBE_KITTI_FAULT_FRAMES = 12, 8, 8
PROBE_NOISE_RUNS, PROBE_LOC_NOISE_RUNS, PROBE_POSE_NOISE_RUNS = 6, 3, 8
# the retention probe at TUM VGA: the TUM checks' limits (records 2 mm /
# 0.1 deg) on its errors and map distances, 2 percentage points on the
# share of wrong matches, 5% on match counts and 2% on the map's points
# (the card's pyramid sums in another order than XLA:CPU, which moves a
# few keypoints), every other count exact; each beside 2x the spread of
# the reference's pinned one-ulp noise runs, whichever is wider
PROBE_RET_TOL = {"err_mm": 2.0, "dC_mm": 2.0, "motion.err_mm": 2.0,
                 "local.err_mm": 2.0, "map3d": 2.0, "rot_deg": 0.1,
                 "motion.wrong": 2.0, "local.wrong": 2.0}
PROBE_RET_RTOL = {"motion.n": 0.05, "local.n": 0.05, "pts": 0.02}
# the pose-solver probes: tests/test_torch_probes.py's limits, but for the
# replays' poses and median chi2: the card's LM sums in another order, and
# from the predicted pose of the reference's dump 1 it stops 0.07 mm from
# the reference's solution (median chi2 there 1.3% off; H100 80GB HBM3)
PROBE_POSE_ERR_MM = 0.02
PROBE_REPLAY_MM = 0.1
PROBE_REPLAY_TOL = {"init_T_pred": PROBE_REPLAY_MM,
                    "init_Tcw_local": PROBE_REPLAY_MM,
                    "init_T_gt": PROBE_REPLAY_MM,
                    "wrong_basin": PROBE_REPLAY_MM,
                    "right_basin": PROBE_REPLAY_MM, "recorded": 1e-6,
                    "cost_gt": 1e-6, "start_err_mm": 1e-6,
                    "steps": PROBE_REPLAY_MM}
PROBE_REPLAY_RTOL = {"cost_wrong.median_chi2": 0.02,
                     "cost_right.median_chi2": 0.02, "cost_wrong": 1e-3,
                     "cost_right": 1e-3}
PROBE_GN_RTOL = {"steps": 0.25}
# the KITTI probes: tests/test_torch_probes_kitti.py's limits (the frame
# build's counts 1% on the card, whose pyramid rounds otherwise; the
# drive's pose error 0.1 m, KITTI_OWN_ATE_M)
PROBE_KRET_RTOL = 0.01
PROBE_KITTI_TOL = {"err_m": 0.1}
PROBE_KITTI_RTOL = {"inl": 0.05, "kps": 0.01, "depth": 0.01, "close": 0.01}
PROBE_LREC_RTOL = {"close_vis": 0.05, "matched": 0.05}
PROBE_LREC_GATES = ("no_local", "frustum", "no_kp_radius", "level", "desc",
                    "lost", "level_would_pass_w2", "radius_would_pass_2x")
PROBE_TOTAL_RTOL = 0.1
PROBE_MCHAIN_TOL, PROBE_MCHAIN_RTOL, PROBE_MCHAIN_TOTAL_RTOL = 2.0, 0.05, 0.02


def probe_bands_module():
    sys.path.insert(0, FIXTURES)
    import probe_bands
    return probe_bands


def probe_misses(name, got, main, noise, strict=True, **kw):
    """probe_bands.misses of table got against the reference's table main
    and its noise runs' tables; printed; fatal when strict and anything
    misses. Returns the misses."""
    bad = probe_bands_module().misses(got, main, noise, **kw)
    print(f"probe {name}: {len(bad)} of {sum(v.size for v in main.values())}"
          f" numbers outside their bands"
          + ("" if not bad else ": " + "; ".join(
              f"{k} frame {i}: {g} against {w} (limit {lim})"
              for k, i, g, w, lim in bad[:12])), flush=True)
    if strict and bad:
        fail(f"probe {name}: {len(bad)} numbers outside their bands")
    return bad


def _first_frames(t, n):
    keep = t["f"] < n
    return {k: v[keep] for k, v in t.items()}


def phase_probe_retention(card, strict=True):
    """scripts/diag_retention_torch.py at TUM VGA (SlamConfig.tum_rgbd(),
    objects off) through its run() on the first PROBE_RET_FRAMES frames of
    its default 30-frame orbit of the room scene, OSLAM_DUMP's writer on
    (a frame past 20 mm is dumped in the reference's keys), each frame
    held to the reference's run (probes_vga.npz) with PROBE_RET_* beside
    its 6 pinned noise runs; then --loc-only on PROBE_LOC_FRAMES frames
    (the staged path each frame: the motion and local results differ)
    against the reference's and its 3 noise runs, and the same on
    PROBE_LOC_FAULT_FRAMES frames with debug_last's motion result replaced
    by the local one (faults.motion_snapshot_is_local), which must miss.
    One orb_describe per frame asserted in each run. Returns the launches
    by run."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    sys.path.insert(0, FIXTURES)
    import faults
    pb = probe_bands_module()
    dr = script_module("diag_retention_torch")
    ref = np.load(PROBES_REF)
    out = {}
    dump_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "probe_dumps")
    for name, loc, n, hook in (
            ("main", False, PROBE_RET_FRAMES, None),
            ("loc", True, PROBE_LOC_FRAMES, None),
            ("loc_fault", True, PROBE_LOC_FAULT_FRAMES,
             faults.motion_snapshot_is_local)):
        args = dr.parse_args(["--frames", str(n)]
                             + (["--loc-only"] if loc else []))
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = dr.run(SlamConfig.tum_rgbd(), args, device="cuda",
                     log=lambda s: None, on_system=hook,
                     dump_dir=dump_dir if name == "main" else "")
        wall = time.perf_counter() - t0
        out[f"retention_{name}"] = read_counts(f"probe retention {name}", n)
        run = "loc" if loc else "main"
        runs = ([f"ret_vga.locnoise{k}.recs"
                 for k in range(PROBE_LOC_NOISE_RUNS)] if loc else
                [f"ret_vga.noise{k}.recs" for k in range(PROBE_NOISE_RUNS)])
        print(f"probe retention {name} [{card}]: {json.dumps(res['summary'])}"
              f"; {wall / n * 1e3:.1f} ms/frame; dumps "
              f"{[os.path.basename(p) for p in res['dumps']]}", flush=True)
        bad = probe_misses(f"retention {name}", pb.table(res["frames"]),
                           _first_frames(pb.load(ref, f"ret_vga.{run}.recs"),
                                         n),
                           [_first_frames(pb.load(ref, r), n) for r in runs],
                           strict=strict and name != "loc_fault",
                           tol=PROBE_RET_TOL, rtol=PROBE_RET_RTOL)
        if name == "main":
            for p in res["dumps"]:
                with np.load(p) as d:
                    if set(d.files) != set(
                            k.split(".", 2)[2] for k in ref.files
                            if k.startswith("ret_vga.dump0.")):
                        fail(f"probe retention: dump {p} lacks the "
                             f"reference's keys")
        if name == "loc_fault" and not any(
                k.startswith("motion.") for k, *_ in bad):
            fail("probe retention: debug_last's motion result replaced by "
                 "the local one passes every check")
    return out


def phase_probe_pose(card, strict=True):
    """scripts/diag_poseopt_torch.py's 18 initializations on the card
    against the reference's rows and 8 one-ulp noise runs; then
    diag_replay_torch.py and diag_gnsteps_torch.py on the reference's two
    VGA dumps against the reference's replays of them; then the replays
    with pose_opt's chi2 gates exchanged (faults.exchange_pose_gates),
    which must miss. No frame is built: 0 launches asserted."""
    import torch
    sys.path.insert(0, FIXTURES)
    import faults
    pb = probe_bands_module()
    ref = np.load(PROBES_REF)
    po = script_module("diag_poseopt_torch")
    rp = script_module("diag_replay_torch")
    gn = script_module("diag_gnsteps_torch")
    zero_counts()
    t0 = time.perf_counter()
    res = po.run(device="cuda", log=lambda s: None)
    pose_s = time.perf_counter() - t0
    cols = ("dt_mm", "dr_deg", "err_mm", "n_inl")
    got = {c: np.asarray([r[c] for r in res["rows"]], np.float64)
           for c in cols}
    main = {c: ref["pose.rows"][:, i] for i, c in enumerate(cols)}
    noise = [{c: ref[f"pose.noise.{k}.rows"][:, i]
              for i, c in enumerate(cols)}
             for k in range(PROBE_POSE_NOISE_RUNS)]
    if res["n_valid"] != int(ref["pose.n_valid"]):
        fail(f"probe poseopt: {res['n_valid']} valid points, the reference "
             f"{int(ref['pose.n_valid'])}")
    print(f"probe poseopt [{card}]: 18 initializations in {pose_s:.2f} s; "
          f"errors {[round(r['err_mm'], 3) for r in res['rows']]} mm; "
          f"inliers {sorted(set(r['n_inl'] for r in res['rows']))}",
          flush=True)
    probe_misses("poseopt", got, main, noise, strict=strict,
                 tol={"err_mm": PROBE_POSE_ERR_MM})

    def dump(j):
        p = f"ret_vga.dump{j}."
        return {k[len(p):]: ref[k] for k in ref.files if k.startswith(p)}

    def replays(strict_now):
        bad = []
        for j in (0, 1):
            r = rp.run(dump(j), device="cuda", log=lambda s: None)
            bad += probe_misses(f"replay of dump {j}", pb.table([r]),
                                pb.load(ref, f"replay{j}"), [],
                                strict=strict_now, tol=PROBE_REPLAY_TOL,
                                rtol=PROBE_REPLAY_RTOL)
        return bad
    replays(strict)
    for j in (0, 1):
        g = pb.table([gn.run(dump(j), device="cuda", log=lambda s: None)])
        want = pb.load(ref, f"gnsteps{j}")
        probe_misses(f"gnsteps of dump {j}", g,
                     {k: v for k, v in want.items()
                      if not k.endswith("step_mm")}, [],
                     strict=strict, tol=PROBE_REPLAY_TOL, rtol=PROBE_GN_RTOL)
        ends = [k for k in want if k.startswith(tuple(
            f"steps[{i}]." for i in range(9, 40, 10)))]
        probe_misses(f"gnsteps of dump {j}, the rounds' ends", g,
                     {k: want[k] for k in ends}, [], strict=strict,
                     tol={"steps": PROBE_REPLAY_MM})
    undo = faults.exchange_pose_gates()
    try:
        bad = replays(False)
    finally:
        undo()
    if not bad:
        fail("probe replays: pose_opt's gates exchanged pass every check")
    torch.cuda.synchronize()
    return {"pose_probes": read_counts("pose probes", 0)}


def probe_kf_replay(kf_frames, decisions):
    """An on_system hook giving each fused frame the reference run's
    keyframe decision (frame in kf_frames), its own kept in decisions."""
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


def hold_describe_frame(seq, index, card):
    """One orb_describe launch at a KITTI probe frame's own shapes (the
    pair's keypoints as the extractor detects them, both images in one
    launch) against orb_describe_ref: phase_describe's tolerances."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.png import read_png
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    cfg = SlamConfig.kitti_stereo()
    ex = OrbExtractor(cfg, device="cuda")
    fr = kitti.load_sequence(seq)[index]
    levels, corners = [], []
    for path in (fr.left_path, fr.right_path):
        img = torch.from_numpy(read_png(path).astype(np.float32)).cuda()
        lv, _, cy, cx, counts = ex._detect(img)
        off, start = len(levels), 0
        for l, n in counts:
            corners.append((l + off, cy[start:start + n],
                            cx[start:start + n]))
            start += n
        levels += lv
    half = len(corners) // 2
    return phase_describe(ex, levels, corners,
                          tag=f"KITTI probe frame {index}",
                          halves=(corners[:half], corners[half:]),
                          timed=False)


def phase_probe_kitti(card, poses, frames, strict=True):
    """The four KITTI probes at full width on a KITTI directory of the 24
    street frames (datasets/kitti.py::write_sequence, the port's PNG
    writer), each through its run() over the directory's first frames
    (PROBE_KRET_FRAMES, PROBE_KITTI_FRAMES) and held frame by frame (and
    in its totals over those frames) to the reference's run
    (probes_vga.npz) beside its 6 pinned noise runs: diag_kitti_retention_torch.py (the frame build
    alone), diag_kitti_torch.py (objects on, async),
    diag_local_recovery_torch.py and diag_motion_chain_torch.py (the system
    as the scripts make it), the three drives with the reference run's
    keyframe decisions replayed (their own printed where they part); one
    orb_describe per pair asserted in each; one launch at a probe frame's
    shapes held to its plain version; then the motion chain with the level
    window made symmetric (faults.symmetric_motion_level_window) on
    PROBE_KITTI_FAULT_FRAMES frames, which must miss."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    sys.path.insert(0, FIXTURES)
    import faults
    pb = probe_bands_module()
    ref = np.load(PROBES_REF)
    seq = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "probe_kitti")
    t0 = time.perf_counter()
    kitti.write_sequence(seq, poses, frames)
    print(f"probe KITTI directory: {len(frames)} pairs written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kcfg = SlamConfig.kitti_stereo()
    n = PROBE_KITTI_FRAMES
    out = {}

    def tables(name, tab="recs"):
        return (pb.load(ref, f"{name}.main.{tab}"),
                [pb.load(ref, f"{name}.noise{k}.{tab}")
                 for k in range(PROBE_NOISE_RUNS)])

    def run(key, script, n_frames, kfs=None, **kw):
        mod = script_module(script)
        args = mod.parse_args(["--seq", seq, "--frames", str(n_frames)])
        decisions = {}
        if kfs is not None:
            kw["on_system"] = probe_kf_replay(kfs, decisions)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = mod.run(kcfg, args, device="cuda", log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
        out[f"probe_{key}"] = read_counts(f"probe {key}", n_frames)
        own = sorted(f for f, (d, _) in decisions.items() if d)
        differ = [f for f in sorted(decisions)
                  if decisions[f][0] != (f in set(int(x) for x in kfs))] \
            if kfs is not None else []
        print(f"probe {key} [{card}]: {n_frames} frames, "
              f"{wall / n_frames * 1e3:.1f} ms/frame"
              + ("" if kfs is None else
                 f"; keyframes replayed {[int(x) for x in kfs]}, its own "
                 f"decisions {own}, first parting at "
                 f"{differ[0] if differ else None} "
                 f"({decisions[differ[0]][1] if differ else ''} inliers)"),
              flush=True)
        return res

    res = run("kitti_retention", "diag_kitti_retention_torch",
              PROBE_KRET_FRAMES)
    main, nz = tables("kret_vga")
    probe_misses("kitti_retention", pb.table(res["frames"]), main, nz,
                 strict=strict, rtol={k: PROBE_KRET_RTOL for k in main})
    main, nz = tables("kret_vga", "totals")
    probe_misses("kitti_retention totals",
                 pb.table([dict(res["totals"], jumps=res["jumps"])]), main,
                 nz, strict=strict, rtol={k: PROBE_KRET_RTOL for k in main},
                 tol={k: 3.0 for k in main if k.startswith("jumps")})
    def first(name, n_frames):
        main, nz = tables(name)
        return (_first_frames(main, n_frames),
                [_first_frames(t, n_frames) for t in nz])

    def sums(t):
        return {k: np.asarray([np.nansum(v)]) for k, v in t.items()
                if k != "f"}

    res = run("kitti", "diag_kitti_torch", n, ref["kitti_vga.main.kf_frames"])
    probe_misses("kitti", pb.table(res["frames"]), *first("kitti_vga", n),
                 strict=strict, tol=PROBE_KITTI_TOL, rtol=PROBE_KITTI_RTOL)
    res = run("local_recovery", "diag_local_recovery_torch", n,
              ref["lrec_vga.main.kf_frames"])
    got = pb.table(res["per_frame"])
    main, nz = first("lrec_vga", n)
    probe_misses("local_recovery", got, main, nz, strict=strict,
                 rtol=PROBE_LREC_RTOL, skip=PROBE_LREC_GATES)
    sm = sums(main)
    probe_misses("local_recovery totals", sums(got), sm,
                 [sums(t) for t in nz], strict=strict,
                 rtol={k: PROBE_TOTAL_RTOL for k in sm})

    def mchain_misses(res, n_frames, strict_now):
        main, nz = first("mchain_vga", n_frames)
        got = pb.table(res["per_frame"])
        bad = probe_misses(f"motion_chain ({n_frames} frames)", got, main,
                           nz, strict=strict_now,
                           tol={k: PROBE_MCHAIN_TOL for k in main if k != "f"},
                           rtol={k: PROBE_MCHAIN_RTOL for k in main})
        sm = sums(main)
        bad += probe_misses(f"motion_chain totals ({n_frames} frames)",
                            sums(got), sm, [sums(t) for t in nz],
                            strict=strict_now,
                            tol={k: PROBE_MCHAIN_TOL for k in sm},
                            rtol={k: PROBE_MCHAIN_TOTAL_RTOL for k in sm})
        return bad
    kfs = ref["mchain_vga.main.kf_frames"]
    mchain_misses(run("motion_chain", "diag_motion_chain_torch", n, kfs), n,
                  strict)
    row = hold_describe_frame(seq, n - 1, card)
    undo = faults.symmetric_motion_level_window()
    try:
        bad = mchain_misses(run("motion_chain_fault",
                                "diag_motion_chain_torch",
                                PROBE_KITTI_FAULT_FRAMES, kfs),
                            PROBE_KITTI_FAULT_FRAMES, False)
    finally:
        undo()
    if not any(k.startswith(("matched", "inlier")) for k, *_ in bad):
        fail("probe motion_chain: the symmetric level window passes every "
             "check on the matches and inliers")
    return out, {k: row[k] for k in ("max_abs_err", "bound_ms", "bound_by")}

# ---------------------------------------------------------------------------
# the single-card stage timers of scripts/*_torch.py (slice 13):
# diag_fullpipe in the main process after its other phases,
# diag_ba_profile at the end of the second, diag_kitti_stages in the third
# after the battery; each held by what its timed calls compute to the
# reference's runs in stages.npz
# ---------------------------------------------------------------------------

STAGES_REF = os.path.join(FIXTURES, "stages.npz")
STAGE_FULLPIPE_FRAMES = 16
STAGE_KITTI_FRAMES = 12
STAGE_KITTI_REPS = 5
STAGE_BA_SIZE = (40, 2048, 8192)    # diag_ba_profile.py's defaults


def stage_bands_module():
    if FIXTURES not in sys.path:
        sys.path.insert(0, FIXTURES)
    import stage_bands
    return stage_bands


def phase_stage_fullpipe(card, frames, sems):
    """scripts/diag_fullpipe_torch.py at TUM VGA on the first
    STAGE_FULLPIPE_FRAMES of this process's renders (bench.py's room;
    depth and rgb as rendered here, in float32, then u16 / u8 as the
    script makes them), held to the reference's run of the same frames
    (stages.npz "fullpipe_vga", stage_bands.fullpipe_misses: the bytes
    line, flags and keyframes exactly, poses within 2 mm / 0.1 deg, the
    reference's profiler spans with their calls), one orb_describe per
    frame; then a run one frame past the script's warm-up with the
    semantic arrays counted bit-packed (faults.packed_semantic_bytes),
    which must miss the bytes line.
    Returns the launches and the medians."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    sys.path.insert(0, FIXTURES)
    import faults
    sb = stage_bands_module()
    fp = script_module("diag_fullpipe_torch")
    fx = np.load(STAGES_REF)
    cfg = SlamConfig.tum_rgbd()
    n = STAGE_FULLPIPE_FRAMES
    sums = [float(np.sum(g, dtype=np.float64)) for g, _, _ in frames[:n]]
    if not np.array_equal(sums, fx["fullpipe_vga.main.gray_sums"]):
        fail("stage fullpipe: the rendered frames differ from the "
             "reference run's")
    inputs = [fp.to_inputs(cfg, d, rgb, sems[i])
              for i, (_, d, rgb) in enumerate(frames[:n])]
    lines = []
    torch.cuda.synchronize()
    zero_counts()
    res = fp.run(cfg, n, device="cuda", frames=inputs, log=lines.append)
    launches = read_counts("stage fullpipe", n)
    bad = sb.fullpipe_misses(res, fx, "vga")
    undo = faults.packed_semantic_bytes(fp)
    try:
        res_f = fp.run(cfg, fp.WARMUP + 1, device="cuda", frames=inputs,
                       log=lambda s: None)
    finally:
        undo()
    fault = sb.fullpipe_misses(res_f, fx, "vga")
    print(f"stage fullpipe [{card}]: diag_fullpipe_torch.py, {n} TUM-VGA "
          f"frames:\n" + "\n".join(lines) + f"\n  held to the reference's "
          f"run: {len(bad)} misses {bad[:4]}; keyframes {res['kf_frames']}; "
          f"launches {launches}; the semantic arrays counted bit-packed: "
          f"{[m for m in fault if m.startswith('bytes')]}", flush=True)
    if bad:
        fail("stage fullpipe: " + "; ".join(bad[:4]))
    if not any(m.startswith("bytes") for m in fault):
        fail("stage fullpipe: the semantic arrays counted bit-packed pass "
             "the bytes line")
    return launches, {"build_median_ms": res["build_median_ms"],
                      "track_median_ms": res["track_median_ms"]}


def phase_stage_ba_profile(card):
    """scripts/diag_ba_profile_torch.py at its own size (40 keyframes x
    2048 observations, 8192 points) on the card: the seven variants, each
    ms per call over 3 calls after a warm call, its kernel launches and
    its copies and sets per call (--print-launches), each result held to
    the reference's (stages.npz "ba_full": poses, cost, the points' step
    quantiles and sum within stage_bands' bands of its 4 one-ulp noise
    runs), the
    scatter form also against the blocked and the slot forms (the card's
    index_add_ adds atomically, in no fixed order); no port kernel
    launched; then the scatter form with its per-point sums over obs_kf
    (faults.scatter_points_over_keyframes), which must miss. Returns
    {variant: {"ms", "launches", "copies"}}."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    sys.path.insert(0, FIXTURES)
    import faults
    sb = stage_bands_module()
    prof = script_module("diag_ba_profile_torch")
    fx = np.load(STAGES_REF)
    cfg = SlamConfig.kitti_stereo()
    names = [v[0] for v in prof.VARIANTS]
    lines = []
    torch.cuda.synchronize()
    zero_counts()
    runs = prof.run(cfg, *STAGE_BA_SIZE, device="cuda", launches=True,
                    log=lines.append)
    if counts_now() != {"extract_patches": 0, "orb_describe": 0}:
        fail(f"stage ba_profile: kernel launches {counts_now()}")
    arrays, slot = runs["problem"]
    if sb.problem_hash(arrays, slot) != str(fx["ba_full.main.problem_hash"]):
        fail("stage ba_profile: the problem differs from the reference "
             "script's")

    def record(r):
        return sb.ba_record(arrays["pt_xyz"], r["kf_pose"].cpu().numpy(),
                            r["pt_xyz"].cpu().numpy(), r["cost"])
    recs = {name: record(runs[name]) for name in names}
    bad = {name: sb.ba_misses(recs[name], fx, "full", i)
           for i, name in enumerate(names)}
    pair = {names[o]: sb.ba_pair_misses(recs[names[0]], recs[names[o]], fx,
                                        "full", 0) for o in (1, 5)}
    undo = faults.scatter_points_over_keyframes()
    try:
        fr = prof.run(cfg, *STAGE_BA_SIZE, device="cuda", reps=0,
                      variants=[names[0]], log=lambda s: None)
    finally:
        undo()
    fault = sb.ba_misses(record(fr[names[0]]), fx, "full", 0)
    print(f"stage ba_profile [{card}]: diag_ba_profile_torch.py "
          f"--print-launches, Wtot {STAGE_BA_SIZE[0]} x N "
          f"{STAGE_BA_SIZE[1]}, Lp {STAGE_BA_SIZE[2]} "
          f"({int(arrays['obs_valid'].sum())} live observations):\n"
          + "\n".join(lines) + "\n  held to the reference's runs: "
          + ", ".join(f"{k.split()[0]} {k.split()[1]} {k.split()[2]}: "
                      f"{len(v)} misses" for k, v in bad.items())
          + "; scatter against "
          + ", ".join(f"{k.split()[0]}: {len(v)} misses"
                      for k, v in pair.items())
          + f"; cost {recs[names[0]]['cost'][0]:.4f} against the "
          f"reference's {float(fx['ba_full.main.v0.cost'][0]):.4f}; the "
          f"per-point sums over obs_kf: cost "
          f"{float(fr[names[0]]['cost']):.4f}, {len(fault)} misses",
          flush=True)
    misses = [f"{k}: {v[:2]}" for k, v in {**bad, **pair}.items() if v]
    if misses:
        fail("stage ba_profile: " + "; ".join(misses))
    if not any(k == "cost" for k, *_ in fault):
        fail("stage ba_profile: the per-point sums over obs_kf pass the "
             "cost's band")
    return {name: {k: runs[name][k] for k in ("ms", "launches", "copies")}
            for name in names}


def phase_stage_kitti(card, root, keep=False):
    """scripts/diag_kitti_stages_torch.py at KITTI width on the first
    STAGE_KITTI_FRAMES frames of the directory make_synth_kitti_torch.py
    wrote (phase_synth_dirs), the reference run's keyframe decisions
    replayed (its own printed where they part), one orb_describe per pair;
    the eleven stages each over STAGE_KITTI_REPS calls after a warm call
    (the frame build's orb_describe launches counted apart), held to the
    reference's run (stages.npz "kitti_vga": the map's census and every
    stage's counts, exact where its 4 pinned one-ulp noise runs agree,
    else within 2x their spread, stage_bands' floors), the map left as
    the stages found it; then two stages on the map from before the 12th
    frame (faults.stage_map_before_last_frame), and the fused stage with
    the keyframe decision negated (faults.inverted_keyframe_decision),
    each of which must miss. Returns the drive's launches and {stage:
    ms}, and with keep the drive's state too (its system not shut down:
    phase_trace_stage traces on it)."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import kitti
    sys.path.insert(0, FIXTURES)
    import faults
    sb = stage_bands_module()
    st = script_module("diag_kitti_stages_torch")
    fx = np.load(STAGES_REF)
    cfg = SlamConfig.kitti_stereo()
    seq = os.path.join(root, "kitti")
    n = STAGE_KITTI_FRAMES
    gl = kitti.load_frame_arrays(kitti.load_sequence(seq)[n - 1])[0]
    if float(np.sum(gl, dtype=np.float64)) != \
            float(fx["kitti_vga.main.gray_sum"]):
        fail("stage kitti: the directory's frames differ from the "
             "reference run's")
    kfs = [int(x) for x in fx["kitti_vga.main.kf_frames"]]
    hook, swap = faults.stage_map_before_last_frame(n)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    state = st.drive(cfg, seq, "cuda", n, kfs, hook)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    try:
        launches = read_counts("stage kitti drive", n)
        lines = []
        zero_counts()
        res = st.time_stages(state, reps=STAGE_KITTI_REPS, log=lines.append)
        stage_launches = counts_now()
        res_f = st.time_stages(swap(state), reps=0,
                               stages=("covisibility", "cull_points"),
                               log=lambda s: None)
        undo = faults.inverted_keyframe_decision()
        try:
            res_kf = st.time_stages(state, reps=0, stages=("fused",),
                                    log=lambda s: None)
        finally:
            undo()
    finally:
        if not keep:
            state["sys"].shutdown()
    dec = state["decisions"]
    differ = [f for f in sorted(dec) if dec[f][0] != (f in set(kfs))]
    bad = sb.kitti_misses(res, fx, "vga")
    fault = [k for k, *_ in sb.kitti_misses(res_f, fx, "vga")]
    fault_kf = [k for k, *_ in sb.kitti_misses(res_kf, fx, "vga")]
    print(f"stage kitti [{card}]: diag_kitti_stages_torch.py, {n} frames of "
          f"{seq} in {drive_s:.1f} s, keyframes replayed {kfs} (its own "
          f"decisions part first at "
          f"{differ[0] if differ else None}"
          f"{f', {dec[differ[0]][1]} inliers' if differ else ''}); "
          f"{STAGE_KITTI_REPS} calls per stage after a warm call:\n"
          + "\n".join(lines) + f"\n  map {res['map']}; held to the "
          f"reference's run: {len(bad)} misses {bad[:4]}; the map "
          f"unchanged by the stages {res['map_unchanged']}; drive launches "
          f"{launches}, the stages' {stage_launches}; on the map before "
          f"frame {n}: misses {fault[:4]}; the keyframe decision negated: "
          f"misses {fault_kf[:4]}", flush=True)
    want = {"extract_patches": 0, "orb_describe": STAGE_KITTI_REPS + 1}
    if stage_launches != want:
        fail(f"stage kitti: the stages launched {stage_launches}, expected "
             f"{want}")
    if bad:
        fail(f"stage kitti: {bad[:4]}")
    if not res["map_unchanged"]:
        fail("stage kitti: a stage changed the map it was given")
    if not any(k.startswith("map.") for k in fault):
        fail("stage kitti: the stages on the map before the last frame pass")
    if not {"fused.need_kf", "fused.need_kf_hard"} <= set(fault_kf):
        fail("stage kitti: the fused stage with the keyframe decision "
             "negated passes")
    ms = {k: v["ms"] for k, v in res["stages"].items()}
    return (launches, ms, state) if keep else (launches, ms)



# ---------------------------------------------------------------------------
# the multi-device scripts and the op-level stage trace (slice 14)
# ---------------------------------------------------------------------------

ASYNC_DEVICE_REF = os.path.join(FIXTURES, "async_device.npz")
# scripts/ab_async_device_torch.py's arms on the first ASYNC_DEVICE_FRAMES
# of its 120-frame circuit (a depth cut for the time limit: at 40 frames,
# the fault and the unpinned run at 16, the script read 1135 s; the 120
# frames ran alone on the card, PERF.md section 5); the second-device
# branch on the same frames; the planted fault and the unpinned run on
# the first ASYNC_DEVICE_SHORT (each held to the reference's run of those
# frames)
ASYNC_DEVICE_FRAMES = 16
ASYNC_DEVICE_SHORT = 8
# scripts/bench_ba_scaling_torch.py at the reference's size with
# SCALING_REPS timed runs per world size (cut from its 5)
SCALING_REPS = 2
TRACE_STAGES = ("fused", "mapping", "build")
TRACE_ATTEMPTS = 3


def multidevice_bands_module():
    if FIXTURES not in sys.path:
        sys.path.insert(0, FIXTURES)
    import multidevice_bands
    return multidevice_bands


def phase_async_device(card):
    """scripts/ab_async_device_torch.py at --scale 2 (320x240, 500
    features, objects on) on the first ASYNC_DEVICE_FRAMES frames of its
    circuit: one orb_describe launch at the circuit's shapes (frame 0's
    detected keypoints) held to its plain version (phase_describe's
    tolerance); sync, then async (a side stream of this card; cuda:1 with
    a second card), ready() pinned to "a pass is pending", each held to
    the JAX CPU run of the same frames (async_device.npz, its async pass
    on a second XLA device; multidevice_bands.arm_checks: flags, keyframe
    frames, lags, dispatches and merges as a recorded run has them,
    records, ATE and points within 2x its one-ulp noise spread or the
    floors); the async arm again through _AsyncMapping's second-device
    branch with cuda:0 on both sides (the copies made), held the same; on
    the first ASYNC_DEVICE_SHORT frames the merge throwing the pass's
    result away (faults.drop_async_result), which must miss, and one
    unpinned async run, printed. One orb_describe per frame asserted in
    every run. Returns (launches by run, orb_describe's row at these
    shapes, the runs' JSON)."""
    import contextlib
    import torch
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    sys.path.insert(0, FIXTURES)
    import faults
    mb = multidevice_bands_module()
    ab = script_module("ab_async_device_torch")
    cfg = script_module("ab_deviations_torch").build_cfg(2)
    args = ab.parse_args(["--device", "cuda"])
    fx = np.load(ASYNC_DEVICE_REF)
    n, short = ASYNC_DEVICE_FRAMES, ASYNC_DEVICE_SHORT
    t0 = time.perf_counter()
    poses, frames, sems = ab.inputs(cfg, args, n)
    render_s = time.perf_counter() - t0
    sums = [float(np.sum(g, dtype=np.float64)) for g, _, _, _ in frames]
    if not np.allclose(sums, fx[f"{n}.gray_sum"], rtol=1e-12, atol=0):
        fail("async device: the rendered frames differ from the reference "
             "run's")
    ex = OrbExtractor(cfg, device="cuda")
    img = torch.from_numpy(frames[0][0].astype(np.float32)).cuda()
    levels, _, cy, cx, counts = ex._detect(img)
    corners, start = [], 0
    for l, k in counts:
        corners.append((l, cy[start:start + k], cx[start:start + k]))
        start += k
    row = phase_describe(ex, levels, corners, tag="ab circuit 320x240",
                         timed=False)
    two = torch.cuda.device_count() > 1
    placement = {"sync": "cuda:0 inline",
                 "async_dev1": "cuda:1" if two else "cuda:0 side stream",
                 "async_cross": "cuda:0 (copied)"}
    launches, out, bad = {}, {}, []

    def arm(name, flag, k, on_system=None, pinned=True):
        torch.cuda.synchronize()
        zero_counts()
        with ab.pinned_ready() if pinned else contextlib.nullcontext():
            res, det = ab.run_arm(cfg, poses[:k], frames[:k], sems[:k],
                                  flag, "cuda", on_system)
        torch.cuda.synchronize()
        launches[name] = read_counts(f"async device {name}", k)
        out[name] = res
        return res, det

    def held(name, ref_arm, k, res, det):
        checks = mb.arm_checks(fx, k, ref_arm, res, det)
        print(f"async device {name} [{card}]: {json.dumps(res)}; keyframes "
              f"at {det['inserts']}; " + "; ".join(
                  f"{w} {g if not isinstance(g, list) else ''} "
                  f"({'held' if ok else 'missed'}, limit {lim})"
                  for w, g, _, lim, ok in checks), flush=True)
        return mb.misses(checks)

    for name, flag in ab.ARMS:
        res, det = arm(name, flag, n)
        bad += [f"{name}: {m}" for m in held(name, name, n, res, det)]
    res, det = arm("async_cross", True, n, ab.second_device)
    bad += [f"second-device branch: {m}"
            for m in held("async_cross", "async_dev1", n, res, det)]
    for name, res in out.items():
        want_dev = "dev1" if name == "async_dev1" and two else "dev0"
        if (res["mapping_placement"], res["mapping_device"]) != (
                placement[name], want_dev):
            bad.append(f"{name}: mapping on {res['mapping_placement']} / "
                       f"{res['mapping_device']}, expected "
                       f"{placement[name]} / {want_dev}")
    res, det = arm("async_fault", True, short, faults.drop_async_result)
    caught = mb.misses(mb.arm_checks(fx, short, "async_dev1", res, det))
    res, _ = arm("async_unpinned", True, short, pinned=False)
    print(f"async device [{card}]: {n} frames rendered in {render_s:.1f} s; "
          f"the pass's result dropped at the merge misses {caught[:4]}; "
          f"unpinned async over {short} frames {json.dumps(res)}",
          flush=True)
    if bad:
        fail("async device: " + "; ".join(bad))
    if not caught:
        fail("async device: the merge that drops the pass's result passes "
             "every check")
    return launches, row, out


def phase_ba_scaling(card):
    """scripts/bench_ba_scaling_torch.py at the reference's size (64
    keyframes, 8192 points, 131,072 observations, 10 iterations) with
    SCALING_REPS timed runs after a warm-up: NCCL at the card count (world
    size 1 in this process), then 2 gloo ranks on cuda:0 (their rate
    printed against NCCL world size 1's); every rank bit-equal to rank 0
    and each world size within the
    BA band (multidevice_bands.BA_POSE_TOL / BA_POINT_TOL) of the
    one-process global_ba on the same problem; rank 1 without the
    per-point all-reduce (faults.skip_point_reduce) at world size 2 must
    miss. Prints the script's JSON lines; returns them."""
    import torch
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.solvers.ba import global_ba
    sys.path.insert(0, FIXTURES)
    import faults
    mb = multidevice_bands_module()
    bsc = script_module("bench_ba_scaling_torch")
    args = bsc.parse_args(["--reps", str(SCALING_REPS)])
    K, arrays = bsc.problem(args.kf, args.pts)
    prob = interop.ba_problem_from_numpy(arrays, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kf, pt = global_ba(K, prob, args.iters, block_n=args.pts // 4)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    single = {"kf_pose": kf.cpu().numpy(), "pt_xyz": pt.cpu().numpy()}
    lines, bad = [], []
    log = []
    for dev, sizes in (("cuda", None), ("cuda:0", [2])):
        a = bsc.parse_args(["--reps", str(SCALING_REPS), "--device", dev])
        got, results = bsc.run(a, sizes=sizes, log=log.append)
        lines += got
        for world, outs in results.items():
            checks = mb.scaling_checks(outs, single, tag="against the "
                                       "one-process global_ba")
            log.append(f"  {dev} x{world}: " + "; ".join(
                f"{c[0]} {c[1]} (limit {c[2]})" for c in checks))
            bad += [f"{dev} x{world}: {c[0]} {c[1]} (limit {c[2]})"
                    for c in checks if not c[3]]
    a = bsc.parse_args(["--reps", "1", "--device", "cuda:0"])
    _, fres = bsc.run(a, sizes=[2], setup=faults.skip_point_reduce,
                      log=lambda s: None)
    caught = [c[0] for c in mb.scaling_checks(fres[2], single)
              if not c[3]]
    nccl1 = lines[0]["ba_iters_per_s"]
    print(f"BA scaling [{card}]: one-process global_ba {single_ms:.1f} ms; "
          + "\n".join(log) + f"\n  gloo x2 on one card against NCCL x1: "
          f"efficiency {lines[-1]['ba_iters_per_s'] / (2 * nccl1):.3f}"
          f"\n  rank 1 without the point all-reduce misses {caught}",
          flush=True)
    if bad:
        fail("BA scaling: " + "; ".join(bad))
    if not caught:
        fail("BA scaling: a rank without the point all-reduce passes")
    return lines


def phase_trace_stage(card, state):
    """scripts/diag_trace_stage_torch.py's three stages (fused, mapping,
    build) on the KITTI stage timer's drive (phase_stage_kitti's 12
    frames), the mapping flushed as the script does: each stage warmed
    once and traced once under torch.profiler into build/trace_stage/
    <stage> (a trace holding no kernel event is taken again, up to
    TRACE_ATTEMPTS times), its top rows printed through
    prof_ops_torch.top_ops; the build stage's rows list orb_describe's
    kernel with one launch per traced call; every stage's summed kernel ms
    at most the traced call's wall ms. Returns {stage: {"wall_ms",
    "kernel_ms", "kernels", "top"}}."""
    import shutil
    ts = script_module("diag_trace_stage_torch")
    po = script_module("prof_ops_torch")
    st = ts.flushed(state)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "trace_stage")
    out, bad = {}, []
    for stage in TRACE_STAGES:
        d = os.path.join(root, stage)
        for attempt in range(TRACE_ATTEMPTS):
            shutil.rmtree(d, ignore_errors=True)
            wall_ms = ts.trace_stage(st, stage, d)
            if any(e.get("cat") == "kernel" for e in
                   po.load_events(po.newest_trace(d))):
                break
        else:
            fail(f"trace stage {stage}: {TRACE_ATTEMPTS} traces without a "
                 f"kernel event")
        rows = po.top_ops(d, None)
        kernel_ms = sum(r[0] for r in rows)
        out[stage] = {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
                      "kernels": sum(r[1] for r in rows),
                      "attempts": attempt + 1, "top": rows[:10]}
        lines = []
        po.print_rows(rows[:10], lines.append)
        print(f"trace stage {stage} [{card}]: one call {wall_ms:.1f} ms, "
              f"kernels {kernel_ms:.3f} ms over {out[stage]['kernels']} "
              f"launches of {len(rows)} kernels; top 10:\n"
              + "\n".join(lines), flush=True)
        if kernel_ms > wall_ms:
            bad.append(f"{stage}: kernels {kernel_ms} ms > wall {wall_ms}")
        if stage == "build":
            desc = [r for r in rows if "orb_describe_kernel" in r[2]]
            if len(desc) != 1 or desc[0][1] != 1:
                bad.append(f"build: orb_describe rows {desc}, expected one "
                           f"launch")
    if bad:
        fail("trace stage: " + "; ".join(bad))
    return out


PHASE_S = {}
MONO_ARG = "--mono-phases"
MULTI_ARG = "--multidevice-phases"


def kitti_phases(by_phase, card):
    """KITTI stereo at full width (phase 8 and 9): the render, orb_describe
    at the KITTI shapes, one mapping pass stage by stage, inline then async
    mapping each with the reference's keyframe decisions replayed and with
    its own, the planted faults, the object drive, the driver. Returns
    orb_describe's KITTI-shape numbers."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import render_street
    kcfg = SlamConfig.kitti_stereo()
    kitti_poses, kitti_frames, render_s = render_street(kcfg, KITTI_FRAMES)
    ref = np.load(KITTI_REF)
    for key, side in (("gray_sum", 0), ("gray_r_sum", 1)):
        sums = [float(np.sum(f[side], dtype=np.float64))
                for f in kitti_frames]
        if not np.allclose(sums, ref[key], rtol=1e-12, atol=0):
            fail("KITTI: the rendered frames differ from the reference run's")
    print(f"rendered {KITTI_FRAMES} KITTI stereo pairs (1241x376) in "
          f"{render_s:.1f} s with a pool of "
          f"{min(os.cpu_count() or 1, 8)} processes", flush=True)
    # orb_describe at the KITTI shapes: the first pair, 2048 keypoints
    # over 8 levels per image, both images in one launch
    kex, klevels, kcorners = main_path_inputs(
        kcfg, kitti_frames[0][0].astype(np.float32))
    _, rlevels, rcorners = main_path_inputs(
        kcfg, kitti_frames[0][1].astype(np.float32))
    rcorners = [(l + len(klevels), ys, xs) for l, ys, xs in rcorners]
    kitti_row = phase_describe(kex, klevels + rlevels, kcorners + rcorners,
                               tag="KITTI pair", halves=(kcorners, rcorners))
    phase_timed("kitti_pass", phase_kitti_pass, card)
    kitti_ms = {}
    for mode in ("sync", "async"):
        for replay in (True, False):
            key = f"kitti_{mode}_" + ("replay" if replay else "own")
            by_phase[key], kitti_ms[key] = phase_timed(
                key, phase_kitti, kitti_poses, kitti_frames, card,
                mode == "async", replay, witness=KITTI_WITNESS_KFS[mode])
    phase_timed("kitti_controls", phase_kitti_controls, kitti_poses,
                kitti_frames, card)
    by_phase["kitti_objects"] = phase_timed("kitti_objects",
                                            phase_kitti_objects, card)
    print(f"KITTI [{card}]: ms/frame median / mean, own decisions: sync "
          f"{kitti_ms['kitti_sync_own'][0]:.3f} / "
          f"{kitti_ms['kitti_sync_own'][1]:.3f}, async "
          f"{kitti_ms['kitti_async_own'][0]:.3f} / "
          f"{kitti_ms['kitti_async_own'][1]:.3f}; replay: sync "
          f"{kitti_ms['kitti_sync_replay'][0]:.3f} / "
          f"{kitti_ms['kitti_sync_replay'][1]:.3f}, async "
          f"{kitti_ms['kitti_async_replay'][0]:.3f} / "
          f"{kitti_ms['kitti_async_replay'][1]:.3f}", flush=True)
    # the driver (its prefetcher, async mapping), then its directory
    # decoded by the prefetcher against the PNG reader
    by_phase["kitti_driver"] = phase_timed(
        "kitti_driver", phase_kitti_driver, kitti_poses, kitti_frames, card)
    phase_timed("kitti_prefetch", phase_kitti_prefetch, card)
    # the KITTI retention probes of slice 12 on these frames
    probes, probe_row = phase_timed("probe_kitti", phase_probe_kitti, card,
                                    kitti_poses, kitti_frames)
    by_phase.update(probes)
    return dict({k: kitti_row[k] for k in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "two_launches_ms", "two_launches_device_ms")},
        probe_frame=probe_row)


def mono_child_main(out_json: str):
    """The second process: mono_phases, batched tracking, kitti_phases,
    then the BA profile (phase_stage_ba_profile), on the same card; its
    results (the launches by phase, the phase seconds, the mono, batched
    and BA profile ms, orb_describe's KITTI-shape numbers) written to
    out_json. It renders its own frames for the
    checkpoint and batched phases."""
    import torch
    from object_slam_tpu_torch.ops import build
    if not torch.cuda.is_available():
        fail("no CUDA device")
    build.load_all(KERNELS)
    card = card_line()
    _, frames, sems = render(tum_cfg(), CKPT_FRAMES)
    by_phase = {}
    mono_ms, init_ms = mono_phases(by_phase, card, frames, sems)
    by_phase["batched"], batched_ms = phase_timed("batched", phase_batched,
                                                  card, frames)
    kitti_row = kitti_phases(by_phase, card)
    # the BA profile of slice 13: this process ends first
    ba_ms = phase_timed("stage_ba_profile", phase_stage_ba_profile, card)
    with open(out_json, "w") as f:
        json.dump({"by_phase": by_phase, "phase_s": PHASE_S,
                   "mono_ms": mono_ms, "init_ms": init_ms,
                   "batched_ms": batched_ms, "kitti_row": kitti_row,
                   "ba_ms": ba_ms}, f)


def multidevice_child_main(out_json: str):
    """The fifth process: ab_async_device_torch.py and
    bench_ba_scaling_torch.py of slice 14 (phase_async_device,
    phase_ba_scaling) on the card; the launches by phase, the phase
    seconds, orb_describe's row at the ab circuit's shapes and the
    scripts' JSON written to out_json."""
    import torch
    from object_slam_tpu_torch.ops import build
    if not torch.cuda.is_available():
        fail("no CUDA device")
    build.load_all(KERNELS)
    card = card_line()
    ab_launches, ab_row, ab_runs = phase_timed("async_device",
                                               phase_async_device, card)
    scaling_lines = phase_timed("ba_scaling", phase_ba_scaling, card)
    with open(out_json, "w") as f:
        json.dump({"by_phase": {f"async_device_{k}": v
                                for k, v in ab_launches.items()},
                   "phase_s": PHASE_S,
                   "ab_row": {k: ab_row[k] for k in (
                       "max_abs_err", "bound_ms", "bound_by")},
                   "ab_runs": ab_runs, "scaling_lines": scaling_lines}, f)


def start_child(arg: str = MONO_ARG, stem: str = "chip_smoke_mono"):
    """Start this script with ``arg`` (mono_child_main, tools_child_main,
    studies_child_main or multidevice_child_main) in another process on the same card (the card is
    idle most of the time in every phase: the port is bound by host
    dispatch), its output to build/<stem>.log; it is killed if this
    process exits first."""
    import atexit
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    log = os.path.join(root, "build", stem + ".log")
    out = os.path.join(root, "build", stem + ".json")
    if os.path.exists(out):
        os.remove(out)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 arg, out], stdout=f,
                                stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, log, out


def finish_child(child, by_phase, what: str, prefix: str):
    """Wait for a process of start_child, print its output, fail with it,
    and merge its launches and phase seconds (under prefix)."""
    proc, log, out = child
    t0 = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t0
    print(f"--- the {what} process; waited {waited:.1f} s for it ---",
          flush=True)
    print(open(log).read(), end="", flush=True)
    print("--- end of that process ---", flush=True)
    if rc != 0 or not os.path.exists(out):
        fail(f"the {what} process's phases failed (exit code {rc})")
    res = json.load(open(out))
    by_phase.update(res["by_phase"])
    PHASE_S.update({prefix + k: v for k, v in res["phase_s"].items()})
    return res


def phase_timed(name, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds kept in PHASE_S and printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    print(f"phase {name}: {PHASE_S[name]} s", flush=True)
    return out


def loop_phases(by_phase, card):
    bad, _, _ = phase_timed("loop_pass", phase_loop_pass, card)
    if bad:
        fail("loop pass: " + "; ".join(bad))
    phase_timed("loop_faults", phase_loop_faults, card)
    circ, accepted_ms, (poses, frames) = phase_timed(
        "loop_circuit", phase_loop_circuit, card)
    for k, v in circ.items():
        by_phase[f"loop_circuit_{k}"] = v
    phase_timed("loop_controls", phase_loop_controls, card, poses, frames)
    return accepted_ms


T_START = time.perf_counter()


def main():
    if len(sys.argv) == 3 and sys.argv[1] == MONO_ARG:
        return mono_child_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == TOOLS_ARG:
        return tools_child_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == STUDIES_ARG:
        return studies_child_main(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == MULTI_ARG:
        return multidevice_child_main(sys.argv[2])
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
    # mono at EuRoC width, localization mode, checkpoints, the EuRoC driver
    # and KITTI run in a second process beside this one's phases, the
    # offline tools in a third, the studies in a fourth, the multi-device
    # scripts in a fifth
    child = start_child()
    tools = start_child(TOOLS_ARG, "chip_smoke_tools")
    studies = start_child(STUDIES_ARG, "chip_smoke_studies")
    multi = start_child(MULTI_ARG, "chip_smoke_multidevice")

    cfg = tum_cfg()
    t0 = time.perf_counter()
    poses, frames, sems = render(cfg, N_FRAMES)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)

    from object_slam_tpu_torch.config import SlamConfig
    ex, levels, corners = main_path_inputs(cfg, frames[0][0])
    rows = [phase_patches(levels, corners),
            phase_describe(ex, levels, corners)]
    # and at the EuRoC shapes: a 752x480 frame, 1280 keypoints, 8 levels
    rows[1]["euroc"] = euroc_describe_row()
    # every path: the counts set to 0 just before it, read just after
    by_phase = {}
    by_phase["strict_objects_off"] = phase_timed(
        "strict_objects_off", run_path, cfg, poses, frames, sems, card,
        False)[2]
    by_phase["strict_objects_on"], strict_ms = phase_timed(
        "strict_objects_on", phase_objects, cfg, poses, frames, sems, card)
    # the main path as bench.py runs it: the default configuration
    # (pipelined readback), blobs, objects on
    main_cfg = SlamConfig.tum_rgbd()
    bench = phase_timed("bench", phase_bench, main_cfg, poses, frames, sems,
                        card, strict_ms)
    by_phase["bench_host_in_the_loop"] = bench["host"][0]
    by_phase["bench_device_resident"] = bench["device"][0]
    # the driver (decoding through its prefetcher), then its directory
    # decoded by the prefetcher against the PNG reader, and --viz-dir
    by_phase["tum_driver"] = phase_timed(
        "tum_driver", phase_tum, main_cfg, poses, frames, sems, card)
    by_phase["tum_driver_viz"] = phase_timed(
        "prefetch_driver", phase_prefetch_driver, main_cfg, poses, frames,
        sems, card)
    phase_timed("graft", phase_graft, card)
    # loop closing: one closure stage by stage (and with each planted
    # fault), the circuit replayed / own decisions / loop off, the kidnap
    # through the BoW relocalization, run_tum_torch.py --loop
    accepted_ms = loop_phases(by_phase, card)
    by_phase["tum_driver_loop"] = phase_timed(
        "tum_driver_loop", phase_tum, main_cfg, poses, frames, sems, card,
        loop=True)
    # the full-pipeline stage timer of slice 13 on the first 16 renders
    by_phase["stage_fullpipe"], fullpipe_ms = phase_timed(
        "stage_fullpipe", phase_stage_fullpipe, card, frames, sems)

    cres = finish_child(
        child, by_phase, "second (mono, localization, checkpoint, EuRoC "
        "driver, KITTI, the BA profile)", "second.")
    rows[1]["kitti"] = cres["kitti_row"]
    tres = finish_child(tools, by_phase, "third (generators, experiment "
                        "battery, vocabulary and BRIEF trainers)", "third.")
    sres = finish_child(
        studies, by_phase, "fourth (the accuracy studies: mapping variants, "
        "aliased corridor, semantic probes)", "fourth.")
    rows[1]["corridor"] = sres["corridor_row"]
    mres = finish_child(multi, by_phase, "fifth (the multi-device scripts)",
                        "fifth.")
    rows[1]["ab_circuit"] = mres["ab_row"]
    # diag_loop_alias_torch.py's cost ratios: the corridor's rejections
    # against the circuit's accepted closure (its positive control)
    ratios = script_module("diag_loop_alias_torch").cost_ratios(
        sres["corridor_events"], accepted_ms)
    print(f"corridor cost ratios [{card}]: {json.dumps(ratios)} (the "
          f"circuit's accepted closure {accepted_ms} ms)", flush=True)
    r = ratios.get("cost_ratio_pregated_vs_accepted")
    if r is None or not 0 < r < 1:
        fail(f"corridor: a pre-gated rejection does not cost less than an "
             f"accepted closure: {ratios}")
    # extract_patches runs on the BRIEF-pattern learner's path: its row
    # holds that path's launches and its numbers at the harvest's shapes
    # (one render's launches); the main-path frame's 16 windows per level
    # stay beside them. orb_describe's launches are the main path's
    rows[0]["tum_frame"] = {k: rows[0][k] for k in (
        "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "library_ms")}
    rows[0].update(tres["brief_row"])
    rows[1]["launches"] = by_phase["bench_host_in_the_loop"]["orb_describe"]
    rows[1]["launches_per_frame"] = rows[1]["launches"] // N_FRAMES
    for row in rows:
        row["launches_by_phase"] = {k: v[row["name"]]
                                    for k, v in by_phase.items()}
        timed = ("ms", "device_ms", "plain_ms", "bound_ms") + \
            (("library_ms",) if row["library_ms"] is not None else ())
        for k in timed:
            if not (isinstance(row[k], float) and math.isfinite(row[k])):
                fail(f"{row['name']} row field {k} is not a finite number")
        for shape in ("kitti", "euroc", "tum_frame", "corridor",
                      "ab_circuit"):
            items = list(row.get(shape, {}).items())
            while items:
                k, v = items.pop()
                if isinstance(v, dict):
                    items += [(f"{k}.{a}", b) for a, b in v.items()]
                elif k.split(".")[-1] != "bound_by" and not (
                        isinstance(v, float) and math.isfinite(v)):
                    fail(f"{row['name']} {shape} field {k} is not a finite "
                         f"number")
    print(f"stage timers [{card}]: diag_fullpipe build / track median ms "
          f"{json.dumps(fullpipe_ms)}; diag_kitti_stages ms "
          f"{json.dumps(tres['kitti_stage_ms'])}; diag_ba_profile "
          f"{json.dumps(cres['ba_ms'])}", flush=True)
    print(f"multi-device scripts [{card}]: ab_async_device "
          f"{json.dumps(mres['ab_runs'])}; bench_ba_scaling "
          f"{json.dumps(mres['scaling_lines'])}; diag_trace_stage (ms: one "
          f"call, "
          f"its kernels) " + json.dumps(
              {k: [round(v["wall_ms"], 3), round(v["kernel_ms"], 3)]
               for k, v in tres["trace"].items()}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all; "
          f"phases (s) {json.dumps(PHASE_S)}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
