"""What the multi-device scripts' runs are held by
(tests/test_torch_multidevice.py, chip_smoke.py), against the reference's
records: async_device.npz and scaling.npz (make_reference.py
``async_device``, ``scaling``).

ab_async_device_torch.py: each arm (sync, async) over the first n frames
of the script's 320x240 circuit, with ready() pinned to "a pass is
pending" as the reference's record is (ab_async_device_torch.
pinned_ready), against the JAX run of the same frames and its
NOISE_RUNS one-ulp noise runs (the keyframe decisions of the main run
pinned):
- tracked flags, the frames a keyframe was inserted on, the merge lag of
  each frame, the keyframe count, the dispatches (and those on the
  abbreviated schedule), the merges and the script's lag keys: exactly,
  or as any noise run has them where the noise runs part from the main
  run;
- each frame's track-time record within REC_M (translation, max
  component) and REC_DEG, or NOISE_MARGIN times the farthest a noise run
  lands from the main run by that frame, whichever is wider (the circuit
  is chaotic: a one-ulp change grows along it);
- the ATE within ATE_MM or NOISE_MARGIN times the noise runs' farthest;
- the final point count within POINTS_RTOL (relative) or POINTS_TOL, or
  NOISE_MARGIN times the noise runs' farthest.
The floors REC_M / REC_DEG are the TUM records' limits of the earlier
slices (stage_bands.FULLPIPE_MM / FULLPIPE_DEG); ATE_MM the study
variants' (chip_smoke.py STUDY_ATE_MM); POINTS_RTOL / POINTS_TOL the
count floors of stage_bands (KITTI_RTOL / KITTI_TOL).

bench_ba_scaling_torch.py: the problem's indices and flags exactly and
its floats within PROBLEM_RTOL times the array's largest magnitude (the
port projects with torch, the reference with jnp: the pixels part by up
to 1.2e-4 px of 858, a few ulps, which the sum with cx turns into up to
4e-5 relative where the pixel lies near 0), each world size's poses
and points within BA_POSE_TOL / BA_POINT_TOL (the CPU test's of the
sharded BA, tests/test_torch_parallel.py) or NOISE_MARGIN times the
spread of the JAX mesh run's 4 noise runs, and every rank bit-equal to
rank 0."""

import json

import numpy as np

from probe_bands import NOISE_MARGIN

NOISE_RUNS = 4
REC_M = 2e-3
REC_DEG = 0.1
ATE_MM = 0.02
POINTS_RTOL = 0.05
POINTS_TOL = 3
# the keys held as any recorded run has them
EXACT_KEYS = ("tracked", "inserts", "lag", "dispatches", "fast_dispatches",
              "merges")
RESULT_KEYS = ("keyframes", "tracked", "frames_with_pending_pass",
               "merge_lag_frames_max", "merge_lag_frames_median")
PROBLEM_RTOL = 1e-6
BA_POSE_TOL = 1e-4
BA_POINT_TOL = 1e-3


def _rot_deg(a, b):
    R = (np.asarray(a)[:3, :3].T.astype(np.float64)
         @ np.asarray(b)[:3, :3].astype(np.float64))
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1,
                                              1))))


def arm_runs(fx, n, arm):
    """The recorded main run and its noise runs of one arm at depth n:
    (main, [noise]), each {key: array} with "result" parsed."""
    def one(run):
        p = f"{n}.{arm}.{run}."
        d = {k[len(p):]: fx[k] for k in fx.files if k.startswith(p)}
        d["result"] = json.loads(str(d["result"]))
        return d
    return one("main"), [one(f"noise{k}") for k in range(NOISE_RUNS)]


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def arm_checks(fx, n, arm, res, detail):
    """[(what, port, reference, limit, held)] of one arm's run over the
    first n frames (ab_async_device_torch.run_arm's result and detail)
    against the recorded runs."""
    main, noise = arm_runs(fx, n, arm)
    checks = []
    for key in EXACT_KEYS:
        got = detail[key]
        ok = any(_same(got, r[key]) for r in [main] + noise)
        checks.append((key, np.asarray(got).tolist(),
                       np.asarray(main[key]).tolist(), "equal", ok))
    for key in RESULT_KEYS:
        ok = any(res[key] == r["result"][key] for r in [main] + noise)
        checks.append((key, res[key], main["result"][key], "equal", ok))
    rec, got = main["rec_tcw"], detail["rec_tcw"]
    d, a = np.zeros(len(rec)), np.zeros(len(rec))
    for r in noise:
        d = np.maximum(d, np.abs(r["rec_tcw"][:, :3, 3]
                                 - rec[:, :3, 3]).max(1))
        a = np.maximum(a, [_rot_deg(x, y) for x, y in zip(r["rec_tcw"],
                                                          rec)])
    lim_m = np.maximum(REC_M, NOISE_MARGIN * np.maximum.accumulate(d))
    lim_deg = np.maximum(REC_DEG, NOISE_MARGIN * np.maximum.accumulate(a))
    if got.shape != rec.shape:
        checks.append(("records", got.shape, rec.shape, "shape", False))
    else:
        dm = np.abs(got[:, :3, 3] - rec[:, :3, 3]).max(1)
        da = np.asarray([_rot_deg(x, y) for x, y in zip(got, rec)])
        fm, fa = int(np.argmax(dm / lim_m)), int(np.argmax(da / lim_deg))
        checks += [(f"records m (frame {fm})", float(dm[fm]), 0.0,
                    float(lim_m[fm]), bool(np.all(dm <= lim_m))),
                   (f"records deg (frame {fa})", float(da[fa]), 0.0,
                    float(lim_deg[fa]), bool(np.all(da <= lim_deg)))]
    want = main["result"]["ate_rmse_mm"]
    lim = max(ATE_MM, NOISE_MARGIN * max(
        abs(r["result"]["ate_rmse_mm"] - want) for r in noise))
    checks.append(("ATE mm", res["ate_rmse_mm"], want, lim,
                   abs(res["ate_rmse_mm"] - want) <= lim))
    want = int(main["n_points"])
    lim = max(POINTS_TOL, POINTS_RTOL * want, NOISE_MARGIN * max(
        abs(int(r["n_points"]) - want) for r in noise))
    checks.append(("points", detail["n_points"], want, lim,
                   abs(detail["n_points"] - want) <= lim))
    return checks


def misses(checks):
    """The checks that failed, as text."""
    return [f"{w} {g} (reference {r}, limit {lim})"
            for w, g, r, lim, ok in checks if not ok]


def problem_misses(fx, arrays):
    """Where bench_ba_scaling_torch.problem's arrays part from the
    recorded problem's (the reference's at the recorded size)."""
    out = []
    for k, a in arrays.items():
        want = fx[f"prob.{k}"]
        if np.asarray(a).shape != want.shape:
            out.append(f"{k}: shape {np.asarray(a).shape} != {want.shape}")
        elif want.dtype.kind == "f":
            err = float(np.abs(a - want).max())
            if err > PROBLEM_RTOL * float(np.abs(want).max()):
                out.append(f"{k}: {err} away")
        elif not np.array_equal(a, want):
            out.append(f"{k}: differs")
    return out


def mesh_reference(fx, nd):
    """The JAX mesh run of size nd: ({"kf_pose", "pt_xyz"}, {key: the
    farthest its noise runs land from it})."""
    want = {k: fx[f"mesh{nd}.main.{k}"] for k in ("kf_pose", "pt_xyz")}
    spread = {k: max(float(np.abs(fx[f"mesh{nd}.noise{j}.{k}"]
                                  - v).max()) for j in range(NOISE_RUNS))
              for k, v in want.items()}
    return want, spread


def scaling_checks(outs, want, spread=None, tag=""):
    """[(what, port, limit, held)] of one world size's ranks' results (per
    rank {"kf_pose", "pt_xyz"}): every rank bit-equal to rank 0, and rank
    0's poses and points within BA_POSE_TOL / BA_POINT_TOL of want, or
    NOISE_MARGIN times spread (per key) where that is wider."""
    spread = spread or {}
    checks = []
    for r, o in enumerate(outs[1:], 1):
        checks.append((f"rank {r} bit-equal to rank 0", None, None,
                       _same(o["kf_pose"], outs[0]["kf_pose"])
                       and _same(o["pt_xyz"], outs[0]["pt_xyz"])))
    for key, tol in (("kf_pose", BA_POSE_TOL), ("pt_xyz", BA_POINT_TOL)):
        lim = max(tol, NOISE_MARGIN * spread.get(key, 0.0))
        err = float(np.abs(outs[0][key] - want[key]).max())
        checks.append((f"{key} {tag}".strip(), err, lim, err <= lim))
    return checks
