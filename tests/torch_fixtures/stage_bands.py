"""What the stage timers' runs are held by (tests/test_torch_stages.py,
chip_smoke.py) against the reference's records in stages.npz
(make_reference.py ``stages``): a BA variant's result as a table, and the
floors of the bands probe_bands.misses draws from the reference's pinned
one-ulp noise runs.

A BA variant is held by its poses (every entry), its final robust cost,
the quantiles PT_Q of its points' steps from their initial coordinates
and the sum of its points' coordinates: within NOISE_MARGIN times the
farthest noise run, and at least the stated floor. The floors: the port
and the reference sum in other orders, and their LM's accept and CG exit
decisions follow that rounding; on diag_ba_profile.py's problem (small
and full size, on the CPU) the port's results lie within 6.3e-5
of the reference's poses, 2.0e-5 of its quantiles and 1.0e-5 relative
of its costs where the noise runs agree, so the floors are 1e-4 (poses),
2e-4 m (quantiles), 1e-5 (cost, relative) and 1e-6 (sum, relative).

The KITTI stage timer's counts (diag_kitti_stages_torch.stage_counts)
are held exactly where the noise runs agree, else within NOISE_MARGIN
times their spread. The counts of points, bindings, inliers and
covisibility weights have KITTI_RTOL (relative) and KITTI_TOL (absolute)
as floors: the port's map after 12 frames parts from the reference's by
a few bindings (its float arithmetic rounds otherwise). The decisions
and keyframe counts (KITTI_NO_FLOOR: the tracking step's flags, the
inserted keyframe's slot, the map's keyframes and each stage's change of
them) have no floor."""

import hashlib

import numpy as np

PT_Q = (0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)
BA_KEYS = ("kf_pose", "cost", "pt_q", "pt_sum")
BA_TOL = {"kf_pose": 1e-4, "pt_q": 2e-4}
BA_RTOL = {"cost": 1e-5, "pt_sum": 1e-6}
BA_NOISE_RUNS = 4
KITTI_NOISE_RUNS = 4
KITTI_RTOL = 0.05
KITTI_TOL = 3.0
# key suffixes held with no floor
KITTI_NO_FLOOR = (".ok", ".need_kf", ".need_kf_hard", ".kf_id", ".kfs",
                  ".d_kfs")
# the TUM limits a full-pipeline run's poses are held to
FULLPIPE_MM = 2.0
FULLPIPE_DEG = 0.1


# the BA problem's fields, in BAProblem's order
PROBLEM_FIELDS = ("kf_pose", "kf_fixed", "kf_valid", "pt_xyz", "pt_valid",
                  "obs_kf", "obs_pt", "obs_uv", "obs_ur", "obs_inv_sigma2",
                  "obs_valid")


def problem_hash(arrays, slot):
    """sha256 over a BA problem's numpy arrays (PROBLEM_FIELDS, each as
    float32, int32 or bool bytes) and its slot table."""
    h = hashlib.sha256()
    for f in PROBLEM_FIELDS:
        a = np.asarray(arrays[f])
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int32)
        h.update(f.encode() + np.ascontiguousarray(a).tobytes())
    h.update(np.ascontiguousarray(np.asarray(slot).astype(np.int32))
             .tobytes())
    return h.hexdigest()


def ba_record(pt0, kf_pose, pt_xyz, cost):
    """A BA result as held, from numpy arrays: the poses (flat), the
    final robust cost, the quantiles of the points' steps from pt0, the
    sum of the points' coordinates, and the points' sha256."""
    pt = np.asarray(pt_xyz, np.float32)
    step = np.linalg.norm(pt.astype(np.float64)
                          - np.asarray(pt0, np.float64), axis=1)
    return {"kf_pose": np.asarray(kf_pose, np.float32).reshape(-1),
            "cost": np.asarray([cost], np.float64),
            "pt_q": np.quantile(step, PT_Q),
            "pt_sum": np.asarray([pt.astype(np.float64).sum()]),
            "pt_hash": np.asarray(hashlib.sha256(pt.tobytes()).hexdigest())}


def ba_table(fx, prefix):
    """The held part of a record stored under prefix (``<name>.<run>.v<i>``
    in stages.npz) or of a ba_record."""
    if isinstance(fx, dict) and "kf_pose" in fx:
        return {k: np.asarray(fx[k]) for k in BA_KEYS}
    return {k: np.asarray(fx[f"{prefix}.{k}"]) for k in BA_KEYS}


def ba_misses(got, fx, size, i):
    """Where the ba_record got parts from variant i's record at size
    ("small" or "full") beyond its band: probe_bands.misses' list."""
    import probe_bands
    main = ba_table(fx, f"ba_{size}.main.v{i}")
    noise = [ba_table(fx, f"ba_{size}.noise{k}.v{i}")
             for k in range(BA_NOISE_RUNS)]
    return probe_bands.misses(ba_table(got, None), main, noise, tol=BA_TOL,
                              rtol=BA_RTOL)


def ba_pair_misses(got, other, fx, size, i):
    """Where two of the port's results (the scatter form against a
    blocked one) part beyond variant i's band."""
    import probe_bands
    noise = [ba_table(fx, f"ba_{size}.noise{k}.v{i}")
             for k in range(BA_NOISE_RUNS)]
    main = ba_table(fx, f"ba_{size}.main.v{i}")
    shifted = [{k: n[k] - main[k] + ba_table(other, None)[k] for k in n}
               for n in noise]
    return probe_bands.misses(ba_table(got, None), ba_table(other, None),
                              shifted, tol=BA_TOL, rtol=BA_RTOL)


def scatter_forms(rank: int, world: int, blocked: bool = False):
    """A rank setup for parallel/sharded_ba.py::spawn_sharded_global_ba
    (module level, so that a spawned rank can import it): each rank's
    global BA becomes ba_iterate's scatter forms on its shard, the
    per-point sums (and, blocked False, the per-keyframe sums) by
    index_add_ over this rank's rows, left to comm.reduce."""
    from object_slam_tpu_torch.parallel import sharded_ba
    from object_slam_tpu_torch.solvers import ba

    def scatter(K, prob, iters, *, block_n, comm, cg_iters):
        return ba.ba_iterate(K, prob, iters, cg_iters=cg_iters,
                             block_n=block_n if blocked else None,
                             pt_obs_slot=None, comm=comm)
    sharded_ba.global_ba = scatter


def kitti_counts(res):
    """diag_kitti_stages_torch.run's result as one record of counts:
    {"map": ..., stage: {...}} without the times."""
    rec = {"map": dict(res["map"])}
    for name, v in res["stages"].items():
        rec[name] = {k: x for k, x in v.items() if k != "ms"}
    return rec


def kitti_misses(res, fx, size):
    """Where a KITTI stage run's counts part from the reference's record
    at size ("small" or "vga") beyond their bands."""
    import probe_bands
    want = probe_bands.load(fx, f"kitti_{size}.main.counts")
    noise = [probe_bands.load(fx, f"kitti_{size}.noise{k}.counts")
             for k in range(KITTI_NOISE_RUNS)]
    got = probe_bands.table([kitti_counts(res)])
    stages = set(res["stages"])
    want = {k: v for k, v in want.items()
            if k.startswith("map.") or k.split(".")[0] in stages}
    floored = [k for k in want if not k.endswith(KITTI_NO_FLOOR)]
    return probe_bands.misses(got, want, noise,
                              tol={k: KITTI_TOL for k in floored},
                              rtol={k: KITTI_RTOL for k in floored})


def fullpipe_misses(res, fx, size):
    """Where a full-pipeline run parts from the reference's record at
    size: the bytes line exactly, the frames' flags and keyframes
    exactly, the poses within FULLPIPE_MM and FULLPIPE_DEG, and every
    span of the reference's report present with its calls. Returns a
    list of strings."""
    p = f"fullpipe_{size}.main."
    out = []
    if list(res["bytes"]) != fx[p + "bytes"].tolist():
        out.append(f"bytes {list(res['bytes'])} against "
                   f"{fx[p + 'bytes'].tolist()}")
    if not np.array_equal(np.asarray(res["tracked"]), fx[p + "tracked"]):
        out.append(f"tracked {np.asarray(res['tracked']).tolist()}")
    if list(res["kf_frames"]) != fx[p + "kf_frames"].tolist():
        out.append(f"keyframes {list(res['kf_frames'])} against "
                   f"{fx[p + 'kf_frames'].tolist()}")
    T, R = np.asarray(res["Tcw"], np.float64), fx[p + "Tcw"].astype(
        np.float64)
    if T.shape != R.shape:
        out.append(f"poses {T.shape} against {R.shape}")
    else:
        dt = np.linalg.norm(T[:, :3, 3] - R[:, :3, 3], axis=1).max() * 1e3
        c = (np.einsum("nij,nij->n", T[:, :3, :3], R[:, :3, :3]) - 1) / 2
        deg = np.degrees(np.arccos(np.clip(c, -1, 1))).max()
        if dt > FULLPIPE_MM or deg > FULLPIPE_DEG:
            out.append(f"poses {dt:.4f} mm / {deg:.4f} deg")
    spans = dict(res["spans"])
    for name, n in zip(fx[p + "span_names"].tolist(),
                       fx[p + "span_calls"].tolist()):
        if spans.get(name) != n:
            out.append(f"span {name}: {spans.get(name)} calls against {n}")
    return out
