"""The retention probes' records as tables, and the bands the port's
records are held to (tests/test_torch_probes*.py, chip_smoke.py).

A probe's run is a list of per-frame dicts (nested dicts and lists
allowed, None where the script prints nothing). ``table`` flattens them
into {"key.sub[i]": float64 [n_frames]} with NaN for None; ``put`` /
``load`` store and read a table in an npz as make_reference.py writes
them. An integer count is
held exactly where the reference's pinned one-ulp noise runs agree with
its main run at that frame, else within NOISE_MARGIN times their farthest
departure; a float within max(its stated tolerance, NOISE_MARGIN times
that departure). Where a check states a relative tolerance, the band is
at least that share of the reference's value."""

import numpy as np

NOISE_MARGIN = 2.0


def flatten(rec, prefix=""):
    out = {}
    if isinstance(rec, dict):
        for k, v in rec.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(rec, (list, tuple)):
        for i, v in enumerate(rec):
            out.update(flatten(v, f"{prefix[:-1]}[{i}]."))
    else:
        out[prefix[:-1]] = (np.nan if rec is None else float(rec))
    return out


def table(recs):
    """[per-frame dict] -> {key: float64 [n]} (NaN where a frame lacks
    the key or has None)."""
    flat = [flatten(r) for r in recs]
    keys = sorted({k for f in flat for k in f})
    return {k: np.asarray([f.get(k, np.nan) for f in flat], np.float64)
            for k in keys}


def put(out, prefix, recs):
    """Store table(recs) (or a table) under prefix: its keys and one
    [n_keys, n_frames] float64 matrix (an npz's per-array overhead would
    outweigh the numbers)."""
    t = recs if isinstance(recs, dict) else table(recs)
    keys = sorted(t)
    out[f"{prefix}.keys"] = np.asarray(keys)
    out[f"{prefix}.values"] = (np.stack([t[k] for k in keys]) if keys
                               else np.zeros((0, 0)))


def load(fx, prefix):
    """The table stored under prefix in an npz (or dict): put's packed
    form, or one array per key."""
    if f"{prefix}.keys" in fx:
        vals = np.asarray(fx[f"{prefix}.values"])
        return {str(k): vals[i] for i, k in enumerate(fx[f"{prefix}.keys"])}
    n = len(prefix) + 1
    return {k[n:]: np.asarray(fx[k]) for k in fx.keys()
            if k.startswith(prefix + ".")}


def misses(got, ref, noise, tol=None, rtol=None, exact=(), skip=()):
    """Where the table got parts from ref beyond its band: [(key, frame,
    got, want, limit)]. noise: the noise runs' tables. tol / rtol: {key
    prefix: absolute / relative tolerance} (a key under no prefix is held
    exactly but for the noise). exact: key prefixes held exactly whatever
    the noise; skip: key prefixes not held. A key only ref has, or a NaN
    on one side only, is a miss."""
    tol = tol or {}
    rtol = rtol or {}
    out = []
    for key, want in ref.items():
        if any(key.startswith(s) for s in skip):
            continue
        g = got.get(key)
        if g is None or g.shape != want.shape:
            out.append((key, -1, None if g is None else g.shape,
                        want.shape, None))
            continue
        spread = np.zeros_like(want)
        for nz in noise:
            w = nz.get(key)
            if w is not None and w.shape == want.shape:
                d = np.abs(np.nan_to_num(w, nan=1e9)
                           - np.nan_to_num(want, nan=1e9))
                spread = np.maximum(spread, d)
        t = next((v for p, v in tol.items() if key.startswith(p)), 0.0)
        r = next((v for p, v in rtol.items() if key.startswith(p)), 0.0)
        if any(key.startswith(p) for p in exact):
            spread[:] = 0.0
        limit = np.maximum(np.maximum(t, r * np.abs(np.nan_to_num(want))),
                           NOISE_MARGIN * spread)
        for i in range(want.shape[0]):
            a, b = g[i], want[i]
            if np.isnan(a) or np.isnan(b):
                if np.isnan(a) != np.isnan(b):
                    out.append((key, i, a, b, float(limit[i])))
            elif abs(a - b) > limit[i] + 1e-9 * max(1.0, abs(b)):
                out.append((key, i, a, b, float(limit[i])))
    return out
