"""The four KITTI retention probes of scripts/ in the PyTorch port against
the JAX package's runs recorded on the CPU (tests/torch_fixtures/
probes.npz, make_reference.py probes): diag_kitti_retention_torch.py
(the frame build alone, ground-truth transport), diag_kitti_torch.py
(objects on, async mapping), diag_local_recovery_torch.py and
diag_motion_chain_torch.py (the system as the scripts make it), on the
small street canyon of torch_fixtures/street.py::stereo_cfg (416x128, a
10-frame drive written as a KITTI directory by datasets/kitti.py::
write_sequence), and the four mains in a process where the reference
cannot be imported.

Tolerances (probe_bands.misses: each count within max(its tolerance,
2x the farthest departure of the reference's pinned one-ulp noise runs)):
the frame-build probe exact (its Hamming on the device gives the
reference's counts); the system probes' counts within the relative
tolerances below, which the one-ulp noise does not reach: the port's map
parts from the reference's by more than the reference's own one-ulp
spread (records within 5 mm, tests/test_torch_kitti.py), and the local
search's predicted level, ceil(log(max_dist / dist) / log 1.2), sits on
an integer for points seen from a keyframe's own pose, so a point moves
between the window and the later gates (frame 8 moves 49 of ~300 close
points from no_kp_radius to lost on the CPU port). The keyframe frames
are exact."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_fixtures import faults, probe_bands
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "probes.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))

import diag_kitti_retention_torch as kret  # noqa: E402
import diag_kitti_torch as dkitti  # noqa: E402
import diag_local_recovery_torch as lrec  # noqa: E402
import diag_motion_chain_torch as mchain  # noqa: E402

DRIVE = 10                      # make_reference.py PROBE_KITTI_SMALL
# the system probes run the drive's first SYS_FRAMES frames and are held
# to the same frames of the reference's runs (their totals: the sums of
# those frames)
SYS_FRAMES = 6
NOISE_RUNS = 4
# diag_kitti: inliers 5%, the pose error 5 mm (the small street's record
# band); the frame-build counts, objects and keyframes exact
KITTI_TOL = {"err_m": 5e-3}
KITTI_RTOL = {"inl": 0.05}
# diag_local_recovery: the close and matched points 5% per frame, the
# gates' counts in the totals 10% (per frame a gate can gain or lose half
# its points at the predicted level's integer ties)
LREC_RTOL = {"close_vis": 0.05, "matched": 0.05}
LREC_GATES = ("no_local", "frustum", "no_kp_radius", "level", "desc",
              "lost", "level_would_pass_w2", "radius_would_pass_2x")
TOTAL_RTOL = 0.1
# diag_motion_chain: each stage's count 5% + 2 per frame, the totals 2% + 2
MCHAIN_TOL, MCHAIN_RTOL, MCHAIN_TOTAL_RTOL = 2.0, 0.05, 0.02


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The reference's drive as KITTI files, written by the port from its
    renders (they equal the reference's renders, tests/test_torch_kitti.py)."""
    import object_slam_tpu_torch.config as tconfig
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.synthetic import render_street
    import street
    cfg = street.stereo_cfg(tconfig)
    poses, frames, _ = render_street(cfg, DRIVE, workers=2)
    out = str(tmp_path_factory.mktemp("kitti_small"))
    kitti.write_sequence(out, poses, frames)
    return cfg, out


def _first(t, n=SYS_FRAMES):
    """A per-frame table's frames before n."""
    keep = t["f"] < n
    return {k: v[keep] for k, v in t.items()}


def _recs(fx, name, run="main"):
    return _first(probe_bands.load(fx, f"{name}.{run}.recs"))


def _noise(fx, name):
    return [_recs(fx, name, f"noise{k}") for k in range(NOISE_RUNS)]


def _sums(t):
    return {k: np.asarray([np.nansum(v)]) for k, v in t.items() if k != "f"}


def _run(mod, seq, frames=SYS_FRAMES, on_system=None):
    cfg, path = seq
    args = mod.parse_args(["--seq", path, "--frames", str(frames)])
    kw = {} if on_system is None else {"on_system": on_system}
    return mod.run(cfg, args, device="cpu", log=lambda s: None, **kw)


def test_kitti_retention_probe_matches_reference(fx, seq):
    res = _run(kret, seq, frames=DRIVE)
    noise = [probe_bands.load(fx, f"kret_small.noise{k}.{t}")
             for t in ("recs", "totals") for k in range(NOISE_RUNS)]
    assert probe_bands.misses(probe_bands.table(res["frames"]),
                              probe_bands.load(fx, "kret_small.main.recs"),
                              noise[:NOISE_RUNS]) == []
    assert probe_bands.misses(
        probe_bands.table([dict(res["totals"], jumps=res["jumps"])]),
        probe_bands.load(fx, "kret_small.main.totals"),
        noise[NOISE_RUNS:]) == []


def test_kitti_probe_matches_reference(fx, seq):
    res = _run(dkitti, seq)
    assert probe_bands.misses(probe_bands.table(res["frames"]),
                              _recs(fx, "kitti_small"),
                              _noise(fx, "kitti_small"), tol=KITTI_TOL,
                              rtol=KITTI_RTOL) == []


def _totals_misses(got, fx, name, rtol, tol=0.0):
    want = _sums(_recs(fx, name))
    return probe_bands.misses(_sums(probe_bands.table(got)), want,
                              [_sums(t) for t in _noise(fx, name)],
                              tol={k: tol for k in want},
                              rtol={k: rtol for k in want})


def test_local_recovery_probe_matches_reference(fx, seq):
    res = _run(lrec, seq)
    assert probe_bands.misses(probe_bands.table(res["per_frame"]),
                              _recs(fx, "lrec_small"),
                              _noise(fx, "lrec_small"), rtol=LREC_RTOL,
                              skip=LREC_GATES) == []
    assert _totals_misses(res["per_frame"], fx, "lrec_small",
                          TOTAL_RTOL) == []
    assert res["totals"] == {k: int(v[0]) for k, v in _sums(
        probe_bands.table(res["per_frame"])).items()
        if k in res["totals"]}


def _mchain_misses(res, fx):
    want = _recs(fx, "mchain_small")
    bad = probe_bands.misses(
        probe_bands.table(res["per_frame"]), want, _noise(fx, "mchain_small"),
        tol={k: MCHAIN_TOL for k in want if k != "f"},
        rtol={k: MCHAIN_RTOL for k in want})
    return bad + _totals_misses(res["per_frame"], fx, "mchain_small",
                                MCHAIN_TOTAL_RTOL, MCHAIN_TOL)


def test_motion_chain_probe_matches_reference(fx, seq):
    assert _mchain_misses(_run(mchain, seq), fx) == []


def test_motion_chain_with_a_symmetric_level_window_fails(fx, seq):
    """The planted fault: the motion search's level window +-1 under
    forward motion. The chain's matches and inliers miss."""
    undo = faults.symmetric_motion_level_window()
    try:
        bad = _mchain_misses(_run(mchain, seq), fx)
    finally:
        undo()
    assert any(k.startswith(("matched", "inlier")) for k, *_ in bad), bad


def test_kitti_probe_mains_run_without_the_reference(seq, tmp_path):
    """The four KITTI probes' main() on the CPU on the small drive's
    directory (SlamConfig.kitti_stereo patched to the small geometry),
    in a process where importing jax or object_slam_tpu raises; the --out
    files of the two that write one."""
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()))
    seq = seq[1]
    code = textwrap.dedent(f"""
        import builtins, json, sys
        real = builtins.__import__

        def guard(name, *a, **kw):
            if name == "jax" or name.startswith("jax.") or \\
                    name == "object_slam_tpu" or \\
                    name.startswith("object_slam_tpu."):
                raise ImportError("the reference is not importable: " + name)
            return real(name, *a, **kw)
        builtins.__import__ = guard
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "scripts")!r},
                        {os.path.join(ROOT, "tests", "torch_fixtures")!r}]
        import object_slam_tpu_torch.config as config
        import street
        small = street.stereo_cfg(config)
        config.SlamConfig.kitti_stereo = staticmethod(lambda: small)
        import diag_kitti_retention_torch, diag_kitti_torch
        import diag_local_recovery_torch, diag_motion_chain_torch
        s = ["--seq", {str(seq)!r}, "--device", "cpu"]
        res = {{}}
        res["kret"] = diag_kitti_retention_torch.main(
            s + ["--frames", "2"])["totals"]
        res["kitti"] = len(diag_kitti_torch.main(s + ["--frames", "2"])[
            "frames"])
        res["lrec"] = diag_local_recovery_torch.main(
            s + ["--frames", "3", "--out", {str(tmp_path / "l.json")!r}])[
            "totals"]
        res["mchain"] = diag_motion_chain_torch.main(
            s + ["--frames", "3", "--out", {str(tmp_path / "m.json")!r}])[
            "totals"]
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "object_slam_tpu."))
                  or m == "object_slam_tpu"]
        print("RESULT " + json.dumps(dict(res, loaded=loaded)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["loaded"] == []
    assert res["kret"]["n"] > 0 and res["kitti"] == 2
    assert res["lrec"]["close_vis"] > 0
    assert set(json.load(open(tmp_path / "l.json"))) == {"totals",
                                                          "per_frame"}
    assert json.load(open(tmp_path / "m.json")) == res["mchain"]
    assert res["mchain"]["bound"] > 0
    assert "close rows:" in proc.stdout and "totals over" in proc.stdout
