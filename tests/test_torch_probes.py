"""The tracking-retention probes of scripts/ on the TUM side, in the
PyTorch port against the JAX package's runs recorded on the CPU
(tests/torch_fixtures/probes.npz, make_reference.py probes): the
pose-solver probe (scripts/diag_poseopt_torch.py), the retention probe
(diag_retention_torch.py) with its frame dumps, the two replays of a dump
(diag_replay_torch.py, diag_gnsteps_torch.py), SlamSystem.debug_last at
its three sites, and every one of these mains in a process where the
reference cannot be imported. tests/test_torch_probes_kitti.py holds the
four KITTI probes.

The retention probe runs make_reference.py's small_cfg (160x120, 4
levels, strict readback) on diag_retention.py's orbit of the room scene:
12 frames, and 8 with --loc-only (the map frozen after the first frame,
every later frame on the staged path, where the motion-model and
local-map results differ). Tolerances, probe_bands.misses: every integer
count exact where the reference's pinned one-ulp noise runs (level_noise
and pinned_noise) agree with its main run at that frame, else within 2x
their farthest departure; floats within max(their tolerance below, 2x
that departure). The replays run on the reference's own dumps, so their
counts are exact where the solver is (the replays of the noise-free
dump); their errors within REPLAY_MM."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_fixtures import faults, probe_bands
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "probes.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import diag_gnsteps_torch as gnsteps  # noqa: E402
import diag_poseopt_torch as poseopt  # noqa: E402
import diag_replay_torch as replay  # noqa: E402
import diag_retention_torch as retention  # noqa: E402

RET_FRAMES, LOC_FRAMES = 12, 8      # make_reference.py PROBE_*_SMALL
NOISE_RUNS, LOC_NOISE_RUNS, POSE_NOISE_RUNS = 4, 3, 8
# floats: pose and map errors (mm), rotations (deg), the share of wrong
# matches (percentage points: one of ~80 matches is 1.25)
RET_TOL = {"err_mm": 0.1, "dC_mm": 0.1, "motion.err_mm": 0.1,
           "local.err_mm": 0.1, "map3d": 0.1, "rot_deg": 0.01,
           "motion.wrong": 1.5, "local.wrong": 1.5}
SUMMARY_TOL = {"ate_raw_mm": 0.1, "max_mm": 0.1}
POSE_ERR_MM = 0.02
REPLAY_MM = 0.05
REPLAY_TOL = {"init_T_pred": REPLAY_MM, "init_Tcw_local": REPLAY_MM,
              "init_T_gt": REPLAY_MM, "wrong_basin": REPLAY_MM,
              "right_basin": REPLAY_MM, "recorded": 1e-6,
              "cost_gt": 1e-6, "start_err_mm": 1e-6, "steps": REPLAY_MM}
# the costs at the solutions found: relative
REPLAY_RTOL = {"cost_wrong": 1e-3, "cost_right": 1e-3}
# the LM trace's steps within a round: the damping's history rounds
# differently, so the first steps after a regate part by up to ~4% (0.9
# of 23.4 mm on dump 0's second round; the step lengths there 0.19
# against 1.03 mm) and meet again by its end: each round's last error and
# step are held to REPLAY_MM, the errors before it to GN_STEP_RTOL, the
# active counts exactly
GN_STEP_RTOL = {"steps": 0.1}
DUMP_KEYS = {"uv", "ur", "level", "valid", "depth", "kp_pt_motion",
             "kp_pt_local", "T_pred", "Tcw_motion", "Tcw_local", "pt_xyz",
             "pt_valid", "T_gt"}


def small_cfg():
    from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                              OrbConfig, SlamConfig,
                                              TrackingConfig)
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        tracking=TrackingConfig(pipelined_readback=False))


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _runs(fx, name, runs):
    return [probe_bands.load(fx, f"{name}.{r}.recs") for r in runs]


def _retention(loc, dump_dir=None, on_system=None):
    n = LOC_FRAMES if loc else RET_FRAMES
    args = retention.parse_args(["--frames", str(n)]
                                + (["--loc-only"] if loc else []))
    return retention.run(small_cfg(), args, device="cpu",
                         log=lambda s: None, dump_dir=dump_dir,
                         on_system=on_system)


@pytest.fixture(scope="module")
def ret_main(tmp_path_factory):
    out = tmp_path_factory.mktemp("dumps")
    return _retention(False, dump_dir=str(out)), out


@pytest.fixture(scope="module")
def ret_loc():
    return _retention(True)


def _dump(fx, j):
    p = f"ret_small.dump{j}."
    return {k[len(p):]: fx[k] for k in fx.files if k.startswith(p)}


def test_pose_solver_probe_matches_reference(fx):
    """diag_poseopt's 18 initializations: the valid count exact, each
    row's inliers exact where the 8 one-ulp noise runs agree, its error
    within max(POSE_ERR_MM, 2x their spread)."""
    res = poseopt.run(device="cpu", log=lambda s: None)
    assert res["n_valid"] == int(fx["pose.n_valid"])
    cols = ("dt_mm", "dr_deg", "err_mm", "n_inl")
    got = {c: np.asarray([r[c] for r in res["rows"]], np.float64)
           for c in cols}
    want = {c: fx["pose.rows"][:, i] for i, c in enumerate(cols)}
    noise = [{c: fx[f"pose.noise.{k}.rows"][:, i] for i, c in enumerate(cols)}
             for k in range(POSE_NOISE_RUNS)]
    assert probe_bands.misses(got, want, noise,
                              tol={"err_mm": POSE_ERR_MM}) == []


def test_retention_probe_matches_reference(fx, ret_main):
    res, _ = ret_main
    got = probe_bands.table(res["frames"])
    want = probe_bands.load(fx, "ret_small.main.recs")
    noise = _runs(fx, "ret_small", [f"noise{k}" for k in range(NOISE_RUNS)])
    assert len(res["frames"]) == RET_FRAMES
    assert probe_bands.misses(got, want, noise, tol=RET_TOL) == []
    s_noise = [probe_bands.load(fx, f"ret_small.noise{k}.summary")
               for k in range(NOISE_RUNS)]
    assert probe_bands.misses(probe_bands.table([res["summary"]]),
                              probe_bands.load(fx, "ret_small.main.summary"),
                              s_noise, tol=SUMMARY_TOL) == []


def test_retention_loc_only_matches_reference(fx, ret_loc):
    got = probe_bands.table(ret_loc["frames"])
    want = probe_bands.load(fx, "ret_small.loc.recs")
    noise = _runs(fx, "ret_small",
                  [f"locnoise{k}" for k in range(LOC_NOISE_RUNS)])
    assert probe_bands.misses(got, want, noise, tol=RET_TOL) == []
    # the staged path: the motion-model and local-map results differ
    assert np.any(got["motion.n"][1:] != got["local.n"][1:])


def test_retention_with_the_motion_snapshot_local_fails(fx):
    """The planted fault: debug_last's motion result replaced by the local
    one. The loc-only run's motion columns then miss the reference."""
    res = _retention(True, on_system=faults.motion_snapshot_is_local)
    got = probe_bands.table(res["frames"])
    want = probe_bands.load(fx, "ret_small.loc.recs")
    noise = _runs(fx, "ret_small",
                  [f"locnoise{k}" for k in range(LOC_NOISE_RUNS)])
    bad = probe_bands.misses(got, want, noise, tol=RET_TOL)
    assert any(k.startswith("motion.") for k, *_ in bad)


def test_dumps_are_the_reference_scripts(fx, ret_main):
    """OSLAM_DUMP: the frames past 20 mm dumped (those the reference's run
    dumps where the runs agree), each with the reference's keys, dtypes
    and shapes; and the dump the port writes replays."""
    res, out = ret_main
    dumped = [r["f"] for r in res["frames"] if r["dumped"]]
    assert [os.path.basename(p) for p in res["dumps"]] == \
        [f"f{i:03d}.npz" for i in dumped]
    by_script = [int(f) for f, s in zip(fx["ret_small.dump_frames"],
                                        fx["ret_small.dump_by_script"]) if s]
    assert set(by_script) <= set(dumped)
    want = _dump(fx, 0)
    for path in res["dumps"]:
        with np.load(path) as d:
            assert set(d.files) == DUMP_KEYS
            for k in DUMP_KEYS:
                assert d[k].dtype == want[k].dtype, k
                assert d[k].shape == want[k].shape, k
    if res["dumps"]:
        r = replay.run(res["dumps"][0], cfg=small_cfg(), device="cpu",
                       log=lambda s: None)
        assert r["init_T_gt"]["local"]["n"] > 0


@pytest.mark.parametrize("j", [0, 1])
def test_replays_of_the_reference_dump_match_the_reference(fx, j):
    """diag_replay and diag_gnsteps on the reference's dump j against the
    reference's replays of it."""
    dump = _dump(fx, j)
    r = replay.run(dump, cfg=small_cfg(), device="cpu", log=lambda s: None)
    assert probe_bands.misses(probe_bands.table([r]),
                              probe_bands.load(fx, f"replay{j}"), [],
                              tol=REPLAY_TOL, rtol=REPLAY_RTOL) == []
    g = gnsteps.run(dump, cfg=small_cfg(), device="cpu", log=lambda s: None)
    got = probe_bands.table([g])
    want = probe_bands.load(fx, f"gnsteps{j}")
    steps = {k: v for k, v in want.items() if not k.endswith("step_mm")}
    assert probe_bands.misses(got, steps, [], tol=REPLAY_TOL,
                              rtol=GN_STEP_RTOL) == []
    # each round ends where the reference's does, at rest
    for k in range(9, 40, 10):
        for f in ("err_mm", "step_mm"):
            key = f"steps[{k}].{f}"
            assert abs(got[key][0] - want[key][0]) <= REPLAY_MM, key


def test_pose_solver_probes_with_the_gates_exchanged_fail(fx):
    """The planted fault: pose_opt's chi2 gates exchanged. The replays of
    the reference's dumps miss the reference's."""
    undo = faults.exchange_pose_gates()
    try:
        bad = []
        for j in (0, 1):
            r = replay.run(_dump(fx, j), cfg=small_cfg(), device="cpu",
                           log=lambda s: None)
            bad += probe_bands.misses(probe_bands.table([r]),
                                      probe_bands.load(fx, f"replay{j}"), [],
                                      tol=REPLAY_TOL, rtol=REPLAY_RTOL)
    finally:
        undo()
    assert bad


def _staged_cfg():
    import dataclasses
    cfg = small_cfg()
    return cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                    fused=False))


def _frames(n):
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    scene = SyntheticScene.make(small_cfg(), seed=3, n_objects=2,
                                plane_z=4.0)
    return [scene.render_rgbd(T)[:3] for T in orbit_poses(n)]


def _device_tensors(dbg, sys_):
    for tag in ("tr_motion", "tr_local"):
        for f in ("Tcw", "kp_pt", "kp_pt_all"):
            t = getattr(dbg[tag], f)
            assert isinstance(t, torch.Tensor) and t.device == sys_.device
    assert isinstance(dbg["frame"].uv, torch.Tensor)


def test_debug_last_at_its_three_sites(monkeypatch):
    """None after construction; the fused path's snapshot (no T_pred, the
    motion and local results the one fused result); the staged path's
    (T_pred, the two results); the localization VO result's (both the VO
    result); None again after reset(). Device tensors throughout."""
    from object_slam_tpu_torch.slam import tracking as trk
    from object_slam_tpu_torch.slam.system import SlamSystem
    frames = _frames(3)
    sys_ = SlamSystem(small_cfg(), enable_objects=False, device="cpu")
    assert sys_.debug_last is None
    sys_.track_rgbd(*frames[0], timestamp=0.0)
    assert sys_.debug_last is None          # the initialization
    sys_.track_rgbd(*frames[1], timestamp=1 / 30)
    dbg = sys_.debug_last
    assert set(dbg) == {"tr_motion", "tr_local", "frame"}
    assert dbg["tr_motion"] is dbg["tr_local"]
    _device_tensors(dbg, sys_)
    sys_.reset()
    assert sys_.debug_last is None

    st = SlamSystem(_staged_cfg(), enable_objects=False, device="cpu")
    for i, f in enumerate(frames[:2]):
        st.track_rgbd(*f, timestamp=i / 30)
    dbg = st.debug_last
    assert set(dbg) == {"tr_motion", "tr_local", "T_pred", "frame"}
    assert dbg["tr_motion"] is not dbg["tr_local"]
    assert isinstance(dbg["T_pred"], torch.Tensor)
    _device_tensors(dbg, st)
    assert torch.equal(st.last_frame.Tcw, dbg["tr_local"].Tcw)

    # localization mode with the map points out of reach: VO survival
    vo = trk.track_motion_model_vo

    def no_map(*a, **kw):
        tr, n_map = vo(*a, **kw)
        return tr, torch.zeros_like(n_map)
    monkeypatch.setattr(trk, "track_motion_model_vo", no_map)
    st.enable_mapping = False
    st.track_rgbd(*frames[2], timestamp=2 / 30)
    dbg = st.debug_last
    assert set(dbg) == {"tr_motion", "tr_local", "T_pred", "frame"}
    assert dbg["tr_motion"] is dbg["tr_local"]
    _device_tensors(dbg, st)
    st.reset()
    assert st.debug_last is None


def test_tum_probe_mains_run_without_the_reference(tmp_path):
    """diag_poseopt, diag_retention (2 VGA frames, OSLAM_DUMP set),
    diag_replay and diag_gnsteps' main() on the CPU in a process where
    importing jax or object_slam_tpu raises; the replays read a dump of
    the reference's."""
    dump = tmp_path / "ref_dump.npz"
    with np.load(FIXTURE) as fxf:
        np.savez(dump, **_dump(fxf, 0))
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()),
               OSLAM_DUMP=str(tmp_path / "dumps"))
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
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "scripts")!r}]
        import diag_gnsteps_torch, diag_poseopt_torch, diag_replay_torch
        import diag_retention_torch
        cpu = ["--device", "cpu"]
        res = {{}}
        res["pose"] = diag_poseopt_torch.main(cpu)["n_valid"]
        res["ret"] = diag_retention_torch.main(["--frames", "2"] + cpu)[
            "summary"]
        res["replay"] = diag_replay_torch.main([{str(dump)!r}] + cpu)[
            "recorded"]
        res["gn"] = len(diag_gnsteps_torch.main([{str(dump)!r}] + cpu)[
            "steps"])
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "object_slam_tpu."))
                  or m == "object_slam_tpu"]
        print("RESULT " + json.dumps(dict(res, loaded=loaded)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["loaded"] == []
    assert res["pose"] == 500
    assert res["ret"]["frames"] == 2 and res["ret"]["tracked"] >= 1
    assert res["gn"] == 40
    assert "f=  1 tracked=" in proc.stdout
    assert "--- init from T_pred ---" in proc.stdout
    assert "after regate: active=" in proc.stdout
