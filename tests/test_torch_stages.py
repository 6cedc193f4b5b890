"""The single-card stage timers of scripts/ (diag_ba_profile_torch.py,
diag_kitti_stages_torch.py, diag_fullpipe_torch.py) against the reference
on the CPU.

The scripts print milliseconds, which no CPU test can hold, so each is
held by what its timed calls compute, against the reference's runs
recorded in torch_fixtures/stages.npz (make_reference.py ``stages``) with
the bands of torch_fixtures/stage_bands.py:
- the BA profile's seven variants of ba_iterate on diag_ba_profile.py's
  problem (6 keyframes x 64 observations, 256 points; the same numpy
  problem, hash held), each against the JAX ba_iterate and its four
  one-ulp noise runs; the port's scatter forms (block_n=None,
  pt_obs_slot=None) also against its own blocked and slot forms, and with
  a sharded slab's all-reduce hook at world size 1 (gloo) bit for bit
  against no hook, at world size 2 (two spawned gloo ranks) within the
  scatter variant's band of no hook;
- the KITTI stage timer on 12 frames of the small street (street.py's
  416x128 geometry), the reference's keyframe decisions replayed: the
  map's census after the drive and each stage's counts (the tracking
  step's flags and the keyframe counts with no floor);
- the full-pipeline timer on 16 frames of bench.py's room at the 160x120
  verify geometry: the bytes line, flags, keyframes, poses (2 mm, 0.1
  deg) and the reference's profiler spans;
- a planted fault for each (torch_fixtures/faults.py), which must miss;
- the three mains in a process where importing jax or object_slam_tpu
  raises."""

import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_fixtures import faults, stage_bands
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "stages.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))

import diag_ba_profile_torch as ba_profile  # noqa: E402
import diag_fullpipe_torch as fullpipe  # noqa: E402
import diag_kitti_stages_torch as kitti_stages  # noqa: E402
import object_slam_tpu_torch.config as tconfig  # noqa: E402
import street  # noqa: E402
from object_slam_tpu_torch import interop  # noqa: E402
from object_slam_tpu_torch.geometry.camera import Intrinsics  # noqa: E402
from object_slam_tpu_torch.parallel import distributed, sharded_ba  # noqa: E402
from object_slam_tpu_torch.parallel.sharded_ba import ObsShard  # noqa: E402
from object_slam_tpu_torch.solvers import ba as t_ba  # noqa: E402

BA_SMALL = (6, 64, 256)            # make_reference.py STAGE_BA_SIZES
KITTI_FRAMES = 12
FULLPIPE_FRAMES = 16
NAMES = [v[0] for v in ba_profile.VARIANTS]
SCATTER = 0                        # the scatter variant's index


def small_cfg():
    """make_reference.py's small_cfg with the default (pipelined) readback,
    as diag_fullpipe.py runs SlamConfig.tum_rgbd()."""
    c = tconfig
    return c.SlamConfig(
        camera=c.CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                              cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                              bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=c.OrbConfig(n_features=300, n_levels=4),
        caps=c.CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64))


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def ba_runs():
    return ba_profile.run(tconfig.SlamConfig.kitti_stereo(), *BA_SMALL,
                          device="cpu", reps=0, log=lambda s: None)


def _record(runs, name):
    arrays, _ = runs["problem"]
    r = runs[name]
    return stage_bands.ba_record(arrays["pt_xyz"], r["kf_pose"].numpy(),
                                 r["pt_xyz"].numpy(), r["cost"])


def test_problem_is_the_reference_scripts(fx, ba_runs):
    arrays, slot = ba_runs["problem"]
    assert stage_bands.problem_hash(arrays, slot) == \
        str(fx["ba_small.main.problem_hash"])
    assert arrays["obs_valid"].sum() > 0 and (slot >= 0).sum() == \
        arrays["obs_valid"].sum()


@pytest.mark.parametrize("i", range(len(NAMES)), ids=[
    n.replace(" ", "").replace("=", "") for n in NAMES])
def test_ba_variant_matches_reference(fx, ba_runs, i):
    got = _record(ba_runs, NAMES[i])
    assert stage_bands.ba_misses(got, fx, "small", i) == []


@pytest.mark.parametrize("other", [1, 5])
def test_scatter_form_matches_blocked_forms(fx, ba_runs, other):
    """The scatter variant against the blocked (per-keyframe axis sums)
    and the blocked + slot variants of the same LM and CG iterations,
    within the scatter variant's band."""
    got = _record(ba_runs, NAMES[SCATTER])
    assert stage_bands.ba_pair_misses(
        got, _record(ba_runs, NAMES[other]), fx, "small", SCATTER) == []


@pytest.fixture()
def group_of_one(tmp_path):
    assert distributed.maybe_initialize_distributed(
        "file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    yield distributed.global_group()
    dist.destroy_process_group()


@pytest.mark.parametrize("blocked", [False, True])
def test_scatter_forms_with_comm_at_world_size_one(group_of_one, blocked):
    """The scatter forms' per-point sums (and, unblocked, the per-keyframe
    sums) handed to a world-size-1 gloo group's all-reduce: bit for bit
    the result without the hook."""
    W, N, L = BA_SMALL
    K = Intrinsics.from_config(tconfig.SlamConfig.kitti_stereo().camera)
    arrays, _ = ba_profile.build_problem(K, W, N, L)
    prob = interop.ba_problem_from_numpy(arrays, device="cpu")
    block_n = N if blocked else None
    comm = ObsShard(group_of_one, torch.arange(W), W)
    kf0, pt0 = t_ba.ba_iterate(K, prob, 5, block_n=block_n, pt_obs_slot=None)
    kf1, pt1 = t_ba.ba_iterate(K, prob, 5, block_n=block_n, pt_obs_slot=None,
                               comm=comm)
    assert torch.equal(kf0, kf1) and torch.equal(pt0, pt1)


@pytest.mark.parametrize("blocked", [False, True])
def test_scatter_forms_with_comm_at_world_size_two(fx, blocked):
    """The scatter forms over two gloo ranks, each holding the rows of its
    keyframes (sharded_ba's split) and handing its sums to the all-reduce:
    every rank the same result, within the scatter variant's band of the
    result without the hook on one process."""
    W, N, L = BA_SMALL
    K = Intrinsics.from_config(tconfig.SlamConfig.kitti_stereo().camera)
    arrays, _ = ba_profile.build_problem(K, W, N, L)
    outs = sharded_ba.spawn_sharded_global_ba(
        K, arrays, 2, block_n=N, n_iters=5, device="cpu", timeout_s=120,
        setup=functools.partial(stage_bands.scatter_forms, blocked=blocked))
    for o in outs[1:]:
        np.testing.assert_array_equal(o["kf_pose"], outs[0]["kf_pose"])
        np.testing.assert_array_equal(o["pt_xyz"], outs[0]["pt_xyz"])
    assert all(o["live"] > 0 for o in outs)
    prob = interop.ba_problem_from_numpy(arrays, device="cpu")
    kf, pt = t_ba.ba_iterate(K, prob, 5, block_n=N if blocked else None,
                             pt_obs_slot=None)
    prob_kf, prob_pt = (torch.from_numpy(outs[0]["kf_pose"]),
                        torch.from_numpy(outs[0]["pt_xyz"]))

    def record(kf_pose, pt_xyz):
        cost = float(t_ba._robust_cost(K, prob, kf_pose, pt_xyz, 5.991,
                                       7.815, block_n=None))
        return stage_bands.ba_record(arrays["pt_xyz"], kf_pose.numpy(),
                                     pt_xyz.numpy(), cost)
    assert stage_bands.ba_pair_misses(record(prob_kf, prob_pt),
                                      record(kf, pt), fx, "small",
                                      SCATTER) == []


def test_scatter_over_keyframes_fails(fx):
    """The planted fault: the per-point scatter sums taken over obs_kf."""
    undo = faults.scatter_points_over_keyframes()
    try:
        runs = ba_profile.run(tconfig.SlamConfig.kitti_stereo(), *BA_SMALL,
                              device="cpu", reps=0, variants=[NAMES[SCATTER]],
                              log=lambda s: None)
    finally:
        undo()
    bad = stage_bands.ba_misses(_record(runs, NAMES[SCATTER]), fx, "small",
                                SCATTER)
    assert any(k == "cost" for k, *_ in bad)


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory, fx):
    """The reference's 12 small street pairs as KITTI files, written by the
    port from its renders (they equal the reference's renders)."""
    from object_slam_tpu_torch.datasets import kitti
    from object_slam_tpu_torch.datasets.synthetic import render_street
    cfg = street.stereo_cfg(tconfig)
    poses, frames, _ = render_street(cfg, KITTI_FRAMES, workers=2)
    out = str(tmp_path_factory.mktemp("kitti_stages"))
    kitti.write_sequence(out, poses, frames)
    gl = kitti.load_frame_arrays(kitti.load_sequence(out)[-1])[0]
    assert float(np.sum(gl, dtype=np.float64)) == \
        float(fx["kitti_small.main.gray_sum"])
    return cfg, out


@pytest.fixture(scope="module")
def kitti_drive(fx, kitti_seq):
    """The drive with the reference's keyframe decisions replayed; the
    planted fault's hook keeps a copy of the map before the 12th frame
    (the drive itself unchanged)."""
    cfg, seq = kitti_seq
    kfs = [int(x) for x in fx["kitti_small.main.kf_frames"]]
    hook, swap = faults.stage_map_before_last_frame(KITTI_FRAMES)
    state = kitti_stages.drive(cfg, seq, "cpu", KITTI_FRAMES, kfs, hook)
    yield state, swap
    state["sys"].shutdown()


def test_kitti_stages_match_reference(fx, kitti_drive):
    """The eleven stages after the drive: the map's census and each stage's
    counts within their bands; the stages leave the map as they found
    it."""
    state, _ = kitti_drive
    res = kitti_stages.time_stages(state, reps=0, log=lambda s: None)
    assert list(res["stages"]) == list(kitti_stages.STAGES)
    assert state["kf_frames"] == fx["kitti_small.main.kf_frames"].tolist()
    assert res["map_unchanged"]
    assert stage_bands.kitti_misses(res, fx, "small") == []
    assert all(v["ms"] > 0 for v in res["stages"].values())


def test_kitti_stages_on_the_map_before_the_last_frame_fail(fx, kitti_drive):
    """The planted fault: the stages run on the map from before the 12th
    frame (two of them timed; the census misses)."""
    state, swap = kitti_drive
    res = kitti_stages.time_stages(swap(state), reps=0,
                                   stages=("covisibility", "cull_points"),
                                   log=lambda s: None)
    bad = stage_bands.kitti_misses(res, fx, "small")
    assert any(k.startswith("map.") for k, *_ in bad)


def test_kitti_fused_stage_with_inverted_keyframe_decision_fails(
        fx, kitti_drive):
    """The planted fault: the tracking step's keyframe decision negated
    (the fused stage timed alone); its flags, held with no floor, miss."""
    state, _ = kitti_drive
    undo = faults.inverted_keyframe_decision()
    try:
        res = kitti_stages.time_stages(state, reps=0, stages=("fused",),
                                       log=lambda s: None)
    finally:
        undo()
    bad = {k for k, *_ in stage_bands.kitti_misses(res, fx, "small")}
    assert {"fused.need_kf", "fused.need_kf_hard"} <= bad


def test_fullpipe_matches_reference(fx):
    res = fullpipe.run(small_cfg(), FULLPIPE_FRAMES, device="cpu",
                       log=lambda s: None)
    assert stage_bands.fullpipe_misses(res, fx, "small") == []
    assert res["tracked"].all() and len(res["build_ms"]) == FULLPIPE_FRAMES
    assert "track.fused" in res["report"]


def test_fullpipe_with_packed_semantic_bytes_fails(fx):
    """The planted fault: the semantic arrays counted bit-packed (the
    bytes line read on a run one frame past the script's warm-up)."""
    undo = faults.packed_semantic_bytes(fullpipe)
    try:
        res = fullpipe.run(small_cfg(), fullpipe.WARMUP + 1, device="cpu",
                           log=lambda s: None)
    finally:
        undo()
    assert any(m.startswith("bytes")
               for m in stage_bands.fullpipe_misses(res, fx, "small"))


def test_stage_mains_run_without_the_reference(tmp_path, kitti_seq):
    """diag_ba_profile_torch (the small problem, --print-launches, which
    prints nothing more on the CPU) and diag_fullpipe_torch (5 frames)
    main(), and diag_kitti_stages_torch's CLI and run() (the first 2
    street pairs, each stage called once) on the CPU, at the small
    geometries, in a process where importing jax or object_slam_tpu
    raises."""
    seq = tmp_path / "seq2"
    shutil.copytree(kitti_seq[1], seq)
    times = open(seq / "times.txt").read().split()
    (seq / "times.txt").write_text("\n".join(times[:2]) + "\n")
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()))
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
                        {os.path.join(ROOT, "tests")!r},
                        {os.path.join(ROOT, "tests", "torch_fixtures")!r}]
        import object_slam_tpu_torch.config as config
        import street
        stereo = street.stereo_cfg(config)
        tum = config.SlamConfig(
            camera=config.CameraConfig(
                width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                dist=(0, 0, 0, 0, 0), bf=13.0, th_depth=40.0,
                depth_map_factor=1.0),
            orb=config.OrbConfig(n_features=300, n_levels=4),
            caps=config.CapacityConfig(n_kp=384, max_points=8192,
                                       max_keyframes=64))
        config.SlamConfig.kitti_stereo = staticmethod(lambda: stereo)
        config.SlamConfig.tum_rgbd = staticmethod(lambda: tum)
        import diag_ba_profile_torch, diag_fullpipe_torch
        import diag_kitti_stages_torch
        cpu = ["--device", "cpu"]
        res = {{}}
        ba = diag_ba_profile_torch.main(
            ["--wtot", "6", "--n", "64", "--lp", "256",
             "--print-launches"] + cpu)
        res["ba"] = sorted(k for k in ba if k != "problem")
        args = diag_kitti_stages_torch.parse_args([{str(seq)!r}] + cpu)
        res["kitti"] = diag_kitti_stages_torch.run(
            config.SlamConfig.kitti_stereo(), args.seq, device=args.device,
            reps=0)["map"]
        fp = diag_fullpipe_torch.main(["--frames", "5"] + cpu)
        res["fullpipe"] = [int(x) for x in fp["bytes"]]
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
    assert res["ba"] == sorted(NAMES)
    assert res["kitti"]["kfs"] >= 1 and res["kitti"]["pts"] > 0
    assert res["fullpipe"][0] > 0 and \
        res["fullpipe"][1:] == [160 * 120 * 2, 160 * 120 * 3]
    out = proc.stdout
    for name in NAMES:
        assert f"{name:44s} " in out and " ms" in out
    assert "launches per call" not in out
    for name in kitti_stages.STAGES:
        assert f"\n{name:20s} " in out
    assert "sem arrays per frame: " in out and "build: median " in out
    assert "track.fused" in out
