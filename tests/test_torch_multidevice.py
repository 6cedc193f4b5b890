"""The multi-device scripts of scripts/ (ab_async_device_torch.py,
bench_ba_scaling_torch.py) and the async mapper's second-device branch
against the reference on the CPU.

- ab_async_device_torch.run at --scale 2 (320x240, 500 features, objects
  on) over the first 8 frames of its 120-frame circuit (cut from 16 for
  the tests' time: a frame takes 3-9 s at one thread, a keyframe and its
  mapping pass on nearly every frame; 8 keeps a merge lag above 0), sync
  then async
  with ready() pinned to "a pass is pending", each arm against the JAX
  script's run of the same frames on an 8-device CPU mesh (its async pass
  on the second device) and its 4 one-ulp noise runs, recorded in
  torch_fixtures/async_device.npz (make_reference.py ``async_device``),
  with the bands of torch_fixtures/multidevice_bands.py;
- the async arm again through _AsyncMapping's second-device branch with
  the CPU as both devices (the snapshot copied over, the result copied
  back), against the same record and bands; with the merge throwing the
  pass's result away (torch_fixtures/faults.py) it must miss;
- reset() with a pass in flight on that branch leaves no row of it;
- SlamSystem's choice of the pass's device by the card count;
- diag_async_split_torch's parting frame, and the record it reads: the
  pinned noise runs keep the main run's decisions at every depth, the
  120-frame runs with their own decisions (free<k>) are there;
- bench_ba_scaling_torch's problem against the reference's (at --kf 8
  --pts 512), its gloo CPU ranks at world sizes 1, 2 and 4 (3 iterations)
  against the JAX mesh runs of those sizes (torch_fixtures/scaling.npz)
  and their noise spreads, every rank bit-equal to rank 0, and a rank
  without the per-point all-reduce missing; its plan refusing a device
  that is not a card."""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from torch_fixtures import faults
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests", "torch_fixtures"))

import ab_async_device_torch as ab  # noqa: E402
import bench_ba_scaling_torch as scaling  # noqa: E402
import diag_async_split_torch as split  # noqa: E402
import multidevice_bands as mb  # noqa: E402
from ab_deviations_torch import build_cfg  # noqa: E402
from object_slam_tpu_torch.slam import system as tsys  # noqa: E402

FX = np.load(os.path.join(ROOT, "tests", "torch_fixtures",
                          "async_device.npz"))
SCALING = np.load(os.path.join(ROOT, "tests", "torch_fixtures",
                               "scaling.npz"))
N = 8
REF_KEYS = {"async", "mapping_device", "fps", "median_frame_ms",
            "ate_rmse_mm", "keyframes", "tracked", "frames_with_pending_pass",
            "merge_lag_frames_max", "merge_lag_frames_median"}


@pytest.fixture(scope="module")
def circuit():
    """The script's circuit at --scale 2, its first N frames rendered (the
    reference's renders, by their sums)."""
    cfg = build_cfg(2)
    args = ab.parse_args(["--device", "cpu"])
    rendered = ab.inputs(cfg, args, N)
    sums = [np.sum(g, dtype=np.float64) for g, _, _, _ in rendered[1]]
    np.testing.assert_array_equal(sums, FX[f"{N}.gray_sum"])
    return cfg, args, rendered


@pytest.fixture(scope="module")
def both_arms(circuit):
    cfg, args, rendered = circuit
    with ab.pinned_ready():
        return ab.run(cfg, args, rendered=rendered, log=lambda s: None)


def _arm(circuit, on_system):
    cfg, args, (poses, frames, sems) = circuit
    with ab.pinned_ready():
        return ab.run_arm(cfg, poses, frames, sems, True, "cpu", on_system)


@pytest.mark.parametrize("arm", ["sync", "async_dev1"])
def test_ab_async_device_arm_matches_reference(both_arms, arm):
    out, details = both_arms
    res = out[arm]
    assert out["n_devices"] == 1
    assert set(res) == REF_KEYS | {"mapping_placement"}
    assert res["mapping_device"] == "dev0"
    assert res["mapping_placement"] == ("cpu thread" if res["async"]
                                        else "cpu inline")
    bad = mb.misses(mb.arm_checks(FX, N, arm, res, details[arm]))
    assert not bad, bad


def test_cross_device_branch_matches_reference(circuit):
    """The async arm through the second-device branch (the copies made,
    the CPU on both sides) against the same record."""
    res, detail = _arm(circuit, ab.second_device)
    assert res["mapping_placement"] == "cpu (copied)"
    assert res["mapping_device"] == "dev0"
    bad = mb.misses(mb.arm_checks(FX, N, "async_dev1", res, detail))
    assert not bad, bad


def test_dropped_pass_result_misses(circuit):
    res, detail = _arm(circuit, faults.drop_async_result)
    assert mb.misses(mb.arm_checks(FX, N, "async_dev1", res, detail))


def test_reset_mid_pass_on_the_cross_device_branch():
    """reset() with a pass in flight on the second-device branch joins and
    drops it, as on the side-stream branch
    (test_reset_mid_pass_keeps_no_pre_reset_rows): a pass held in flight
    across the reset marks every point it returns; after the reset, new
    keyframes and their merges, no point of the map carries the mark."""
    from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                              OrbConfig, SlamConfig)
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    cfg = SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0), bf=13.0,
                            th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64))
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = tsys.SlamSystem(cfg, enable_objects=False, async_mapping=True,
                           device="cpu")
    ab.second_device(sys_)
    assert sys_._async.placement == "cpu (copied)"
    marker = -7777
    run = sys_._async.run
    held = {"on": True}

    def marked(m, kf_id, fast):
        res = run(m, kf_id, fast)
        if held["on"]:
            time.sleep(0.5)          # still in flight when reset() comes
            res = res._replace(pt_first_kf=torch.full_like(res.pt_first_kf,
                                                           marker))
        return res
    sys_._async.run = marked
    poses = orbit_poses(10, step=0.02)
    n = 0
    while sys_._async.pending is None:
        gray, depth, rgb, _ = scene.render_rgbd(poses[n])
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=n / 30.0)
        n += 1
    assert not sys_._async.pending[0].done()     # reset comes mid-pass
    sys_.reset()
    held["on"] = False
    assert sys_._async.pending is None and sys_._async.pending_kf == -1
    merges = sys_.mapping_stats["barrier_merges"]
    for i, T in enumerate(poses[n:]):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=(i + n) / 30.0)
    sys_.flush_mapping()
    sys_.shutdown()
    assert sys_.mapping_stats["barrier_merges"] > merges
    assert int(sys_.map.kf_valid.sum()) >= 2
    assert not bool(torch.any(sys_.map.pt_first_kf == marker))


def test_side_device_by_card_count(monkeypatch):
    """The pass's device: the second card when there are two or more (the
    first when the tracker is on the second), else none (a side stream of
    the tracker's card, or a thread on the CPU)."""
    pick = tsys.SlamSystem._side_device
    for count, home, want in ((1, 0, None), (2, 0, 1), (4, 0, 1),
                              (2, 1, 0)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        got = pick(types.SimpleNamespace(device=torch.device("cuda", home)))
        assert got == (None if want is None else torch.device("cuda", want))
    assert pick(types.SimpleNamespace(device=torch.device("cpu"))) is None
    sys_ = tsys.SlamSystem(build_cfg(4), async_mapping=True, device="cpu")
    assert sys_._async.device is None
    assert sys_._async.placement == "cpu thread"


def test_split_parts_at_and_the_record():
    a = {"inserts": [1, 2, 5], "lag": [-1, 0, 0, 1, 2, 0, 1]}
    assert split.parts_at(a, a) is None
    assert split.parts_at(a, dict(a, inserts=[1, 2, 4])) == 4
    assert split.parts_at(a, dict(a, lag=[-1, 0, 0, 1, 3, 0, 1])) == 4
    assert split.parts_at(a, dict(a, inserts=[1, 2, 5, 9])) is None
    for depth in (8, 16, 40, 120):
        ref = split.recorded(split.parse_args(["--depth", str(depth)]))
        assert {f"noise{k}" for k in range(mb.NOISE_RUNS)} <= set(ref)
        for k in range(mb.NOISE_RUNS):
            assert split.parts_at(ref[f"noise{k}"], ref["main"]) is None
    assert {f"free{k}" for k in range(mb.NOISE_RUNS)} <= set(ref)
    assert split.recorded(split.parse_args(["--scale", "4"])) is None


def _scaling_args(*extra):
    n_kf, n_pt, iters = (int(x) for x in SCALING["size"])
    return scaling.parse_args(["--kf", str(n_kf), "--pts", str(n_pt),
                               "--iters", str(iters), "--reps", "1"]
                              + list(extra))


def test_scaling_problem_is_the_reference():
    args = _scaling_args()
    _, arrays = scaling.problem(args.kf, args.pts)
    assert not mb.problem_misses(SCALING, arrays)
    np.testing.assert_array_equal(arrays["obs_kf"],
                                  np.repeat(np.arange(args.kf),
                                            args.pts // 4))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_scaling_ranks_against_jax_mesh(world):
    args = _scaling_args("--cpu-mesh", "4")
    lines, results = scaling.run(args, sizes=[world], log=lambda s: None)
    assert len(results[world]) == world
    want, spread = mb.mesh_reference(SCALING, world)
    checks = mb.scaling_checks(results[world], want, spread,
                               f"against the JAX mesh of {world}")
    assert all(c[3] for c in checks), checks
    line = lines[0]
    assert line["devices"] == world and line["backend"] == "gloo"
    assert line["obs"] == args.kf * (args.pts // 4)
    assert line["ranks_per_card"] is None
    assert line["ba_iters_per_s"] > 0 and line["scaling_efficiency"] == 1.0


def test_scaling_rank_without_point_reduce_misses():
    args = _scaling_args("--cpu-mesh", "4")
    _, results = scaling.run(args, sizes=[2], setup=faults.skip_point_reduce,
                             log=lambda s: None)
    want, spread = mb.mesh_reference(SCALING, 2)
    checks = mb.scaling_checks(results[2], want, spread)
    assert not all(c[3] for c in checks), checks


def test_scaling_plan_takes_only_cuda_devices():
    with pytest.raises(ValueError, match="--cpu-mesh"):
        scaling.plan(scaling.parse_args(["--device", "cpu"]))
    assert scaling.plan(scaling.parse_args(["--cpu-mesh", "2"])) == (
        "cpu", "gloo", [1, 2], None)
