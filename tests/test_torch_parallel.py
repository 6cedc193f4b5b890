"""The port's observation-sharded global BA (parallel/sharded_ba.py) against
the JAX package on the CPU.

The problem is tests/test_parallel.py's (tests/test_solvers.py::
build_ba_problem: 5 keyframes, 200 points, noise 0.2; its observations
are in keyframe-major blocks of 200), with the JAX package's unsharded
ba_iterate and its run_sharded_global_ba on a 2-device mesh recorded in
torch_fixtures/parallel.npz (make_reference.py parallel). The port runs
over 1, 2 and 3 gloo ranks started with the spawn method (3 ranks pad
the 5 keyframes to 6), each run under a timeout so that ranks that part
fail instead of hanging.

Tolerance: poses within 1e-4 and points within 1e-3 (max abs) of both
JAX results, every rank returning the same result bit for bit. The port
itself moves that far with nothing but the summation order changed: its
single-process global BA at 8 CPU threads lands 3.4e-5 (poses) and
2.8e-4 (points) from JAX's, at 1 thread 2e-7 and 1.2e-5, as the LM's
accept and exit decisions follow the rounding; the sharded runs read up
to 3.3e-5 and 2.8e-4. A rank that keeps its own per-point partial sums
(torch_fixtures/faults.py) lands 0.23 and 3.0 away. World size 1 is held bit for bit to the port's own global_ba in
the same process."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import SlamConfig
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.parallel import distributed, sharded_ba
from object_slam_tpu_torch.solvers import ba as t_ba
from torch_fixtures import faults, loop_cases
from torch_fixtures.threads import share_cores

share_cores()

HERE = os.path.dirname(os.path.abspath(__file__))
FX = np.load(os.path.join(HERE, "torch_fixtures", "parallel.npz"))
PROB = {k[len("prob."):]: FX[k] for k in FX.files if k.startswith("prob.")}
K = Intrinsics.from_config(SlamConfig().camera)
BLOCK_N = 200
ITERS = 5
POSE_TOL, POINT_TOL = 1e-4, 1e-3
TIMEOUT_S = 120


def _held(kf_pose, pt_xyz, ref):
    return (float(np.abs(kf_pose - FX[f"{ref}.kf_pose"]).max()),
            float(np.abs(pt_xyz - FX[f"{ref}.pt_xyz"]).max()))


def test_fixture_is_build_ba_problem():
    """The recorded problem is the blocked layout the port shards."""
    assert PROB["kf_pose"].shape == (5, 4, 4)
    np.testing.assert_array_equal(
        PROB["obs_kf"], np.repeat(np.arange(5), BLOCK_N))
    assert 0 < PROB["obs_valid"].sum() < PROB["obs_valid"].size


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_global_ba_against_jax(world):
    outs = sharded_ba.spawn_sharded_global_ba(
        K, PROB, world, block_n=BLOCK_N, n_iters=ITERS, device="cpu",
        timeout_s=TIMEOUT_S)
    for r, o in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(o["kf_pose"], outs[0]["kf_pose"],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(o["pt_xyz"], outs[0]["pt_xyz"],
                                      err_msg=f"rank {r}")
    kf, pt = outs[0]["kf_pose"], outs[0]["pt_xyz"]
    assert kf.shape == (5, 4, 4)
    for ref in ("ref", "shard2"):
        e_kf, e_pt = _held(kf, pt, ref)
        assert e_kf <= POSE_TOL and e_pt <= POINT_TOL, (ref, e_kf, e_pt)
    # the solver moved the perturbed problem
    assert np.abs(kf - PROB["kf_pose"]).max() > 1e-3


def test_a_rank_without_the_point_reduction_fails_the_check():
    outs = sharded_ba.spawn_sharded_global_ba(
        K, PROB, 2, block_n=BLOCK_N, n_iters=ITERS, device="cpu",
        timeout_s=TIMEOUT_S, setup=faults.skip_point_reduce)
    for o in outs:
        e_kf, e_pt = _held(o["kf_pose"], o["pt_xyz"], "ref")
        assert e_kf > POSE_TOL or e_pt > POINT_TOL


@pytest.fixture
def group_of_one(tmp_path, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize_distributed(
        "file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    yield distributed.global_group()
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["build_ba_problem", "loop_ba_case"])
def test_world_size_one_is_bit_identical(group_of_one, case):
    if case == "build_ba_problem":
        arrays, block_n = PROB, BLOCK_N
    else:
        arrays, block_n = loop_cases.ba_case(), 64
    prob = interop.ba_problem_from_numpy(arrays, device="cpu")
    kf0, pt0 = t_ba.global_ba(K, prob, ITERS, block_n=block_n)
    kf1, pt1 = sharded_ba.run_sharded_global_ba(K, prob, ITERS,
                                                block_n=block_n)
    assert torch.equal(kf0, kf1) and torch.equal(pt0, pt1)


def test_pad_obs_to():
    prob = interop.ba_problem_from_numpy(PROB, device="cpu")
    assert sharded_ba.pad_obs_to(prob, 5, BLOCK_N) is prob
    p = sharded_ba.pad_obs_to(prob, 3, BLOCK_N)
    assert p.kf_pose.shape == (6, 4, 4) and p.obs_kf.shape == (6 * BLOCK_N,)
    torch.testing.assert_close(p.kf_pose[5], torch.eye(4))
    assert bool(p.kf_fixed[5]) and not bool(p.kf_valid[5])
    pad = slice(5 * BLOCK_N, None)
    assert torch.equal(p.obs_kf[pad], torch.full((BLOCK_N,), 5,
                                                 dtype=p.obs_kf.dtype))
    assert not p.obs_valid[pad].any()
    assert torch.equal(p.obs_ur[pad], torch.full((BLOCK_N,), -1.0))
    for f in t_ba.BAProblem._fields:
        a, b = getattr(prob, f), getattr(p, f)
        assert torch.equal(b[:a.shape[0]], a), f
    # the padded keyframe carries no observation: the solve is the same
    kf0, pt0 = t_ba.global_ba(K, prob, ITERS, block_n=BLOCK_N)
    kf1, pt1 = t_ba.global_ba(K, p, ITERS, block_n=BLOCK_N)
    torch.testing.assert_close(kf1[:5], kf0, atol=POSE_TOL, rtol=0)
    torch.testing.assert_close(pt1, pt0, atol=POINT_TOL, rtol=0)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_keyframes_deal_live_observations(world):
    """Every keyframe on one rank, ascending, as many per rank; with only
    the first keyframes valid (a map fills its slots from the front) each
    rank still gets live observations."""
    arrays = dict(PROB)
    arrays["kf_valid"] = np.arange(5) < 3          # keyframes 3, 4 empty
    prob = sharded_ba.pad_obs_to(
        interop.ba_problem_from_numpy(arrays, device="cpu"), world, BLOCK_N)
    n_kf = prob.kf_pose.shape[0]
    deal = [sharded_ba.shard_keyframes(prob, world, r, BLOCK_N)
            for r in range(world)]
    assert sorted(torch.cat(deal).tolist()) == list(range(n_kf))
    for ids in deal:
        assert ids.shape[0] == n_kf // world
        assert torch.equal(ids, torch.sort(ids).values)
    live = [int((s.obs_valid & prob.kf_valid[s.obs_kf.long()]).sum())
            for s in (sharded_ba.shard_problem(prob, ids, BLOCK_N)
                      for ids in deal)]
    assert sum(live) == int((prob.obs_valid
                             & prob.kf_valid[prob.obs_kf.long()]).sum())
    assert min(live) > 0
    if world == 1:
        for f in ("obs_kf", "obs_uv", "obs_valid"):
            assert torch.equal(getattr(sharded_ba.shard_problem(
                prob, deal[0], BLOCK_N), f), getattr(prob, f))


def test_no_distributed_without_configuration(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    assert distributed.global_group() is None
    with pytest.raises(RuntimeError, match="process group"):
        sharded_ba.make_sharded_ba(K, block_n=BLOCK_N)
