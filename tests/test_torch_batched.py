"""The port's batched tracking (parallel/batched_tracking.py) against the
JAX package on the CPU: tests/test_batched.py's four sequences at its caps
(n_kp 128, 512 points, 8 keyframes, B = 4), a small map each and a frame
observing it from a moved camera, through JAX's vmapped BatchedTracker.step
(torch_fixtures/batched.npz, make_reference.py batched) and the port's.

Tolerance: kp_pt, inlier flags, match and inlier counts and the maps'
visibility counters exact; Tcw within atol 1e-5, rtol 1e-4 (the port's
tracking tests' tolerance: float32 pose solves in another order). Each
element is also held bit for bit to the port's own single-sequence
track_motion_model -> track_local_map."""

import os

import numpy as np
import pytest
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import CapacityConfig, SlamConfig
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.parallel.batched_tracking import (
    BatchedTracker, index_pytree, stack_pytrees)
from torch_fixtures.threads import share_cores

share_cores()

HERE = os.path.dirname(os.path.abspath(__file__))
FX = np.load(os.path.join(HERE, "torch_fixtures", "batched.npz"))
CFG = SlamConfig(caps=CapacityConfig(n_kp=128, max_points=512,
                                     max_keyframes=8))
B = 4


def _under(prefix):
    return {k[len(prefix) + 1:]: FX[k] for k in FX.files
            if k.startswith(prefix + ".") and
            not k[len(prefix) + 1:].startswith("obj.")}


@pytest.fixture(scope="module")
def batch():
    maps = interop.map_state_from_numpy(_under("maps"), device="cpu")
    frames = interop.frame_from_numpy(_under("frames"), CFG, device="cpu",
                                      obj=_under("frames.obj"))
    args = [torch.as_tensor(FX[k]) for k in
            ("last_uv", "last_pt", "last_level", "last_valid", "T_pred")]
    K = cam_mod.Intrinsics.from_config(CFG.camera)
    sf = torch.tensor([1.2 ** l for l in range(8)], dtype=torch.float32)
    bt = BatchedTracker(K, sf, 1.0 / (sf * sf), float(np.log(1.2)))
    res, maps2 = bt.step(maps, frames, *args)
    return bt, maps, frames, args, res, maps2


def test_shapes(batch):
    _, maps, _, _, res, maps2 = batch
    assert res.Tcw.shape == (B, 4, 4)
    assert res.kp_pt.shape == (B, CFG.caps.n_kp)
    assert maps2.pt_xyz.shape == maps.pt_xyz.shape
    # fields that tracking does not change stay the input's tensors
    assert maps2.pt_xyz is maps.pt_xyz


@pytest.mark.parametrize("field", ["kp_pt", "inlier", "n_matches",
                                   "n_inliers"])
def test_against_jax_exact(batch, field):
    res = batch[4]
    np.testing.assert_array_equal(getattr(res, field).numpy(),
                                  FX[f"res.{field}"])


def test_pose_against_jax(batch):
    res = batch[4]
    np.testing.assert_allclose(res.Tcw.numpy(), FX["res.Tcw"], atol=1e-5,
                               rtol=1e-4)
    assert (FX["res.n_inliers"] > 25).all()


@pytest.mark.parametrize("field", ["pt_visible", "pt_found"])
def test_map_counters_against_jax(batch, field):
    maps2 = batch[5]
    np.testing.assert_array_equal(getattr(maps2, field).numpy(),
                                  FX[f"out.{field}"])


@pytest.mark.parametrize("b", range(B))
def test_each_element_is_the_single_sequence_step(batch, b):
    bt, maps, frames, args, res, maps2 = batch
    r1, m1 = bt.one(index_pytree(maps, b), index_pytree(frames, b),
                    *[a[b] for a in args])
    for f in ("Tcw", "kp_pt", "inlier", "n_matches", "n_inliers"):
        assert torch.equal(getattr(r1, f), getattr(res, f)[b]), f
    assert torch.equal(m1.pt_visible, maps2.pt_visible[b])
    assert torch.equal(m1.pt_found, maps2.pt_found[b])


def test_swapped_maps_fail_the_check(batch):
    """The planted fault of chip_smoke.py's batched phase: two elements'
    maps swapped."""
    bt, maps, frames, args, _, _ = batch
    order = torch.tensor([1, 0, 2, 3])
    swapped = type(maps)(*[v[order] for v in maps])
    res, _ = bt.step(swapped, frames, *args)
    assert not np.array_equal(res.kp_pt.numpy(), FX["res.kp_pt"])


def test_stack_and_index_round_trip(batch):
    frames = batch[2]
    parts = [index_pytree(frames, b) for b in range(B)]
    again = stack_pytrees(parts)
    for a, b in zip(again.obj, frames.obj):
        assert torch.equal(a, b)
    assert torch.equal(again.desc, frames.desc)
    # the numpy form round-trips through interop as well
    arrays = interop.frame_to_numpy(frames)
    per = interop.unstack_numpy(arrays)
    assert len(per) == B
    back = interop.stack_numpy(per)
    np.testing.assert_array_equal(back["obj"]["masks"],
                                  arrays["obj"]["masks"])
    np.testing.assert_array_equal(back["desc"], FX["frames.desc"])
