"""The port's pyramid at TUM VGA against the reference's, and the resize
pass that makes it on the CPU (features/pyramid.py::resize_taps).

The reference's levels are XLA:CPU's jax.image.resize under jit; its
weights and the order in which it sums each output's taps were recorded
once (make_reference.py xla_resize -> features/xla_resize.npz), with the
sha256 of the jitted pyramids of four renders (xla_resize_check.npz), so
no live XLA call is made here (XLA:CPU rounds as the compiling machine's
CPU does). Tolerance: none, every level bit for bit.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from object_slam_tpu_torch.config import SlamConfig
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      loop_trajectory)
from object_slam_tpu_torch.features import pyramid as pyr
from torch_fixtures.threads import share_cores

share_cores()

CHECK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_fixtures", "xla_resize_check.npz")


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("seed,pose", [(1, 0), (1, 1), (6, 0), (6, 1)])
def test_tum_vga_pyramid_equals_the_reference_levels(seed, pose):
    fx = np.load(CHECK)
    cfg = SlamConfig.tum_rgbd()
    room = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                               plane_z=3.2 + 0.3 * seed)
    gray = np.asarray(room.render_rgbd(loop_trajectory(8)[pose])[0],
                      np.float32)
    assert _sha(gray) == str(fx[f"{seed}_{pose}.gray_sha256"])
    levels = pyr.build_pyramid(torch.from_numpy(gray), 8, 1.2)
    want = fx[f"{seed}_{pose}.level_sha256"].tolist()
    assert [_sha(x.numpy()) for x in levels] == want


def test_passes_are_the_matrix_products_to_float_rounding():
    """Each pass computes the same weighted sum as the two products (the
    weights equal jax's to ~1 ulp; the order is XLA:CPU's): 1e-3 on 0..255
    at every level."""
    rng = np.random.RandomState(0)
    cur = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(
        np.float32))
    for hw in pyr.level_shapes(480, 640, 8, 1.2)[1:]:
        h, w = cur.shape
        nxt = pyr.resize_linear(cur, hw)
        wy = torch.from_numpy(pyr.resize_weights(h, hw[0]))
        wx = torch.from_numpy(pyr.resize_weights(w, hw[1]))
        assert nxt.shape == hw
        assert float((nxt - wy.T @ cur @ wx).abs().max()) <= 1e-3
        cur = nxt


def test_plans_only_for_recorded_sizes_and_the_cpu():
    """The plans cover the TUM-VGA pyramid's 14 products; other sizes take
    the matrix products, bit for bit."""
    shapes = pyr.level_shapes(480, 640, 8, 1.2)
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        assert ("rows", h0, h1, w0) in pyr._plans()
        assert ("cols", w0, w1, h1) in pyr._plans()
    assert len(pyr._plans()) == 14
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(0, 255, (376, 1241)).astype(
        np.float32))
    wy = torch.from_numpy(pyr.resize_weights(376, 313))
    wx = torch.from_numpy(pyr.resize_weights(1241, 1034))
    assert torch.equal(pyr.resize_linear(x, (313, 1034)), wy.T @ x @ wx)


def _plan(rounded, seed, n_in=37, n_out=30):
    rng = np.random.RandomState(seed)
    start = np.sort(rng.randint(0, n_in - 2, n_out)).astype(np.int32)
    w = rng.uniform(0, 1, (n_out, 3)).astype(np.float32)
    group = rng.randint(0, 2, (n_out, 3)).astype(np.int8)
    return start, w, group, rounded


@pytest.mark.parametrize("rounded", [False, True])
def test_taps_sum_each_group_in_order(rounded, monkeypatch):
    """resize_taps against its contract written out per output in numpy
    (float64 sums rounded to float32 at each step), both axes, on a
    random plan with both groups in any order."""
    start, w, group, _ = plan = _plan(rounded, seed=int(rounded))
    key = ("rows", 37, 30, 11)
    monkeypatch.setattr(pyr, "_plans", lambda: {key: plan})
    monkeypatch.setattr(pyr, "_plan_cache", {})
    rng = np.random.RandomState(5)
    x = rng.uniform(0, 255, (37, 11)).astype(np.float32)
    want = np.zeros((30, 11), np.float32)
    for o in range(30):
        acc = [np.zeros(11, np.float32), np.zeros(11, np.float32)]
        for s in range(3):
            k = min(int(start[o]) + s, 36)
            p = x[k].astype(np.float64) * np.float64(w[o, s])
            if rounded:
                p = p.astype(np.float32).astype(np.float64)
            acc[int(group[o, s])] = (p + acc[int(group[o, s])]).astype(
                np.float32)
        want[o] = acc[0] + acc[1]
    assert np.array_equal(pyr.resize_taps(torch.from_numpy(x), key,
                                          0).numpy(), want)
    assert np.array_equal(pyr.resize_taps(torch.from_numpy(x.T.copy()),
                                          key, 1).numpy(), want.T)


def test_the_reference_order_without_a_plan_raises():
    """order="xla" (the offline harvests' choice) never falls back to the
    products: at a size xla_resize.npz has no plan for (KITTI's first
    level) it raises, and an unknown order raises too."""
    x = torch.zeros((376, 1241))
    with pytest.raises(ValueError, match="no plan"):
        pyr.resize_linear(x, (313, 1034), "xla")
    with pytest.raises(ValueError, match="no plan"):
        pyr.build_pyramid(x, 8, 1.2, order="xla")
    with pytest.raises(ValueError, match="not one of"):
        pyr.resize_linear(x, (313, 1034), "products")


def test_the_reference_order_is_the_cpu_pyramid_and_the_harvests_take_it():
    """At TUM VGA order="xla" gives the CPU's levels bit for bit (the plan
    tensors built for the image's device), and both harvests' extractors
    ask for it; a tracking extractor keeps "auto"."""
    import importlib
    import sys
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.uniform(0, 255, (480, 640)).astype(
        np.float32))
    auto = pyr.build_pyramid(img, 8, 1.2)
    xla = pyr.build_pyramid(img, 8, 1.2, order="xla")
    assert all(torch.equal(a, b) for a, b in zip(auto, xla))
    assert OrbExtractor(SlamConfig.tum_rgbd(),
                        device="cpu").pyramid_order == "auto"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "scripts"))
    made = []
    real = OrbExtractor.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self.pyramid_order)
        raise StopIteration
    for name, fn in (("train_vocab_torch", "harvest"),
                     ("train_brief_pattern_torch", "harvest_patches")):
        mod = importlib.import_module(name)
        OrbExtractor.__init__ = spy
        try:
            with pytest.raises(StopIteration):
                getattr(mod, fn)(device="cpu")
        finally:
            OrbExtractor.__init__ = real
    assert made == ["xla", "xla"]
