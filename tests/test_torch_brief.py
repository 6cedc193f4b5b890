"""scripts/train_brief_pattern_torch.py against scripts/train_brief_pattern.py
on the CPU: candidate_positions and the candidate tests exactly,
rotate_patches (the reference's f32 grid and float64 blend) bit for bit
on random patches, harvest_patches at 800 patches (one render) against the
reference's harvest recorded in tests/torch_fixtures/brief.npz
(make_reference.py brief), and the selection (TestSelector) on a
2000-patch integer corpus (brief_cases.integer_corpus, the same on every
machine) in the reference's scan order against the pattern its main()
chose on it.

Tolerances: the harvest's per-level patch counts equal; each patch within
1e-2 of the reference's (its sums 1e-2 relative): the port's IC angles
and subpixel positions differ from the reference's in the last float
bits, which the rotation's bilinear weights carry. The selection: the
pattern row for row, the quality numbers within 1e-6."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_fixtures import brief_cases
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "brief.npz")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _script("train_brief_pattern_torch")


@pytest.fixture(scope="module")
def ref():
    return _script("train_brief_pattern")


def test_candidates_exact(port, ref):
    pos = port.candidate_positions()
    assert np.array_equal(pos, ref.candidate_positions())
    assert pos.shape == (529, 2)
    ia, ib = port.candidate_tests(pos.shape[0])
    assert ia.shape[0] > 60000 and (ia < ib).all()
    assert np.unique(ia * 1000 + ib).shape[0] == ia.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_rotate_patches_matches_reference(port, ref, seed):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0, 255, (300, 32, 32)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    want = ref.rotate_patches(p, -ang)
    got = port.rotate_patches(torch.from_numpy(p), -ang)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5
    assert np.array_equal(got.numpy(), want)


def test_harvest_patches_matches_reference(port):
    fx = np.load(FIXTURE)
    calls = []
    got = port.harvest_patches(800, device="cpu", levels_out=calls)
    assert got.shape == (800, 32, 32) and got.dtype == torch.float64
    sums = got.reshape(800, -1).sum(1).numpy()
    want = fx["harvest.sums"]
    assert np.max(np.abs(sums - want) / np.abs(want)) < 1e-2
    head = fx["harvest.head"]
    assert np.max(np.abs(got[:head.shape[0]].numpy() - head)) < 1e-2
    # the full harvest's calls begin with these: the same per-level counts
    # (one extract_patches_levels call per render, a level slot per window)
    ref_calls = fx["full.calls"]
    got_calls = [[int(b[l].shape[0]), int((lv == l).sum())]
                 for b, _, _, lv, _ in calls for l in range(len(b))
                 if int((lv == l).sum())]
    assert len(calls) == 1
    assert got_calls == ref_calls[:len(got_calls)].tolist()


def test_select_tests_matches_reference_main(port):
    """The reference's main() on the integer corpus (harvest swapped, the
    save intercepted) against TestSelector on the same corpus."""
    fx = np.load(FIXTURE)
    corpus = torch.from_numpy(brief_cases.integer_corpus(2000))
    sel = port.TestSelector(corpus)
    # the scan order is numpy's unstable argsort of the recorded run: its
    # order among equal keys is the host's numpy's, so the run's is
    # replayed (the means it sorts are checked through it)
    order = fx["corpus2000.order"]
    assert np.array_equal(np.sort(np.abs(sel.mean_np - 0.5)),
                          np.abs(sel.mean_np - 0.5)[order])
    chosen, at = sel.select(order=order, log=lambda *a: None)
    pattern = sel.pattern(chosen)
    want = fx["corpus2000.pattern"]
    assert pattern.dtype == np.float32 and pattern.shape == (256, 4)
    assert np.array_equal(pattern, want)
    assert np.array_equal(sel.pattern_tests(want), chosen)
    assert np.allclose(sel.quality(chosen), fx["corpus2000.quality"],
                       rtol=0, atol=1e-6)
    assert at[0] == port.THRESH0 and (np.diff(at) >= 0).all()
