"""scripts/train_vocab_torch.py against scripts/train_vocab.py on the CPU:
the harvest's descriptors on 1 scene x 2 poses bit for bit, and the
vocabulary trained from them (k=10, L=4, seed 0) written byte for byte,
against the reference's recorded in tests/torch_fixtures/vocab_train.npz
(make_reference.py vocab); the reference's full-size harvest trained by
the port, byte for byte the reference's file (chip_smoke.py holds the
card's harvest and training to the same fixture). Then the three offline
scripts of the port refuse to run without a card unless asked for the
CPU."""

import hashlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "vocab_train.npz")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    return _script("train_vocab_torch").harvest(
        n_scenes=1, n_poses=2, device="cpu", log=lambda *a: None)


def test_harvest_descriptors_bit_equal(small):
    fx = np.load(FIXTURE)
    assert small.dtype == np.uint32 and small.shape[1] == 8
    assert small.shape[0] == int(fx["small.n"]) > 1000
    assert np.array_equal(small, fx["small.desc"])


def test_trained_file_byte_equal(small, tmp_path):
    fx = np.load(FIXTURE)
    path = str(tmp_path / "voc.txt")
    voc = _script("train_vocab_torch").train(small, 10, 4)
    voc.save_dbow2_text(path)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == str(
            fx["small.sha256"])
    assert voc.n_words == 10 ** 4


# (scene, pose) of the full harvest's renders that held the reordered rows:
# FAST responses on either side of a quarter step of the lattice, from
# pyramid levels summed in another order than XLA:CPU sums jax.image.resize
# (features/pyramid.py, xla_resize.npz)
REORDERED_RENDERS = ((1, 2), (6, 1), (8, 3), (8, 7))


@pytest.mark.parametrize("scene,pose", REORDERED_RENDERS)
def test_harvest_render_equals_reference_rows(scene, pose):
    """The port's CPU extractor on one render of train_vocab.py's full
    harvest: its valid keypoints' descriptors equal the reference's rows
    of that render (vocab_train.npz "full.counts" splits "full.desc"), in
    order, bit for bit."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          loop_trajectory)
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    fx = np.load(FIXTURE)
    counts = fx["full.counts"]
    i = scene * 8 + pose
    lo = int(counts[:i].sum())
    ref = fx["full.desc"][lo:lo + int(counts[i])]
    cfg = SlamConfig.tum_rgbd()
    room = SyntheticScene.make(cfg, seed=scene, n_objects=2,
                               plane_z=3.2 + 0.3 * scene)
    gray = room.render_rgbd(loop_trajectory(8)[pose])[0]
    kp = OrbExtractor(cfg, device="cpu")(
        torch.from_numpy(np.asarray(gray, np.float32)))
    got = kp.desc.numpy().view(np.uint32)[kp.valid.numpy()]
    assert got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_full_size_training_byte_equal(tmp_path):
    """The reference's full harvest (10 scenes x 8 poses, 67,246
    descriptors) trained by the port: the reference's file byte for byte
    (the port's own harvest parts from it in 4 rows, keypoints on a
    rotation-bin boundary or the angle's stability gate, and so trains
    another tree)."""
    fx = np.load(FIXTURE)
    desc = fx["full.desc"]
    assert desc.shape == (int(fx["full.n"]), 8)
    path = str(tmp_path / "voc.txt")
    _script("train_vocab_torch").train(desc).save_dbow2_text(path)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == str(fx["full.sha256"])


@pytest.mark.parametrize("script,args", [
    ("train_vocab_torch.py", []),
    ("train_brief_pattern_torch.py", []),
    ("run_experiments_torch.py", ["--tum", "missing"])])
def test_scripts_need_a_card_or_the_cpu(script, args, tmp_path):
    """Without a card (this machine has none) each script stops with a
    clear error before any work, unless given --device cpu."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", script), "--out",
         str(tmp_path / "x")] + args, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "pass device='cpu'" in out.stderr
    assert not os.path.exists(tmp_path / "x")
