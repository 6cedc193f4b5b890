"""The port's dataset tools against the JAX package's on the CPU:
datasets/synthetic.py::degrade_masks (draw for draw from the same
RandomState), datasets/tum.py::load_frame_arrays (the port's PNG reader
against the reference's PIL loader) and the two generators,
scripts/make_synth_tum_torch.py and make_synth_kitti_torch.py, against
scripts/make_synth_tum.py and make_synth_kitti.py on 3 frames (run in
subprocesses).

Tolerances: none. The masks and boxes equal the reference's, the loaded
arrays equal it bit for bit, every text file the generators write equals
the reference script's byte for byte and every PNG decodes (the port's
reader against PIL) to the reference's array (the PNG bytes differ: the
port's zlib writer)."""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from object_slam_tpu.datasets import synthetic as jsyn
from object_slam_tpu.datasets import tum as jtum
from object_slam_tpu_torch.datasets import png, tum
from object_slam_tpu_torch.datasets import synthetic as tsyn
from torch_fixtures import cases
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1])
def test_degrade_masks_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    M = cases.random_masks(rng, 6, h=60, w=80)
    M[4] = False                        # an empty mask
    V = np.array([True, True, False, True, True, True])
    got = tsyn.degrade_masks(M, V, np.random.RandomState(seed))
    want = jsyn.degrade_masks(M, V, np.random.RandomState(seed))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0][V & M.any((1, 2))].sum() > 0
    assert np.array_equal(got[0][~V], M[~V])
    # other options, the same draws
    got = tsyn.degrade_masks(M, V, np.random.RandomState(seed), shift=3,
                             hole_frac=0.1, block=4)
    want = jsyn.degrade_masks(M, V, np.random.RandomState(seed), shift=3,
                              hole_frac=0.1, block=4)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
def test_load_frame_arrays_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(3)
    shape = {"rgb": (24, 32, 3), "gray": (24, 32), "rgba": (24, 32, 4)}
    img = rng.randint(0, 256, shape[kind]).astype(np.uint8)
    depth = rng.randint(0, 65536, (24, 32)).astype(np.uint16)
    rgb_path, depth_path = str(tmp_path / "c.png"), str(tmp_path / "d.png")
    png.write_png(rgb_path, img)
    png.write_png(depth_path, depth)
    fr = tum.TumFrame(0.0, rgb_path, depth_path)
    jfr = jtum.TumFrame(0.0, rgb_path, depth_path)
    if kind == "rgba":
        # the reference's luma product takes three channels
        with pytest.raises(ValueError):
            jtum.load_frame_arrays(jfr, 5000.0)
        with pytest.raises(ValueError):
            tum.load_frame_arrays(fr, 5000.0)
        return
    got = tum.load_frame_arrays(fr, 5000.0)
    want = jtum.load_frame_arrays(jfr, 5000.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)
    assert got[2].shape == (24, 32, 3)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind,args", [
    ("tum", ["--frames", "3"]),
    ("tum", ["--frames", "3", "--traj", "loop", "--turns", "1.5",
             "--seed", "4"]),
    ("kitti", ["--frames", "3"])])
def test_generator_matches_jax_script(tmp_path, kind, args):
    """The port's generator and the reference's write the same files: the
    text byte for byte, every PNG decoded to the same array."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS=str(share_cores()))
    for script, out in ((f"make_synth_{kind}.py", "ref"),
                        (f"make_synth_{kind}_torch.py", "port")):
        subprocess.run([sys.executable, os.path.join(ROOT, "scripts", script),
                        "--out", str(tmp_path / out)] + args, check=True,
                       env=env, capture_output=True, timeout=600)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    files = _tree(ref)
    assert files == _tree(port)
    n_png = 0
    for f in files:
        a, b = os.path.join(ref, f), os.path.join(port, f)
        if f.endswith(".png"):
            want = np.asarray(Image.open(a))
            got = png.read_png(b)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
            n_png += 1
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f
    assert n_png >= 6
    if kind == "tum":
        # the semantic folder: one line and one mask per detected box
        assert any(f.startswith("semantic") and f.endswith("/0.png")
                   for f in files)
