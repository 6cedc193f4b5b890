"""The port's native host runtime (native/oslam_host.cpp over zlib, built
at first use into build/native/) against the JAX package's
(object_slam_tpu/native, over libpng) on the same files: decode_image
and FramePrefetcher give equal arrays, dtypes and shapes (exact: both
decode losslessly) for 8-bit RGB, 16-bit gray depth, 0/255 masks and the
other PNG kinds libpng reduces (RGBA, gray + alpha, palette, 1-bit), in
order, out of order, and a missing file raising; plus what the port adds
(a second get of one id raises instead of waiting forever, a source that
does not compile raises with the compiler's message, JPEG is refused),
and scripts/run_tum_torch.py on a 3-frame TUM-format directory (whose
files the prefetcher, at the driver's settings, decodes as the port's PNG
reader does) through the prefetcher and with --viz-dir."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from object_slam_tpu.native import loader as jnative
from object_slam_tpu_torch.datasets import png
from object_slam_tpu_torch.native import loader as native
from torch_fixtures.threads import share_cores

THREADS = share_cores()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["rgb8", "gray16", "mask", "rgba", "gray_alpha", "palette", "bit1"]


def _write(path, kind, rng, h=48, w=64):
    """A PNG of one kind (PIL's encoder: another encoder than the port's
    writer); returns the array a decoder without alpha should give, or
    None where PIL's own conversion decides it."""
    from PIL import Image
    if kind == "rgb8":
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(a).save(path)
    elif kind == "gray16":
        a = rng.randint(0, 60000, (h, w)).astype(np.uint16)
        Image.fromarray(a).save(path)
    elif kind == "mask":
        a = ((rng.rand(h, w) > 0.5) * 255).astype(np.uint8)
        Image.fromarray(a).save(path)
    elif kind == "rgba":
        a = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        Image.fromarray(a).save(path)
        a = a[..., :3]
    elif kind == "gray_alpha":
        a = rng.randint(0, 256, (h, w, 2)).astype(np.uint8)
        Image.fromarray(a, mode="LA").save(path)
        a = a[..., 0]
    elif kind == "palette":
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(a).convert("P").save(path)
        a = None
    elif kind == "bit1":
        a = ((rng.rand(h, w) > 0.5) * 255).astype(np.uint8)
        Image.fromarray(a).convert("1").save(path)
    return a


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(0)
    return {k: (str(d / f"{k}.png"), _write(str(d / f"{k}.png"), k, rng))
            for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_decode_image_matches_jax(images, kind):
    path, want = images[kind]
    got, ref = native.decode_image(path), jnative.decode_image(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "mask"])
def test_decode_image_matches_the_port_reader(images, kind):
    path, _ = images[kind]
    np.testing.assert_array_equal(native.decode_image(path),
                                  png.read_png(path))


def _run(mod, images, order, masks):
    (p_rgb, _), (p_dep, _) = images["rgb8"], images["gray16"]
    pf = mod.FramePrefetcher(n_workers=2, capacity=3)
    for fid in range(6):
        pf.submit(fid, p_rgb, p_dep, [images[k][0] for k in masks])
    out = {fid: pf.get(fid) for fid in order}
    pf.close()
    return out


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4, 5], [4, 0, 5, 2, 1, 3]],
                         ids=["in_order", "out_of_order"])
def test_prefetcher_matches_jax(images, order):
    masks = ["mask", "bit1"]
    got = _run(native, images, order, masks)
    ref = _run(jnative, images, order, masks)
    for fid in order:
        (r, d, ms), (jr, jd, jms) = got[fid], ref[fid]
        np.testing.assert_array_equal(r, jr)
        assert d.dtype == jd.dtype == np.uint16
        np.testing.assert_array_equal(d, jd)
        assert len(ms) == len(jms) == 2
        for a, b in zip(ms, jms):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r, images["rgb8"][1])


def test_missing_file_raises_like_jax(tmp_path):
    missing = str(tmp_path / "nope.png")
    for mod in (native, jnative):
        pf = mod.FramePrefetcher(n_workers=1, capacity=2)
        pf.submit(0, missing)
        with pytest.raises(IOError):
            pf.get(0)
        pf.close()
    with pytest.raises(IOError, match="nope.png: cannot open"):
        native.decode_image(missing)


def test_each_id_is_taken_once(images):
    pf = native.FramePrefetcher(n_workers=1, capacity=2)
    pf.submit(7, images["mask"][0])
    with pytest.raises(ValueError):
        pf.submit(7, images["mask"][0])
    pf.get(7)
    with pytest.raises(KeyError):
        pf.get(7)
    with pytest.raises(KeyError):
        pf.get(8)
    pf.close()


def test_jpeg_is_refused(tmp_path):
    p = str(tmp_path / "x.jpg")
    open(p, "wb").write(b"\xff\xd8\xff")
    with pytest.raises(IOError, match="JPEG"):
        native.decode_image(p)


def test_a_source_that_does_not_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "oslam_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not any(f.endswith(".so")
                   for f in os.listdir(tmp_path / "build"))


@pytest.fixture(scope="module")
def tum_seq(tmp_path_factory):
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    cfg = SlamConfig.tum_rgbd()
    # bench.py's room: seed 3, three object boxes of size 0.9
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(3, step=0.01)
    renders = []
    for T in poses:
        _, depth, rgb, sem = scene.render_rgbd(T)
        renders.append((depth, rgb, scene.sem_arrays(sem, 16)))
    seq = str(tmp_path_factory.mktemp("tum") / "seq")
    tum.write_sequence(seq, poses, renders, cfg.camera.depth_map_factor)
    return seq


def test_run_tum_torch_prefetch_inline_and_viz(tum_seq, tmp_path):
    """The driver's directory decoded by the prefetcher at the driver's
    settings equals the inline reader's arrays (tum.load_frame_raw, over
    datasets/png.py); the two driver runs side by side, through the
    prefetcher and with --viz-dir, which writes an overlay PNG per frame,
    the scrubber page and the map page."""
    from object_slam_tpu_torch.datasets import tum
    frames = tum.load_sequence(tum_seq)
    pf = native.FramePrefetcher(n_workers=4, capacity=8)
    for i, fr in enumerate(frames):
        pf.submit(i, fr.rgb_path, fr.depth_path)
    for i, fr in enumerate(frames):
        rgb, depth, _ = pf.get(i)
        got = tum.frame_arrays(rgb, depth, fr.depth_path)
        for a, b in zip(got, tum.load_frame_raw(fr)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pf.close()
    viz = str(tmp_path / "viz")
    runs = {"prefetch": [], "viz": ["--viz-dir", viz]}
    procs = {}
    for name, extra in runs.items():
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "scripts",
                                          "run_tum_torch.py"),
             "--seq", tum_seq, "--semantic-dir",
             os.path.join(tum_seq, "semantic"),
             "--out", str(tmp_path / ("out_" + name)), "--device", "cpu"]
            + extra,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ,
                     OMP_NUM_THREADS=str(max(1, THREADS // len(runs)))))
    outs = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (name, err[-3000:])
        outs[name] = json.loads(out.strip().splitlines()[-1])
        assert outs[name]["frames"] == 3

    def traj(name):
        return open(tmp_path / ("out_" + name) /
                    "CameraTrajectory.txt").read()
    assert len(traj("prefetch").splitlines()) == 3
    assert len(traj("viz").splitlines()) == 3
    files = sorted(os.listdir(viz))
    assert files == ["frame_00000.png", "frame_00001.png",
                     "frame_00002.png", "index.html", "map.html"]
    assert native.decode_image(os.path.join(viz, "frame_00001.png")).shape \
        == (480, 640, 3)
    page = open(os.path.join(viz, "index.html")).read()
    assert "(3 frames)" in page and '"state": "OK"' in page
    assert '"kf_id": [' in open(os.path.join(viz, "map.html")).read()
