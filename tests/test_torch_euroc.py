"""The EuRoC loader and driver of the PyTorch port against the JAX
package on the CPU.

``datasets/euroc.py`` is a numpy copy of the reference's module: on
tests/test_euroc.py's distorted calibration the settings parse to the same
blocks, the rectification maps agree within 1e-4 px (they are computed by
the same float64 numpy code, so they are in fact equal), the bilinear
remap and the Rectifier agree within 1e-4 of 255, and the enumeration,
the ground-truth csv and the camera block are equal. ``write_sequence`` /
``write_settings`` write a mav0 directory and a settings YAML that the
reference's loader reads back as written. ``scripts/run_euroc_torch.py
--device cpu`` runs stereo and ``--mono`` on a tiny directory (4 frames of
bench.py's room at a quarter of the EuRoC camera) and prints the
reference driver's JSON summary.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from object_slam_tpu.datasets import euroc as jeuroc
from object_slam_tpu_torch.config import SlamConfig
from object_slam_tpu_torch.datasets import euroc
from object_slam_tpu_torch.datasets.synthetic import bench_room, orbit_poses
from torch_fixtures.threads import share_cores

THREADS = share_cores()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def _cal_yaml():
    """tests/test_euroc.py's settings (the EuRoC distortion blocks)."""
    src = open(os.path.join(HERE, "test_euroc.py")).read()
    return src.split('CAL_YAML = """', 1)[1].split('"""', 1)[0]


@pytest.fixture(scope="module")
def calibs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cal") / "EuRoC.yaml")
    with open(path, "w") as f:
        f.write(_cal_yaml())
    return euroc.EurocCalib.from_yaml(path), jeuroc.EurocCalib.from_yaml(path)


def test_settings_parse_as_the_reference(calibs):
    t, j = calibs
    text = _cal_yaml()
    ts, tm = euroc._parse_opencv_yaml(text)
    js, jm = jeuroc._parse_opencv_yaml(text)
    assert ts == js and set(tm) == set(jm)
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k])
    for side in ("left", "right"):
        a, b = getattr(t, side), getattr(j, side)
        for f in ("K", "D", "R", "P"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.width, a.height) == (b.width, b.height) == (752, 480)


def test_rectification_maps_and_remap(calibs):
    t, j = calibs
    for side in ("left", "right"):
        mt = euroc.rectify_maps(getattr(t, side))
        mj = jeuroc.rectify_maps(getattr(j, side))
        for a, b in zip(mt, mj):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # the distortion itself, and a remap of a smooth image
    x = np.linspace(-0.6, 0.6, 13)
    for a, b in zip(euroc._distort_radtan(x, x[::-1], t.left.D),
                    jeuroc._distort_radtan(x, x[::-1], j.left.D)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(0)
    img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    img_r = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    out_t = euroc.Rectifier(t)(img, img_r)
    out_j = jeuroc.Rectifier(j)(img, img_r)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=1e-4 * 255, rtol=0)
    # out-of-bounds pixels are 0 in both
    assert np.array_equal(out_t[0] == 0, out_j[0] == 0)


def test_camera_config_as_the_reference(calibs):
    t, j = calibs
    ct, cj = euroc.euroc_camera_config(t), jeuroc.euroc_camera_config(j)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.width == 752 and ct.dist == (0.0,) * 5


def _tiny_cfg():
    """A quarter of the EuRoC camera (188x120), for the CPU runs; bf stays
    the value euroc_camera_config sets (the settings YAML carries none)."""
    cam = SlamConfig.euroc_stereo().camera
    return SlamConfig.euroc_stereo().replace(camera=dataclasses.replace(
        cam, fx=cam.fx / 4, fy=cam.fy / 4, cx=cam.cx / 4, cy=cam.cy / 4,
        width=188, height=120))


@pytest.fixture(scope="module")
def mav(tmp_path_factory):
    """A 4-frame mav0 directory and its settings YAML, written by the
    port."""
    cfg = _tiny_cfg()
    scene = bench_room(cfg)
    poses = orbit_poses(4, step=0.03)
    frames = []
    for T in poses:
        gl, gr = scene.render_stereo(T)[:2]
        frames.append((np.clip(gl, 0, 255).astype(np.uint8),
                       np.clip(gr, 0, 255).astype(np.uint8)))
    root = tmp_path_factory.mktemp("euroc")
    mav_dir = str(root / "mav0")
    stamps = euroc.write_sequence(mav_dir, poses, frames)
    settings = str(root / "settings.yaml")
    euroc.write_settings(settings, cfg.camera)
    return cfg, poses, frames, stamps, mav_dir, settings


def test_written_sequence_reads_back_in_both_packages(mav, tmp_path):
    cfg, poses, frames, stamps, mav_dir, settings = mav
    ft = euroc.load_sequence_mav(mav_dir)
    fj = jeuroc.load_sequence_mav(mav_dir)
    assert [dataclasses.astuple(a) for a in ft] == \
        [dataclasses.astuple(b) for b in fj]
    assert [round(f.timestamp * 1e9) for f in ft] == \
        [round(s * 1e-9 * 1e9) for s in stamps]
    times = tmp_path / "times.txt"
    times.write_text("\n".join(str(s) for s in stamps) + "\n")
    L, R = (os.path.join(mav_dir, c, "data") for c in ("cam0", "cam1"))
    assert [dataclasses.astuple(a) for a in euroc.load_sequence(
        L, R, str(times))] == [dataclasses.astuple(b) for b in
                               jeuroc.load_sequence(L, R, str(times))]
    for f, (gl, gr) in zip(ft, frames):
        np.testing.assert_array_equal(euroc.load_gray(f.left_path), gl)
        np.testing.assert_array_equal(euroc.load_gray(f.right_path), gr)
    gt = os.path.join(mav_dir, "state_groundtruth_estimate0", "data.csv")
    for a, b in zip(euroc.load_groundtruth_csv(gt),
                    jeuroc.load_groundtruth_csv(gt)):
        np.testing.assert_array_equal(a, b)
    ts, pos, quat = euroc.load_groundtruth_csv(gt)
    for T, p, q in zip(poses, pos, quat):
        Twc = np.linalg.inv(T.astype(np.float64))
        np.testing.assert_allclose(p, Twc[:3, 3], atol=1e-6)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        np.testing.assert_allclose(R, Twc[:3, :3], atol=1e-6)
    # the settings: identity rectification, the camera block as written
    ct = euroc.EurocCalib.from_yaml(settings)
    cj = jeuroc.EurocCalib.from_yaml(settings)
    assert euroc.euroc_camera_config(ct) == cfg.camera
    assert dataclasses.asdict(euroc.euroc_camera_config(ct)) == \
        dataclasses.asdict(jeuroc.euroc_camera_config(cj))
    mx, my = euroc.rectify_maps(ct.left)
    u, v = np.meshgrid(np.arange(188.0), np.arange(120.0))
    np.testing.assert_allclose(mx, u, atol=1e-4)
    np.testing.assert_allclose(my, v, atol=1e-4)


@pytest.mark.parametrize("mode", ["stereo", "mono"])
def test_run_euroc_torch_on_cpu(mav, tmp_path, mode):
    _, _, frames, _, mav_dir, settings = mav
    out = str(tmp_path / "out")
    cmd = [sys.executable, os.path.join(ROOT, "scripts", "run_euroc_torch.py"),
           "--mav", mav_dir, "--calib", settings, "--out", out,
           "--device", "cpu"] + (["--mono"] if mode == "mono" else [])
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(summary) == {"frames", "fps", "keyframes", "points"}
    assert summary["frames"] == len(frames) and summary["keyframes"] >= 1
    rows = open(os.path.join(out, "CameraTrajectory.txt")).read().split("\n")
    rows = [r for r in rows if r and not r.startswith("#")]
    # tracked frames only (mono: from its initialization on)
    assert (len(rows) == len(frames) if mode == "stereo"
            else 1 <= len(rows) < len(frames))
    assert all(len(r.split()) == 8 for r in rows)
