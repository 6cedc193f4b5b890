"""The system tail of the PyTorch port against the JAX package on the CPU:
the PNG reader and writer (held to PIL, which only this test machine has),
the trajectory and object-info writers (text-identical), timestamp
association and RPE (equal), the TUM loader and the YOLACT semantic loader
(equal arrays), the metrics stream (equal lines), and
scripts/run_tum_torch.py end to end on a small TUM-format directory."""

import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from object_slam_tpu.datasets import tum as jtum
from object_slam_tpu.eval import ate as jate
from object_slam_tpu.eval import trajectory_io as jtio
from object_slam_tpu.semantic import loader as jloader
from object_slam_tpu.utils.metrics import MetricsStream as JMetricsStream
from object_slam_tpu_torch.datasets import png
from object_slam_tpu_torch.datasets import tum
from object_slam_tpu_torch.eval import ate
from object_slam_tpu_torch.eval import trajectory_io as tio
from object_slam_tpu_torch.semantic import loader
from object_slam_tpu_torch.utils.metrics import MetricsStream
from torch_fixtures.threads import share_cores

THREADS = share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(kind, rng, h=23, w=37):
    if kind == "gray8":
        return rng.randint(0, 256, (h, w)).astype(np.uint8)
    if kind == "gray16":
        return rng.randint(0, 65536, (h, w)).astype(np.uint16)
    return rng.randint(0, 256, (h, w, {"rgb": 3, "rgba": 4}[kind])) \
        .astype(np.uint8)


KINDS = ["gray8", "gray16", "rgb", "rgba"]


@pytest.mark.parametrize("kind", KINDS)
def test_png_reader_equals_pil(kind, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(KINDS.index(kind))
    # smooth content makes PIL's encoder pick the predicting filters
    img = _image(kind, rng)
    ramp = np.cumsum(img.astype(np.int64), axis=1) % (
        65536 if kind == "gray16" else 256)
    for a in (img, ramp.astype(img.dtype)):
        p = str(tmp_path / "a.png")
        Image.fromarray(a).save(p)
        got = png.read_png(p)
        want = np.asarray(Image.open(p))
        assert got.dtype == a.dtype and np.array_equal(got, want)
        assert np.array_equal(got, a)


def _filtered_png(path, img, filters):
    """A PNG whose scanline i uses filters[i % len(filters)] (encoder
    written out here, so every filter type is exercised)."""
    rows = np.ascontiguousarray(img, dtype=">u2" if img.dtype == np.uint16
                                else np.uint8)
    h = img.shape[0]
    rows = rows.reshape(h, -1).view(np.uint8).astype(np.int64)
    ch = 1 if img.ndim == 2 else img.shape[2]
    bpp = ch * (2 if img.dtype == np.uint16 else 1)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8

    def chunk(k, b):
        return (struct.pack(">I", len(b)) + k + b
                + struct.pack(">I", zlib.crc32(k + b) & 0xFFFFFFFF))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], h,
                                            depth, ctype, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        fh.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", KINDS)
def test_png_every_filter_type_equals_pil(kind, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = _image(kind, np.random.RandomState(10 + KINDS.index(kind)))
    p = str(tmp_path / "f.png")
    _filtered_png(p, img, [0, 1, 2, 3, 4, 4, 3, 1])
    assert np.array_equal(png.read_png(p), np.asarray(Image.open(p)))
    assert np.array_equal(png.read_png(p), img)


@pytest.mark.parametrize("kind", KINDS)
def test_png_writer_read_by_pil(kind, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = _image(kind, np.random.RandomState(20 + KINDS.index(kind)))
    p = str(tmp_path / "w.png")
    png.write_png(p, img)
    assert np.array_equal(np.asarray(Image.open(p)), img)
    assert np.array_equal(png.read_png(p), img)


def test_png_unsupported_types_raise(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    p = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(p)
    with pytest.raises(ValueError, match="color type 3"):
        png.read_png(p)
    # the same header with the interlace flag set (Adam7)
    hdr = struct.pack(">IIBBBBB", 8, 8, 8, 0, 0, 0, 1)
    with open(p, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
                 + hdr + struct.pack(">I", zlib.crc32(b"IHDR" + hdr))
                 + struct.pack(">I", 0) + b"IDAT" + struct.pack(
                     ">I", zlib.crc32(b"IDAT")))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(p)
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(p, np.zeros((4, 4), np.float32))
    with open(p, "wb") as fh:
        fh.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(p)


def _poses(n, rng):
    out = []
    for _ in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        x, y, z, w = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                       2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                       2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w),
                       1 - 2 * (x * x + y * y)]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rng.randn(3)
        out.append(T.astype(np.float32))
    return np.stack(out)


def test_trajectory_writers_text_identical(tmp_path):
    rng = np.random.RandomState(0)
    poses = _poses(9, rng)
    traj = [(1000.0 + i / 30.0, T, i % 4 != 2) for i, T in enumerate(poses)]
    valid = np.arange(9) % 3 != 1
    labels = np.array([56, 62, 62, 73, -1, 56, 0, 0, 0], np.int32)
    for name, jw, tw, args in (
            ("cam", jtio.save_trajectory_tum, tio.save_trajectory_tum,
             (traj,)),
            ("kitti", jtio.save_trajectory_kitti, tio.save_trajectory_kitti,
             (traj,)),
            ("kf", jtio.save_keyframe_trajectory_tum,
             tio.save_keyframe_trajectory_tum,
             (np.arange(9) / 30.0, poses, valid)),
            ("obj", jtio.save_object_info, tio.save_object_info,
             (labels, valid, 4087))):
        a, b = str(tmp_path / f"{name}.j"), str(tmp_path / f"{name}.t")
        jw(a, *args)
        tw(b, *args)
        assert open(a).read() == open(b).read() and open(b).read(), name
    # every branch of the quaternion conversion
    for R in (np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.diag([-1.0, -1.0, 1.0])):
        assert np.array_equal(tio._rot_to_quat(R), jtio._rot_to_quat(R))


def test_associate_timestamps_and_rpe_equal():
    rng = np.random.RandomState(1)
    ta = np.sort(rng.uniform(0, 5, 80))
    tb = np.sort(ta + rng.uniform(-0.03, 0.03, 80))[::-1]
    assert ate.associate_timestamps(ta, tb) == \
        jate.associate_timestamps(ta, tb)
    assert ate.associate_timestamps(ta, tb, 0.005) == \
        jate.associate_timestamps(ta, tb, 0.005)
    est, gt = _poses(30, rng), _poses(30, rng)
    tracked = rng.rand(30) > 0.2
    for kw in ({}, {"delta": 3}, {"tracked": tracked}):
        assert ate.rpe(est, gt, **kw) == jate.rpe(est, gt, **kw)


def _write_semantic(root, key, dets, shape):
    fdir = os.path.join(root, key)
    os.makedirs(fdir, exist_ok=True)
    with open(os.path.join(fdir, key + ".txt"), "w") as f:
        for label, prob, inst, box in dets:
            f.write(f"{label} {prob} {box[0]} {box[1]} {box[2]} {box[3]} "
                    f"{inst}\n")
            if inst >= 0:
                m = np.zeros(shape, np.uint8)
                m[box[1]:box[1] + box[3], box[0]:box[0] + box[2]] = 255
                png.write_png(os.path.join(fdir, f"{inst}.png"),
                              np.stack([m] * 3, -1) if inst == 2 else m)
        f.write("short line\n")


def test_semantic_loader_equals_jax(tmp_path):
    pytest.importorskip("PIL.Image")
    root = str(tmp_path / "sem")
    key = loader.tum_frame_key(1305031102.175304)
    assert key == jloader.tum_frame_key(1305031102.175304)
    assert loader.kitti_frame_key(7) == jloader.kitti_frame_key(7)
    # a laptop (63 -> 62), a low score, an invalid label, an RGB mask, a
    # missing mask file
    dets = [(63, 0.9, 0, (3, 4, 10, 8)), (56, 0.2, 1, (0, 0, 5, 5)),
            (999, 0.9, 3, (1, 1, 2, 2)), (73, 0.8, 2, (6, 2, 9, 12)),
            (56, 0.95, 7, (0, 0, 4, 4))]
    _write_semantic(root, key, [d if d[2] != 7 else (56, 0.95, 7,
                                                     (0, 0, 4, 4))
                                for d in dets], (20, 24))
    os.remove(os.path.join(root, key, "7.png"))
    args = (root, key, 0.5, (56, 62, 73))
    got = loader.read_semantic_dir(*args)
    want = jloader.read_semantic_dir(*args)
    assert [(d.label, d.prob) for d in got] == [(62, 0.9), (73, 0.8)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.label, a.prob) == (b.label, b.prob)
        assert np.array_equal(a.bbox, b.bbox)
        assert np.array_equal(a.mask, b.mask)
    for a, b in zip(loader.detections_to_arrays(got, 4, 20, 24),
                    jloader.detections_to_arrays(want, 4, 20, 24)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert loader.read_semantic_dir(str(tmp_path), "nothing", 0.5, ()) == []


def test_tum_lists_sequence_and_groundtruth_equal(tmp_path):
    seq = str(tmp_path)
    rng = np.random.RandomState(2)
    ts = 1000.0 + np.arange(6) / 30.0
    td = ts + rng.uniform(-0.01, 0.01, 6)
    with open(os.path.join(seq, "rgb.txt"), "w") as f:
        f.write("# rgb\n\n" + "".join(f"{t:.6f} rgb/{t:.6f}.png\n"
                                       for t in ts))
    with open(os.path.join(seq, "depth.txt"), "w") as f:
        f.write("# depth\n" + "".join(f"{t:.6f} depth/{t:.6f}.png\n"
                                      for t in td[::-1]))
    with open(os.path.join(seq, "groundtruth.txt"), "w") as f:
        f.write("# gt\n" + "".join(
            f"{t:.4f} " + " ".join(f"{v:.4f}" for v in rng.randn(7)) + "\n"
            for t in ts))
    assert tum.read_file_list(os.path.join(seq, "rgb.txt")) == \
        jtum.read_file_list(os.path.join(seq, "rgb.txt"))
    got, want = tum.load_sequence(seq), jtum.load_sequence(seq)
    assert [(f.timestamp, f.rgb_path, f.depth_path) for f in got] == \
        [(f.timestamp, f.rgb_path, f.depth_path) for f in want]
    for a, b in zip(tum.load_groundtruth(seq), jtum.load_groundtruth(seq)):
        assert np.array_equal(a, b)


def test_tum_frame_raw_and_semantics(tmp_path):
    from object_slam_tpu.config import SlamConfig as JSlamConfig
    from object_slam_tpu_torch.config import SlamConfig
    pytest.importorskip("PIL.Image")
    rgb = _image("rgb", np.random.RandomState(3), 480, 640)
    depth = _image("gray16", np.random.RandomState(4), 480, 640)
    fr = tum.TumFrame(1.0, str(tmp_path / "r.png"), str(tmp_path / "d.png"))
    png.write_png(fr.rgb_path, rgb)
    png.write_png(fr.depth_path, depth)
    r, d = tum.load_frame_raw(fr)
    assert r.dtype == np.uint8 and np.array_equal(r, rgb)
    assert d.dtype == np.uint16 and np.array_equal(d, depth)
    # the reference's f32 frame arrays follow from the raw ones
    jg, jd, jr = jtum.load_frame_arrays(fr, 5000.0)
    assert np.array_equal(jr, r.astype(np.float32))
    assert np.array_equal(jd, d.astype(np.float32) / 5000.0)
    root = str(tmp_path / "sem")
    key = loader.tum_frame_key(1.0)
    _write_semantic(root, key, [(56, 0.9, 0, (10, 20, 100, 50))], (480, 640))
    for a, b in zip(tum.load_semantics(root, 1.0, SlamConfig.tum_rgbd()),
                    jtum.load_semantics(root, 1.0, JSlamConfig.tum_rgbd())):
        assert np.array_equal(a, b)


def test_metrics_stream_equal_lines():
    a, b = io.StringIO(), io.StringIO()
    rec = dict(frame=3, ts=0.1, state="OK", track_ms=12.5, n_inliers=88,
               kf_inserted=False, ref_kf=1, frames_since_kf=2)
    for s, sink in ((MetricsStream(a, flush_every=2), a),
                    (JMetricsStream(b, flush_every=2), b)):
        with s:
            s.emit(**rec)
            s.emit(**{**rec, "frame": 4})
        assert s.last["frame"] == 4
    assert a.getvalue() == b.getvalue()
    assert json.loads(a.getvalue().splitlines()[0]) == rec


def test_run_tum_torch_end_to_end(tmp_path):
    """The driver on a 2-frame TUM-format directory with masks, on the
    CPU: the three output files and the JSON summary."""
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets import tum
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    cfg = SlamConfig.tum_rgbd()
    # bench.py's room: seed 3, three object boxes of size 0.9
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(2, step=0.01)
    renders = []
    for T in poses:
        _, depth, rgb, sem = scene.render_rgbd(T)
        renders.append((depth, rgb, scene.sem_arrays(sem, 16)))
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    tum.write_sequence(seq, poses, renders, cfg.camera.depth_map_factor)
    metrics = str(tmp_path / "m.jsonl")
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "run_tum_torch.py"),
         "--seq", seq, "--semantic-dir", os.path.join(seq, "semantic"),
         "--out", out, "--device", "cpu",
         "--metrics", metrics],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS=str(THREADS)))
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert res["frames"] == 2 and res["keyframes"] >= 1 and res["points"] > 0
    assert res["fps"] > 0 and res["median_track_ms"] > 0
    assert "ate_rmse" not in res          # needs more than 10 pairs
    cam = open(os.path.join(out, "CameraTrajectory.txt")).read().splitlines()
    assert len(cam) == 2 and cam[0].startswith("1000.000000 ")
    kf = open(os.path.join(out, "KeyFrameTrajectory.txt")).read()
    assert kf.startswith("1000.000000 0.0000000 0.0000000 0.0000000 ")
    info = open(os.path.join(out, "ObjectInfo.txt")).read().splitlines()
    assert info[-1].startswith("semantic_constraints: ")
    assert info[-2] == f"total: {len(info) - 2}" and len(info) >= 3
    lines = open(metrics).read().splitlines()
    assert [json.loads(x)["state"] for x in lines] == ["OK", "OK"]
