"""The stereo slice as a whole on the CPU: SlamSystem.track_stereo of the
PyTorch port (objects on, the default fused pipelined path, rgb=None)
with inline and with async mapping, against the JAX package's runs of the
same 12 frames of the small street canyon
(tests/torch_fixtures/stereo.npz, make_reference.py ``stereo``); the
staged path's merge-when-ready with ready() pinned to True on both sides;
the snapshot a mapping pass reads, unchanged while tracking runs over it;
one local-mapping pass of the KITTI drive at full width, stage by stage,
on the JAX stages' inputs (tests/torch_fixtures/kitti_pass.npz,
make_reference.py ``kitti_pass``); the KITTI loader against the JAX
package's; and scripts/run_kitti_torch.py on a tiny KITTI directory.

Tolerances: tracked flags, keyframe frames, the object census and the
mapping passes (abbreviated ones and merges) identical; every trajectory
record within 5 mm / 0.1 deg of the JAX run's; semantic constraints within
10%. The pose band is wider than the RGB-D tests' 2 mm because this scene
is the street canyon at scale 8 (points 10-60 units away): there the JAX
package's own local BA moves a keyframe by 1.3-3.4 mm when its input
points move by one float32 ulp, and the port's BA, summing in another
order, lands 2.8 mm from it on the same input
(scripts/diag_stereo_ba_parity.py); the records of this drive differ by
up to 2.4 mm."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from object_slam_tpu.config import SlamConfig as JSlamConfig
from object_slam_tpu.datasets import kitti as jkitti
from object_slam_tpu_torch import config as tc
from object_slam_tpu_torch.datasets import kitti, png
from object_slam_tpu_torch.datasets import synthetic as tsyn
from object_slam_tpu_torch.slam import system as tsys
from torch_fixtures import street
from torch_fixtures.threads import share_cores

THREADS = share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "stereo.npz")
TCFG = street.stereo_cfg(tc)
STAGED_FRAMES = 8
POSE_BAND_M = 5e-3


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def drive():
    scene, poses = tsyn.street_scene(TCFG, 12)
    frames = []
    for T in poses:
        gl, gr, _, _, sem = scene.render_stereo(T)
        frames.append((np.clip(gl, 0, 255).astype(np.uint8),
                       np.clip(gr, 0, 255).astype(np.uint8),
                       scene.sem_arrays(sem, TCFG.semantic.max_instances)))
    return poses, frames


class SnapshotWatch:
    """Clones each mapping pass's snapshot at dispatch and compares the
    snapshot's tensors with the clones at merge, after the tracking frames
    that ran over the pass."""

    def __init__(self, am):
        self.changed, self.checked = [], 0
        dispatch, merge = am.dispatch, am.merge

        def watched_dispatch(m, kf_id, fast):
            self.clones = [t.clone() for t in m]
            return dispatch(m, kf_id, fast)

        def watched_merge(m_now):
            if am.pending is not None:
                snap = am.pending[1]
                self.changed += [f for f, a, b in zip(snap._fields, snap,
                                                      self.clones)
                                 if not torch.equal(a, b)]
                self.checked += 1
            return merge(m_now)
        am.dispatch, am.merge = watched_dispatch, watched_merge


def run_port(cfg, frames, async_mapping):
    sys_ = tsys.SlamSystem(cfg, enable_objects=True,
                           async_mapping=async_mapping, device="cpu")
    watch = SnapshotWatch(sys_._async) if async_mapping else None
    for i, (gl, gr, sa) in enumerate(frames):
        sys_.track_stereo(gl, gr, None, sa, timestamp=i / 10.0)
    sys_.flush_mapping()
    m = sys_.map
    labels = m.obj_label[m.obj_valid].numpy()
    lab, cnt = np.unique(labels, return_counts=True)
    out = dict(
        sys=sys_, watch=watch,
        tracked=[r.tracked for r in sys_.trajectory],
        rec_tcw=np.stack([r.Tcw for r in sys_.trajectory]),
        kf_frames=m.kf_frame_id[m.kf_valid].tolist(),
        census=dict(zip(lab.tolist(), cnt.tolist())),
        constraints=sys_.objects.semantic_constraints)
    sys_.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(drive):
    """The port's run of the drive per mode, made on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = run_port(TCFG, drive[1], mode == "async")
        return cache[mode]
    return get


MODES = pytest.mark.parametrize("mode", ["sync", "async"])


def test_inputs_match_fixture_checksums(fx, drive):
    frames = drive[1]
    np.testing.assert_allclose(
        [float(np.sum(gl, dtype=np.float64)) for gl, _, _ in frames],
        fx["gray_sum"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        [float(np.sum(gr, dtype=np.float64)) for _, gr, _ in frames],
        fx["gray_r_sum"], rtol=1e-12, atol=0)
    assert [int(sa[4].sum()) for _, _, sa in frames] == \
        fx["n_detections"].tolist()


def test_pooled_render_equals_the_in_process_render(drive):
    """datasets.synthetic.render_street (a spawn pool, each worker building
    the scene from the seed) gives the frames rendered here, bit for bit."""
    poses, frames, _ = tsyn.render_street(TCFG, 12, 1, 3, workers=2)
    assert all(np.array_equal(a, b) for a, b in zip(poses, drive[0][1:3]))
    for (gl, gr, sa), (wl, wr, wa) in zip(frames, drive[1][1:3]):
        assert np.array_equal(gl, wl) and np.array_equal(gr, wr)
        assert all(np.array_equal(a, b) for a, b in zip(sa, wa))


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T.astype(np.float64) @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def hold(fx, mode, got):
    """got against the JAX run ``mode`` of the fixture."""
    assert got["tracked"] == fx[f"{mode}.tracked"].tolist()
    assert got["kf_frames"] == fx[f"{mode}.kf_frames"].tolist()
    for a, b in zip(got["rec_tcw"], fx[f"{mode}.rec_tcw"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < POSE_BAND_M
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1
    want = dict(zip(fx[f"{mode}.census_labels"].tolist(),
                    fx[f"{mode}.census_counts"].tolist()))
    assert got["census"] == want
    ref = int(fx[f"{mode}.semantic_constraints"])
    assert abs(got["constraints"] - ref) <= 0.1 * ref


@MODES
def test_tracked_flags_and_keyframes_identical(fx, runs, mode):
    got = runs(mode)
    assert all(got["tracked"])
    assert got["tracked"] == fx[f"{mode}.tracked"].tolist()
    assert got["kf_frames"] == fx[f"{mode}.kf_frames"].tolist()


@MODES
def test_records_within_5mm_and_0_1deg(fx, runs, mode):
    got = runs(mode)
    for a, b in zip(got["rec_tcw"], fx[f"{mode}.rec_tcw"]):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < POSE_BAND_M
        assert _rot_deg(a[:3, :3], b[:3, :3]) < 0.1


@MODES
def test_census_equal_and_constraints_within_10_percent(fx, runs, mode):
    got = runs(mode)
    hold(fx, mode, got)
    assert got["census"] and got["constraints"] > 0


@MODES
def test_mapping_passes_and_merges_match_jax(fx, runs, mode):
    """Every keyframe after the first is mapped on the abbreviated schedule
    (keyframes every 1-3 frames, ba_abort_pressure_gap 5) as in the JAX
    run; async, each pass is merged once: at the next keyframe or at the
    final flush."""
    got = runs(mode)
    st = got["sys"].mapping_stats
    n_kf = len(fx[f"{mode}.kf_frames"])
    assert st["passes"] == n_kf - 1
    if mode == "async":
        assert st["passes"] == int(fx["async.dispatches"])
        assert st["abbreviated"] == int(fx["async.fast_dispatches"]) >= 1
        assert st["barrier_merges"] + st["flush_merges"] == \
            int(fx["async.merges"])
        assert st["barrier_merges"] >= 1 and st["flush_merges"] == 1
        assert st["ready_merges"] == 0
    else:
        assert st["barrier_merges"] == st["flush_merges"] == 0


def test_snapshot_unchanged_while_tracking_runs_over_a_pass(runs):
    """Nothing writes to the tensors of a pass's snapshot between its
    dispatch and its merge: tracking, the object stages and the keyframe
    insertion all return new tensors."""
    got = runs("async")
    watch = got["watch"]
    assert watch.checked == got["sys"].mapping_stats["passes"] >= 2
    assert watch.changed == []


def test_staged_merge_when_ready_pinned(fx, drive, monkeypatch):
    """The staged path (fused=False), async, with ready() pinned to True
    whenever a pass is pending, in the port as in the fixture's JAX run:
    each tracked frame adopts the pass in flight before its keyframe
    decision."""
    monkeypatch.setattr(tsys._AsyncMapping, "ready",
                        lambda self: self.pending is not None)
    cfg = TCFG.replace(tracking=dataclasses.replace(TCFG.tracking,
                                                    fused=False))
    got = run_port(cfg, drive[1][:STAGED_FRAMES], True)
    hold(fx, "staged", got)
    st = got["sys"].mapping_stats
    assert st["ready_merges"] >= 1
    assert st["passes"] == int(fx["staged.dispatches"])
    assert st["ready_merges"] + st["barrier_merges"] + st["flush_merges"] \
        == int(fx["staged.merges"])


PASS_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                            "kitti_pass.npz")
# the stages that decide by counts and thresholds on the same input agree
# exactly; triangulation and the point statistics differ by float32
# rounding (largest absolute difference, scene units); the local BA's
# keyframes are held to the JAX BA's own spread under one-ulp input noise
PASS_FLOAT_TOL = {"triangulate": 5e-3, "point_stats": 1e-5}


@pytest.fixture(scope="module")
def kitti_pass():
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.slam import local_mapping
    from object_slam_tpu_torch.slam.frame import FrameBuilder
    from object_slam_tpu_torch.slam.map_state import init_map
    fx = np.load(PASS_FIXTURE)
    cfg = tc.SlamConfig.kitti_stereo()
    base = interop.map_state_to_numpy(init_map(
        cfg.caps, cfg.objects.history_capacity, device="cpu"))
    names = fx["stages"].tolist()
    maps = interop.stage_maps(fx, base, names)
    tb = FrameBuilder(cfg, device="cpu")
    kf = int(fx["kf"])
    W = local_mapping.covisibility(
        interop.map_state_from_numpy(maps["in"], device="cpu"))[kf]
    stages = dict(local_mapping.pass_stages(
        tb.K, kf, tb.scale_factors, tb.inv_sigma2, cfg, W,
        tuple(cfg.mapping.ba_abort_iters) if bool(fx["fast"]) else None))
    assert list(stages) == names
    prev = dict(zip(names, ["in"] + names[:-1]))
    return fx, maps, stages, prev


def ba_spread(fx):
    """The JAX local BA's own one-ulp spread about its recorded output:
    the farthest keyframe move of its noise trials on the recording
    machine and of its 16 trials rerun on a second one (make_reference.py
    kitti_pass_noise; there the noise-free rerun itself lands
    ba_rerun_kf_move away, as XLA:CPU sums in the order the compiling
    machine picks)."""
    return max(fx["ba_ulp_kf_move"].max(), fx["ba_ulp_kf_move_rerun"].max())


@pytest.mark.parametrize("stage", ["cull_points", "triangulate", "fuse",
                                   "point_stats", "local_ba",
                                   "cull_keyframes"])
def test_kitti_pass_stage_matches_jax(kitti_pass, stage):
    """One local-mapping pass of the KITTI sync drive at full width (the
    pass on keyframe 3), each stage of the port on the JAX stage's input
    (kitti_pass.npz), against the JAX stage's output."""
    from object_slam_tpu_torch import interop
    fx, maps, stages, prev = kitti_pass
    got = interop.map_state_to_numpy(stages[stage](
        interop.map_state_from_numpy(maps[prev[stage]], device="cpu")))
    want = maps[stage]
    for f, b in want.items():
        a = got[f]
        if stage == "local_ba" and f != "kf_pose":
            continue
        if a.dtype.kind == "f" and stage in PASS_FLOAT_TOL:
            assert np.max(np.abs(a - b), initial=0.0) <= \
                PASS_FLOAT_TOL[stage], (stage, f)
        elif f == "kf_pose":
            kv = want["kf_valid"]
            move = np.linalg.norm(a[kv][:, :3, 3] - b[kv][:, :3, 3],
                                  axis=1).max()
            limit = ba_spread(fx) if stage == "local_ba" else 0
            assert move <= limit, (stage, move, limit)
        else:
            assert np.array_equal(a, b), (stage, f, int(np.sum(a != b)))


def _tiny_kitti(root, n=3, rgb=False):
    """A tiny KITTI directory of a static textured scene: the right image
    is the left one shifted by 24 px (depth bf / 24), one car mask per
    frame, ground truth the identity."""
    cfg = tc.SlamConfig.kitti_stereo()
    H, W = cfg.camera.height, cfg.camera.width
    rng = np.random.RandomState(7)
    blocks = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1))
    gl = np.repeat(np.repeat(blocks, 4, 0), 4, 1)[:H, :W].astype(np.uint8)
    gr = np.roll(gl, -24, axis=1)
    masks = np.zeros((16, H, W), bool)
    masks[0, 150:300, 500:760] = True
    labels = np.full(16, -1, np.int32)
    labels[0] = 2
    probs = np.zeros(16, np.float32)
    probs[0] = 0.95
    bboxes = np.zeros((16, 4), np.float32)
    bboxes[0] = (500, 150, 259, 149)
    valid = np.arange(16) == 0
    sem = (masks, labels, probs, bboxes, valid)
    kitti.write_sequence(root, [np.eye(4, dtype=np.float32)] * n,
                         [(gl, gr, sem)] * n)
    if rgb:
        for side in ("image_0", "image_1"):
            for i in range(n):
                p = os.path.join(root, side, f"{i:06d}.png")
                g = png.read_png(p)
                png.write_png(p, np.stack([g, 255 - g, g // 2], -1))
    return cfg


@pytest.mark.parametrize("rgb", [False, True])
def test_kitti_loader_matches_jax(tmp_path, rgb):
    root = str(tmp_path / "seq")
    _tiny_kitti(root, n=2, rgb=rgb)
    jseq, tseq = jkitti.load_sequence(root), kitti.load_sequence(root)
    assert [vars(a) for a in jseq] == [vars(b) for b in tseq]
    for jf, tf in zip(jseq, tseq):
        for a, b in zip(jkitti.load_frame_arrays(jf),
                        kitti.load_frame_arrays(tf)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        gl, gr = kitti.load_frame_raw(tf)
        assert gl.dtype == np.uint8 and gl.shape == (376, 1241)
        if not rgb:
            assert np.array_equal(gl, kitti.load_frame_arrays(tf)[0])
    assert np.array_equal(jkitti.load_groundtruth(root + "/gt.txt"),
                          kitti.load_groundtruth(root + "/gt.txt"))
    jcfg, tcfg = JSlamConfig.kitti_stereo(), tc.SlamConfig.kitti_stereo()
    for i in range(2):
        for a, b in zip(jkitti.load_semantics(root + "/semantic", i, jcfg),
                        kitti.load_semantics(root + "/semantic", i, tcfg)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert kitti.load_semantics(root + "/semantic", 0, tcfg)[4].sum() == 1


def test_run_kitti_torch_on_a_tiny_directory(tmp_path):
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    _tiny_kitti(seq, n=3)
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "run_kitti_torch.py"),
         "--seq", seq, "--gt", os.path.join(seq, "gt.txt"),
         "--semantic-dir", os.path.join(seq, "semantic"), "--out", out,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS=str(THREADS)))
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert res["frames"] == res["tracked"] == 3 and res["async_mapping"]
    assert res["keyframes"] >= 1 and res["points"] > 0
    assert res["ate_rmse"] < 1e-3 and "rpe_trans_rmse" in res
    assert res["mean_track_ms"] > 0 and "objects" in res
    cam = open(os.path.join(out, "CameraTrajectory.txt")).read().splitlines()
    assert len(cam) == 3 and len(cam[0].split()) == 12
    kf = open(os.path.join(out, "KeyFrameTrajectory.txt")).read()
    assert kf.startswith("0.000000 0.0000000 0.0000000 0.0000000 ")
    info = open(os.path.join(out, "ObjectInfo.txt")).read().splitlines()
    assert info[-1].startswith("semantic_constraints: ")
