"""The port's host-side auxiliaries against the JAX package on the CPU: the
stage profiler (utils/profiling.py: spans, stats, report, JSON, reset,
disabled), SlamSystem.profiler's span names on the staged and the fused
path, the torch.profiler trace, the frame overlay (viz/renderer.py:
draw_frame equal to JAX's, uint8 for uint8), the map viewer's payload
(viz/map_viewer.py: equal to JAX's for the same map), the scrubber's
files, the 3D map render, and graft_entry's tracking step and 2-rank
sharded-BA dry run. The system runs are tests/test_torch_slam_objects.py's
object-stability scene (160x120, two boxes, 8 frames), objects on."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu.utils.profiling import StageProfiler as JStageProfiler
from object_slam_tpu.viz import map_viewer as j_viewer
from object_slam_tpu.viz import renderer as j_renderer
from object_slam_tpu_torch import graft_entry, interop
from object_slam_tpu_torch.datasets import png
from object_slam_tpu_torch.slam.system import SlamSystem
from object_slam_tpu_torch.utils.profiling import StageProfiler, cuda_trace
from object_slam_tpu_torch.viz import map_viewer, renderer
from object_slam_tpu_torch.viz.scrubber import Scrubber
from test_torch_slam_objects import object_scene, objects_cfg
from torch_fixtures.threads import share_cores

share_cores()

# the reference's span names (object_slam_tpu/slam/system.py)
JAX_SPANS = {"track.motion_model", "track.obj_associate", "track.local_map",
             "track.obj_update", "loop.on_keyframe", "track.kf_policy",
             "mapping.dispatch", "mapping.process_kf", "track.fused",
             "track.resolve"}


@pytest.mark.parametrize("cls", [StageProfiler, JStageProfiler],
                         ids=["port", "jax"])
def test_stage_profiler(cls, tmp_path):
    prof = cls()
    for name, n in (("a", 3), ("b", 1)):
        for _ in range(n):
            with prof.span(name):
                sum(range(20000))
    st = prof.stats()
    assert sorted(st) == ["a", "b"]
    assert st["a"]["n"] == 3 and st["b"]["n"] == 1
    assert st["a"]["total_ms"] >= st["a"]["median_ms"] > 0
    lines = prof.report().splitlines()
    assert lines[0].split() == ["stage", "n", "median", "p90", "total"]
    assert len(lines) == 3 and lines[1].split()[:2] in (["a", "3"],
                                                        ["b", "1"])
    prof.dump_json(str(tmp_path / "p.json"))
    assert json.load(open(tmp_path / "p.json")) == st
    prof.reset()
    assert prof.stats() == {}


def test_stage_profiler_report_format_is_the_reference_one():
    port, ref = StageProfiler(), JStageProfiler()
    samples = {"track.fused": [0.0125, 0.0031], "track.resolve": [0.002]}
    port.samples.update(samples)
    ref.samples.update(samples)
    assert port.report() == ref.report()
    assert port.stats() == ref.stats()


def test_disabled_profiler_records_nothing():
    prof = StageProfiler(enabled=False, device="cpu")
    with prof.span("x"):
        pass
    assert prof.stats() == {} and prof.report().count("\n") == 0


def test_cuda_trace_writes_a_chrome_trace(tmp_path):
    with cuda_trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    trace = json.load(open(tmp_path / "tr" / "trace.json"))
    assert trace["traceEvents"]


def _run_system(fused: bool, n_frames: int = 8, profile: bool = True):
    cfg = objects_cfg()
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking,
                                                   fused=fused))
    scene, poses = object_scene(cfg)
    sys_ = SlamSystem(cfg, enable_objects=True, device="cpu")
    sys_.profiler.enabled = profile
    rgbs, frames = [], []
    for i, T in enumerate(poses[:n_frames]):
        gray, depth, rgb, sem = scene.render_rgbd(T)
        frames.append(sys_.track_rgbd(
            gray, depth, rgb, scene.sem_arrays(sem,
                                               cfg.semantic.max_instances),
            timestamp=i / 30.0))
        rgbs.append(rgb)
    sys_.flush_mapping()
    return sys_, rgbs, frames


@pytest.fixture(scope="module")
def staged_run():
    return _run_system(fused=False)


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_system_profiler_names(staged_run, path):
    sys_ = staged_run[0] if path == "staged" else _run_system(fused=True)[0]
    names = set(sys_.profiler.stats())
    want = ({"track.motion_model", "track.local_map", "track.kf_policy",
             "track.obj_associate", "track.obj_update",
             "mapping.process_kf"} if path == "staged" else
            {"track.fused", "track.resolve", "mapping.process_kf"})
    assert want <= names, sorted(names)
    # every name is the reference's, or a port stage the reference has no
    # span for (frame_build, insert_keyframe, track_staged, semopt, ...)
    assert not {n for n in names if n.startswith("track.")} - JAX_SPANS
    per_frame = "track.kf_policy" if path == "staged" else "track.fused"
    assert sys_.profiler.stats()[per_frame]["n"] >= 5
    assert per_frame in sys_.profiler.report()
    if path == "staged":
        assert "track.fused" not in names


def test_profiler_off_by_default_records_nothing():
    sys_, _, _ = _run_system(fused=True, n_frames=3, profile=False)
    assert sys_.profiler.stats() == {}


@pytest.mark.parametrize("profile", [False, True])
def test_system_profile_flag_enables_the_profiler(profile):
    sys_ = SlamSystem(objects_cfg(), enable_objects=False, device="cpu",
                      profile=profile)
    assert sys_.profiler.enabled is profile


def _jax_frame(fr):
    """The port frame's fields as the numpy attributes JAX's draw_frame
    reads."""
    from types import SimpleNamespace
    a = interop.frame_to_numpy(fr)
    obj = SimpleNamespace(**a.pop("obj"))
    return SimpleNamespace(obj=obj, **a)


@pytest.mark.parametrize("draw_objects", [True, False])
def test_draw_frame_matches_jax(staged_run, draw_objects):
    _, rgbs, frames = staged_run
    n_obj = 0
    for rgb, fr in zip(rgbs, frames):
        got = renderer.draw_frame(rgb, fr, draw_objects=draw_objects)
        ref = j_renderer.draw_frame(rgb, _jax_frame(fr),
                                    draw_objects=draw_objects)
        assert got.dtype == ref.dtype == np.uint8
        assert np.array_equal(got, ref)
        n_obj += int(fr.obj.valid.sum())
    assert n_obj > 0         # the object branch was drawn


def test_map_viewer_payload_matches_jax(staged_run, tmp_path):
    sys_ = staged_run[0]
    m = sys_.map
    jm = JMapState(**{k: jnp.asarray(v) for k, v in
                      interop.map_state_to_numpy(m).items()})
    for covis_min, max_points in ((15, 40000), (1, 100)):
        got = map_viewer.collect(m, sys_.trajectory, max_points, covis_min)
        ref = j_viewer._collect(jm, sys_.trajectory, max_points, covis_min)
        assert json.dumps(got) == json.dumps(ref)
    assert got["covis"] and got["tree"] and len(got["traj"]) == 8
    assert len(got["pts"]) <= 100
    path = map_viewer.export_map_html(m, sys_.trajectory,
                                      str(tmp_path / "v" / "map.html"))
    page = open(path).read()
    assert json.dumps(map_viewer.collect(m, sys_.trajectory)) in page


def test_scrubber_writes(staged_run, tmp_path):
    _, rgbs, frames = staged_run
    sc = Scrubber(str(tmp_path / "s"), fps=30.0)
    for i in range(3):
        sc.add_frame(rgbs[i], frames[i], state="OK", n_inliers=40 + i)
    page = open(sc.write()).read()
    assert "(3 frames)" in page and '"n_inliers": 42' in page
    assert np.array_equal(png.read_png(str(tmp_path / "s" /
                                           "frame_00002.png")),
                          renderer.draw_frame(rgbs[2], frames[2]))


def test_render_map_3d(staged_run, tmp_path):
    pytest.importorskip("matplotlib")
    fig = renderer.render_map_3d(staged_run[0].map,
                                 path=str(tmp_path / "map3d.png"))
    assert fig is not None and os.path.getsize(tmp_path / "map3d.png") > 0


def test_graft_entry_tracks_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    Tcw, n_inl = fn(*args)
    assert Tcw.shape == (4, 4) and bool(torch.isfinite(Tcw).all())
    assert int(n_inl) > 100


def test_graft_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_dryrun_multichip_on_two_cpu_ranks():
    graft_entry.dryrun_multichip(2, device="cpu", timeout_s=120)


@pytest.mark.parametrize("fault", ["disagree", "non_finite", "shape"])
def test_dryrun_multichip_raises_on_bad_ranks(monkeypatch, fault):
    """The dry run's checks raise (they are not asserts, which python -O
    would strip) when a rank disagrees, is not finite or has the wrong
    shape."""
    from object_slam_tpu_torch.parallel import sharded_ba

    def fake(K, prob, n, **kw):
        outs = [{"kf_pose": prob["kf_pose"].copy(),
                 "pt_xyz": prob["pt_xyz"].copy()} for _ in range(n)]
        if fault == "disagree":
            outs[1]["pt_xyz"][0, 0] += 1e-3
        elif fault == "non_finite":
            outs[1]["kf_pose"][1, 0, 3] = np.nan
        else:
            outs[1]["kf_pose"] = outs[1]["kf_pose"][:2]
        return outs
    monkeypatch.setattr(sharded_ba, "spawn_sharded_global_ba", fake)
    with pytest.raises(RuntimeError, match="rank 1"):
        graft_entry.dryrun_multichip(2, device="cpu")
