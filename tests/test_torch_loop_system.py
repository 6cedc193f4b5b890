"""Loop closing in the PyTorch port's system on the CPU: the small circuit
(the TUM camera at 320x240, bench.py's room, objects off, strict readback,
sync mapping) replayed against the JAX run recorded in
tests/torch_fixtures/loop_small.npz (make_reference.py loop_small), the
BoW relocalization of an early frame against the captured map, reset and
async mapping
with the loop on, and the TUM driver with --loop.

The 160x120 verify geometry does not close a loop in the JAX package (its
Sim3 candidates share 0-2 descriptor matches, under the 20 the
verification needs), so the small circuit is
scripts/diag_loop_alias.py's positive circuit at half the TUM size. The
port starts from the JAX system's whole state LOOP_SMALL_REPLAY frames
before the frame whose keyframe closes the loop, with the JAX run's
keyframe decisions and Sim3 index sets replayed.

Tolerances: tracked flags, keyframe frames, the closure's (q, l,
accepted) exact; its numbers 1e-3 relative (bend_deg 0.02 deg, the arccos
resolution of f32 rotations); records within 5 mm / 0.1 deg (single
frames already move by up to 5.3 mm with float order, ROADMAP queue 3);
relocalization attempts: the same candidates in the same order, inliers
within 2, poses within 5 mm (the 6-point DLT's f32 conditioning)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import (CameraConfig, CapacityConfig,
                                          OrbConfig, SlamConfig,
                                          TrackingConfig)
from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                      loop_trajectory,
                                                      orbit_poses)
from object_slam_tpu_torch.slam import tracking as trk
from object_slam_tpu_torch.slam.system import FrameRecord, SlamSystem
from torch_fixtures.threads import share_cores

THREADS = share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "loop_small.npz")
REC_TOL_M = 5e-3
REC_TOL_DEG = 0.1


def loop_small_cfg():
    """make_reference.py's loop_small_cfg (ab_deviations.build_cfg(2))."""
    return SlamConfig(
        camera=CameraConfig(width=320, height=240, fx=520.9 / 2,
                            fy=521.0 / 2, cx=325.1 / 2, cy=249.7 / 2,
                            dist=(0, 0, 0, 0, 0), bf=20.0, th_depth=40.0,
                            depth_map_factor=1.0),
        orb=OrbConfig(n_features=500, n_levels=4),
        caps=CapacityConfig(n_kp=512, max_points=16384, max_keyframes=256),
        tracking=TrackingConfig(pipelined_readback=False))


def loop_scene(cfg):
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3, plane_z=4.0)
    for b in scene.boxes:
        b["size"] = 0.9
    return scene


def _sub(fx, prefix):
    return {k[len(prefix):]: fx[k] for k in fx.files if k.startswith(prefix)}


def start_from(sys_, fx, prefix="state."):
    """Set a port system to the JAX system's captured state."""
    cfg = sys_.cfg
    base = interop.map_state_to_numpy(sys_.map)
    sys_.map = interop.map_state_from_numpy(
        interop.overlay_rows(base, _sub(fx, prefix + "m.")), device="cpu")
    sys_.last_frame = interop.frame_from_numpy(
        _sub(fx, prefix + "last."), cfg, device="cpu")
    sys_.velocity = torch.from_numpy(np.array(fx[prefix + "velocity"]))
    (sys_.state, sys_.last_kf_id, sys_.frames_since_kf, sys_.frame_id,
     sys_._kf_inliers, sys_._last_n_inliers) = (
        int(x) for x in fx[prefix + "counters"])
    sys_.trajectory = [
        FrameRecord(timestamp=i / 30.0, Tcw=t, ref_kf=int(r), Tcr=c,
                    tracked=bool(ok))
        for i, (t, r, c, ok) in enumerate(zip(
            fx[prefix + "rec_tcw"], fx[prefix + "rec_ref"],
            fx[prefix + "rec_tcr"], fx[prefix + "rec_tracked"]))]
    interop.loop_state_from_numpy(sys_.loop_closer, _sub(fx, prefix + "loop."))


def _rot_deg(a, b):
    R = a[:3, :3].T.astype(np.float64) @ b[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def replay(fx):
    """The port from the captured state through the closure and two frames
    after it, the JAX run's keyframe decisions and Sim3 draws replayed."""
    cfg = loop_small_cfg()
    scene = loop_scene(cfg)
    poses = loop_trajectory(len(fx["tracked"]), sweep=2 * np.pi * 1.15)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cpu")
    start_from(sys_, fx)
    start, close = int(fx["start"]), int(fx["close_frame"])
    jax_kfs = set(fx["insert_frames"].tolist())
    inserts, draws = [], []
    sets = list(fx["sim3_sets"][int(fx["state.sim3_sets_before"]):])
    sys_._need_keyframe = lambda pend, p: pend["fid"] in jax_kfs
    insert = sys_._insert_impl

    def insert_impl(m, frame, Tcw, kp_pt, close_mask, frame_id):
        inserts.append(int(frame_id))
        return insert(m, frame, Tcw, kp_pt, close_mask, frame_id)
    sys_._insert_impl = insert_impl

    def minimal_sets(valid, n_trials=256):
        draws.append(int(valid.sum()))
        return torch.from_numpy(sets.pop(0))
    sys_.loop_closer._minimal_sets = minimal_sets
    sums = []
    t0 = time.perf_counter()
    frames = range(start + 1, close + 3)
    for i in frames:
        gray, depth, rgb = (np.asarray(x, np.float32)
                            for x in scene.render_rgbd(poses[i])[:3])
        sums.append(float(np.sum(gray, dtype=np.float64)))
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
    return dict(sys=sys_, frames=list(frames), inserts=inserts,
                draws=draws, sums=sums, secs=time.perf_counter() - t0,
                poses=poses)


def test_replay_inputs_and_decisions(fx, replay):
    """The re-rendered frames are the reference's (checksums), every frame
    tracks as the reference's, and the keyframes come on the same
    frames."""
    fr = replay["frames"]
    np.testing.assert_allclose(replay["sums"], fx["gray_sum"][fr],
                               rtol=1e-12, atol=0)
    recs = replay["sys"].trajectory
    assert [r.tracked for r in recs[fr[0]:]] == fx["tracked"][fr].tolist()
    want = [f for f in fx["insert_frames"].tolist() if fr[0] <= f <= fr[-1]]
    assert replay["inserts"] == want


def _event_key(e):
    return (e["q"], e["l"], e["accepted"], e.get("pre_gated", False))


def test_replay_closes_the_loop_as_reference(fx, replay):
    """The same closure (q, l, accepted, pre-gated) on the same keyframe,
    its numbers within 1e-3 relative (bend_deg 0.02 deg) or within the
    reference's own spread, whichever is wider: the farthest that the
    reference's runs of these frames with one-ulp noise in every mapping
    pass's and closure's input (loop_small.npz "noise_events",
    make_reference.py loop_small_noise) land from it on the same closure;
    and the Sim3 draws used one for one."""
    lc = replay["sys"].loop_closer
    ev_j = json.loads(str(fx["events"]))
    assert [_event_key(e) for e in lc.events] == \
        [_event_key(e) for e in ev_j]
    assert lc.n_loops_closed == int(fx["loops_closed"]) == 1
    noise = [run for run in json.loads(str(fx["noise_events"]))
             if [_event_key(e) for e in run] == [_event_key(e) for e in ev_j]]
    assert noise, "no noise run of the reference closes the same loop"
    for i, (et, ej) in enumerate(zip(lc.events, ev_j)):
        for k, v in ej.items():
            if k in ("wall_ms", "q", "l", "accepted", "pre_gated"):
                continue
            spread = max(abs(run[i][k] - v) for run in noise)
            tol = max(0.02 if k == "bend_deg" else 1e-6 + 1e-3 * abs(v),
                      spread)
            assert abs(et[k] - v) <= tol, (k, et[k], v, spread)
    assert len(replay["draws"]) == len(fx["sim3_sets"]) - int(
        fx["state.sim3_sets_before"])


def test_replay_records(fx, replay):
    """Every replayed frame's record within 5 mm / 0.1 deg of the
    reference's, through the closure."""
    recs = replay["sys"].trajectory
    for i in replay["frames"]:
        a, b = recs[i].Tcw, fx["rec_tcw"][i]
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < REC_TOL_M, i
        assert _rot_deg(a, b) < REC_TOL_DEG, i


def _reloc_inputs(fx):
    cfg = loop_small_cfg()
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cpu")
    base = interop.map_state_to_numpy(sys_.map)
    sys_.map = interop.map_state_from_numpy(
        interop.overlay_rows(base, _sub(fx, "state.m.")), device="cpu")
    frame = interop.frame_from_numpy(_sub(fx, "reloc.frame."), cfg,
                                     device="cpu")
    return sys_, frame


def test_relocalize_try_with_reference_sets(fx):
    """Each of the reference's attempts against the captured map, with its
    PnP draw: inliers within 2 and the pose within 5 mm / 0.1 deg of the
    reference attempt's (where PnP found a consensus)."""
    sys_, frame = _reloc_inputs(fx)
    tries = fx["reloc.tries"]
    assert len(tries)
    for i, (kf, n_j) in enumerate(tries):
        sets = torch.from_numpy(fx["reloc.sets"][i])
        tr = trk.relocalize_try(sys_.K, sys_.map, frame, int(kf),
                                lambda valid: sets, sys_.inv_sigma2)
        assert abs(int(tr.n_inliers) - int(n_j)) <= 2, (kf, tr.n_inliers,
                                                          n_j)
        if n_j >= 50:
            Tj = fx[f"reloc.try{i}.Tcw"]
            assert np.abs(tr.Tcw.numpy()[:3, 3] - Tj[:3, 3]).max() < 5e-3
            assert _rot_deg(tr.Tcw.numpy(), Tj) < 0.1


def test_bow_relocalization(fx):
    """SlamSystem._relocalize with loop closing on: the frame's BoW row,
    the candidates in score order, one attempt each with the reference's
    draws, until one reaches 50 inliers: the same attempts, the same
    outcome, and the relocalized pose within 5 cm of the frame's truth."""
    sys_, frame = _reloc_inputs(fx)
    tried = []
    sets = [torch.from_numpy(s) for s in fx["reloc.sets"]]
    try_ = trk.relocalize_try

    def minimal_sets(valid, n_trials=256, k=6):
        return sets.pop(0)
    sys_._minimal_sets = minimal_sets
    trk.relocalize_try = lambda K, m, fr, kf, fn, s: (
        tried.append(kf) or try_(K, m, fr, kf, fn, s))
    try:
        tr = sys_._relocalize(frame)
    finally:
        trk.relocalize_try = try_
    assert tried == fx["reloc.tries"][:, 0].tolist()
    assert (tr is not None) == bool(fx["reloc.ok"])
    assert sys_.n_relocalized == int(tr is not None)
    if tr is not None:
        T = loop_trajectory(len(fx["tracked"]), sweep=2 * np.pi * 1.15)[2]
        assert np.abs(tr.Tcw.numpy()[:3, 3] - T[:3, 3]).max() < 0.05


def small_cfg(**tracking):
    return SlamConfig(
        camera=CameraConfig(width=160, height=120, fx=130.0, fy=130.0,
                            cx=80.0, cy=60.0, dist=(0, 0, 0, 0, 0),
                            bf=13.0, th_depth=40.0, depth_map_factor=1.0),
        orb=OrbConfig(n_features=300, n_levels=4),
        caps=CapacityConfig(n_kp=384, max_points=8192, max_keyframes=64),
        tracking=TrackingConfig(**{"pipelined_readback": False, **tracking}))


def test_async_mapping_with_loop():
    """Async mapping with the loop on: pending_kf names the keyframe whose
    pass is in flight and clears at the merge; the closer sees each
    keyframe once, after its pass merged, on the calling thread."""
    import threading
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      async_mapping=True, device="cpu")
    am, lc = sys_._async, sys_.loop_closer
    log = []
    dispatch, merge, on_kf = am.dispatch, am.merge, lc.on_keyframe

    def disp(m, kf_id, fast):
        dispatch(m, kf_id, fast)
        log.append(("dispatch", kf_id, am.pending_kf))

    def mrg(m_now):
        kf = am.pending_kf
        out = merge(m_now)
        log.append(("merge", kf, am.pending_kf))
        return out

    def okf(m, kf):
        log.append(("on_keyframe", kf, threading.current_thread()
                    is threading.main_thread()))
        return on_kf(m, kf)
    am.dispatch, am.merge, lc.on_keyframe = disp, mrg, okf
    for i, T in enumerate(orbit_poses(6, step=0.02)):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
    sys_.flush_mapping()
    sys_.shutdown()
    dispatched = [kf for ev, kf, _ in log if ev == "dispatch"]
    assert len(dispatched) >= 2
    assert all(p == kf for ev, kf, p in log if ev == "dispatch")
    assert all(p == -1 for ev, _, p in log if ev == "merge")
    # keyframe 0 (the initializing one) has no pass; every dispatched
    # keyframe is detected once, right after its merge, on this thread
    calls = [(kf, main) for ev, kf, main in log if ev == "on_keyframe"]
    assert [kf for kf, _ in calls] == [0] + dispatched
    assert all(main for _, main in calls)
    for kf in dispatched:
        i = log.index(("merge", kf, -1))
        assert log[i + 1][:2] == ("on_keyframe", kf)
    rows = (sys_.map.kf_bow != 0).any(dim=1)
    assert bool(rows[sys_.map.kf_valid].all())


def test_reset_mid_pass_keeps_no_pre_reset_rows():
    """reset() with an async pass in flight joins and drops it (the port's
    departure from the reference, whose reset leaves the pass pending and
    lays it over the new map at the next merge): a pass held in flight
    across the reset carries a marker in every point it returns; after
    the reset, new keyframes and their merges, no point of the new map
    carries it. With the loop on, reset leaves kf_bow zero and the
    closer's groups empty."""
    cfg = small_cfg()
    scene = SyntheticScene.make(cfg, seed=1, n_objects=0)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      async_mapping=True, device="cpu")
    marker = -7777
    run = sys_._async.run
    held = {"on": True}              # every pass before the reset

    def marked(m, kf_id, fast):
        res = run(m, kf_id, fast)
        if held["on"]:
            time.sleep(0.5)          # still in flight when reset() comes
            res = res._replace(pt_first_kf=torch.full_like(res.pt_first_kf,
                                                           marker))
        return res
    sys_._async.run = marked
    poses = orbit_poses(10, step=0.02)
    n = 0
    while sys_._async.pending is None:
        gray, depth, rgb, _ = scene.render_rgbd(poses[n])
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=n / 30.0)
        n += 1
    assert not sys_._async.pending[0].done()     # reset comes mid-pass
    sys_.loop_closer.consistent_groups = [({1, 2}, 1)]
    sys_.reset()
    held["on"] = False
    assert sys_._async.pending is None and sys_._async.pending_kf == -1
    assert not bool(torch.any(sys_.map.kf_bow != 0))
    assert sys_.map.kf_bow.shape == (cfg.caps.max_keyframes, 10000)
    assert sys_.loop_closer.consistent_groups == []
    assert sys_.loop_closer.last_loop_kf == -10
    merges = sys_.mapping_stats["barrier_merges"]
    for i, T in enumerate(poses[n:]):
        gray, depth, rgb, _ = scene.render_rgbd(T)
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=(i + n) / 30.0)
    sys_.flush_mapping()
    sys_.shutdown()
    assert sys_.mapping_stats["barrier_merges"] > merges
    assert not bool(torch.any(sys_.map.pt_first_kf == marker))
    assert int(sys_.map.n_kf) >= 2 and sys_.state == 1


def test_run_tum_torch_loop(tmp_path):
    """scripts/run_tum_torch.py --loop on a 3-frame TUM-format directory on
    the CPU: every keyframe gets a BoW row, no closure, and the summary
    carries loops_closed, loops_rejected and loop_events."""
    from object_slam_tpu_torch.datasets import tum
    cfg = SlamConfig.tum_rgbd()
    scene = SyntheticScene.make(cfg, seed=3, n_objects=3)
    for b in scene.boxes:
        b["size"] = 0.9
    poses = orbit_poses(3, step=0.01)
    renders = []
    for T in poses:
        _, depth, rgb, sem = scene.render_rgbd(T)
        renders.append((depth, rgb, scene.sem_arrays(sem, 16)))
    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    tum.write_sequence(seq, poses, renders, cfg.camera.depth_map_factor)
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "run_tum_torch.py"),
         "--seq", seq, "--semantic-dir", os.path.join(seq, "semantic"),
         "--out", out, "--device", "cpu", "--loop"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS=str(THREADS)))
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert res["frames"] == 3 and res["keyframes"] >= 1
    assert res["loops_closed"] == 0 and res["loops_rejected"] == 0
    assert res["loop_events"] == []
    assert res["bow_rows"] == res["keyframes"]
