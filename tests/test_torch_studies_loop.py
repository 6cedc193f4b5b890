"""scripts/diag_loop_torch.py's closure probe and
scripts/diag_loop_alias_torch.py's gates against the JAX package on the
CPU, from the reference's runs recorded in tests/torch_fixtures/
studies.npz (make_reference.py studies) and loop_small.npz.

The closure probe: the small circuit (tests/test_torch_loop_system.py's
replay: 320x240, strict readback, the JAX run's keyframe decisions and
Sim3 draws, from its state LOOP_SMALL_REPLAY frames before the closing
keyframe) with the probe on the port's closer, seeded with the reference
run's keyframe-to-frame map at that state. Held: each closure's (q, l,
accepted) exact; its Sim3 and drift errors and every keyframe's error
after it within the replay's record band (5 mm / 0.1 deg).

The corridor: at VGA the JAX run makes six candidates in 320 frames,
every one refused by the pre-gate, none by the post-gates, and a whole
corridor does not fit a CPU test. So the gates are held on the
reference's recorded input of its first candidate (frame 71: map rows,
q, l, T12, s12): the pre-gate's event exactly in its decision, its
numbers within 1e-3 relative; and, with the pre-gate's absolute limits
lifted (the JAX side) or the pre-gate disabled (the port, a planted
fault of tests/torch_fixtures/faults.py), the full correction and the
post-gates' event: the same decision of each gate, the numbers within
1e-3 relative (bend_deg 0.02 deg, the arccos resolution of f32
rotations). The run with the pre-gate disabled must fail the pre-gate's
check. The whole corridor runs on the card (chip_smoke.py)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from object_slam_tpu_torch import interop
from object_slam_tpu_torch.slam.system import SlamSystem
from torch_fixtures import faults
from torch_fixtures.threads import share_cores
from test_torch_loop_system import loop_scene, loop_small_cfg, start_from

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "studies.npz")
LOOP_SMALL = os.path.join(ROOT, "tests", "torch_fixtures", "loop_small.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import diag_loop_alias_torch as alias  # noqa: E402
import diag_loop_torch as probe_mod  # noqa: E402

REC_TOL_MM = 5.0
REC_TOL_DEG = 0.1
EVENT_RTOL = 1e-3
BEND_DEG_TOL = 0.02


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _sub(fx, prefix):
    return {k[len(prefix):]: fx[k] for k in fx.files if k.startswith(prefix)}


def candidate(fx, fault=None):
    """The port's _correct_loop on the corridor's recorded first candidate:
    (event, accepted)."""
    cfg = alias.build_cfg(1)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cpu")
    lc = sys_.loop_closer
    if fault is not None:
        fault(lc)
    base = interop.map_state_to_numpy(sys_.map)
    m = interop.map_state_from_numpy(
        interop.overlay_rows(base, _sub(fx, "alias.pre.m.")), device="cpu")
    _, accepted = lc._correct_loop(
        m, int(fx["alias.pre.q"]), int(fx["alias.pre.l"]),
        torch.from_numpy(fx["alias.pre.T12"]), float(fx["alias.pre.s12"]))
    return lc.events[-1], accepted


@pytest.fixture(scope="module")
def post(fx):
    return candidate(fx, fault=faults.disable_pre_gate)


def event_mismatches(got, want):
    """The keys whose values part: decisions exactly, numbers within
    EVENT_RTOL relative (bend_deg BEND_DEG_TOL)."""
    bad = []
    for k, v in want.items():
        if k == "wall_ms":
            continue
        g = got.get(k)
        if isinstance(v, bool) or k in ("q", "l"):
            if g != v:
                bad.append((k, g, v))
        elif g is None or abs(g - v) > max(
                BEND_DEG_TOL if k == "bend_deg" else 0.0,
                1e-9 + EVENT_RTOL * abs(v)):
            bad.append((k, g, v))
    return bad + [(k, got[k], None) for k in set(got) - set(want)
                  if k != "wall_ms"]


def gates(ev, cfg):
    """Each post-gate's decision: (benefit, bend deg, bend frac)."""
    loop = cfg.loop
    return (ev["q_after"] <= ev["q_before"] * (1.0 + loop.benefit_gate_tolerance)
            + loop.benefit_gate_abs_floor,
            ev["bend_deg"] <= ev["budget_deg"],
            ev["bend_frac"] <= ev["budget_frac"])


def test_corridor_pre_gate_matches_reference(fx):
    """The first candidate is refused by the pre-gate, as the reference
    refused it, with the same numbers."""
    want = json.loads(str(fx["alias.pre.event"]))
    assert want["pre_gated"] and not want["accepted"]
    ev, accepted = candidate(fx)
    assert not accepted
    assert not event_mismatches(ev, want), event_mismatches(ev, want)
    events = json.loads(str(fx["alias.events"]))
    assert all(e["pre_gated"] and not e["accepted"] for e in events)


def test_corridor_post_gates_match_reference(fx, post):
    """With the pre-gate out of the way the speculative correction runs
    and the post-gates refuse it, each gate deciding as the reference's."""
    want = json.loads(str(fx["alias.postgate.event"]))
    ev, accepted = post
    assert not accepted and not want["accepted"]
    cfg = alias.build_cfg(1)
    assert gates(ev, cfg) == gates(want, cfg)
    assert not event_mismatches(ev, want), event_mismatches(ev, want)


def test_corridor_fault_pre_gate_disabled_fails(fx, post):
    """The candidate with the pre-gate disabled misses the replayed
    pre-gate event: the corridor's checks see a disabled pre-gate."""
    assert event_mismatches(post[0], json.loads(str(fx["alias.pre.event"])))


def test_alias_scene_and_path_are_the_reference():
    """The corridor's texture draws and furniture, and the path, as the
    reference builds them (RandomState(7): the draws' order)."""
    cfg = alias.build_cfg(4)
    scene = alias.build_alias_scene(cfg)
    assert len(scene.surfaces) == 6 and len(scene.structures) == 64
    assert scene.surfaces[0]["tex"] is scene.surfaces[1]["tex"]
    cell = [s["center"] for s in scene.structures[:4]]
    assert np.allclose([s["center"][2] for s in scene.structures[4:8]],
                       [c[2] + 3.2 for c in cell])
    path = alias.straight_path(3)
    assert np.allclose(path[2][:3, 3], [0.15 * np.sin(0.3), 0.0, 0.4])


@pytest.fixture(scope="module")
def probe_run(fx):
    """The small circuit replayed through its closure with the closure
    probe on the port's closer."""
    lfx = np.load(LOOP_SMALL)
    cfg = loop_small_cfg()
    scene = loop_scene(cfg)
    from object_slam_tpu_torch.datasets.synthetic import loop_trajectory
    poses = loop_trajectory(len(lfx["tracked"]), sweep=2 * np.pi * 1.15)
    sys_ = SlamSystem(cfg, enable_objects=False, enable_loop=True,
                      device="cpu")
    start_from(sys_, lfx)
    jax_kfs = set(lfx["insert_frames"].tolist())
    sets = list(lfx["sim3_sets"][int(lfx["state.sim3_sets_before"]):])
    sys_._need_keyframe = lambda pend, p: pend["fid"] in jax_kfs
    sys_.loop_closer._minimal_sets = \
        lambda valid, n_trials=256: torch.from_numpy(sets.pop(0))
    kf_frame = {int(k): int(f) for k, f in fx["probe.kf_frame"]}
    probe = probe_mod.ClosureProbe(sys_.loop_closer, poses, kf_frame,
                                   log=lambda s: None)
    start, close = int(lfx["start"]), int(lfx["close_frame"])
    for i in range(start + 1, close + 1):
        probe.current_frame[0] = i
        gray, depth, rgb = (np.asarray(x, np.float32)
                            for x in scene.render_rgbd(poses[i])[:3])
        sys_.track_rgbd(gray, depth, rgb, None, timestamp=i / 30.0)
        if sys_.last_kf_id >= 0 and sys_.last_kf_id not in kf_frame:
            kf_frame[sys_.last_kf_id] = i
    return probe


def test_closure_probe_matches_reference(fx, probe_run):
    """Each closure's outcome as the reference's probe recorded it; its
    Sim3 and drift errors and the keyframe errors after it within the
    replay's record band."""
    want = json.loads(str(fx["probe.events"]))
    want_kf = json.loads(str(fx["probe.kf_errors"]))
    got = probe_run.events
    assert [(e["q"], e["l"], e["accepted"]) for e in got] == \
        [(e["q"], e["l"], e["accepted"]) for e in want]
    assert any(e["accepted"] for e in got)
    for e, w in zip(got, want):
        for k in ("sim3_trans_err_mm", "drift_trans_mm"):
            assert abs(e[k] - w[k]) <= REC_TOL_MM, (k, e[k], w[k])
        for k in ("sim3_rot_err_deg", "drift_rot_deg"):
            assert abs(e[k] - w[k]) <= REC_TOL_DEG, (k, e[k], w[k])
    for (before, after), (wb, wa) in zip(probe_run.kf_errors, want_kf):
        for got_d, want_d in ((before, wb), (after, wa)):
            assert sorted(str(k) for k in got_d) == sorted(want_d)
            d = max(abs(got_d[int(k)] - v) for k, v in want_d.items())
            assert d <= REC_TOL_MM, d
