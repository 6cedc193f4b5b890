"""System facade: the per-frame orchestration loop (RGB-D, stereo, mono).

Counterpart of object_slam_tpu/slam/system.py. ``track_rgbd`` builds the
frame from arrays, ``track_rgbd_blob`` from one uint8 blob
(``FrameBuilder.pack_frame_blob``), ``track_stereo`` from a rectified
pair, ``track_mono`` from one image. With depth, the first frame with
enough of it initializes the map (``_stereo_init_impl``, then the object
update). In mono, a reference frame is held until a later frame matches
it well enough for the two-view initializer (``_mono_initialize``,
solvers/initializer.py): the triangulated points and the two keyframes
start the map. A frame tracked while mapping is on and the state is OK
runs the fused tracking chain, with
the object stages as its hooks when objects are on (``_track_fused``); its
packed result is read back one frame late by default
(``tracking.pipelined_readback``): a non-blocking copy into pinned memory
at dispatch, resolved (``_resolve_one``: trajectory record, state machine,
keyframe insertion, the local-mapping pass, relocalization) after the
next frame's dispatch. ``pipelined_readback=False`` resolves every frame
at once. A LOST frame, and every frame with ``tracking.fused=False``,
takes the staged path (``_track_staged``), whose failure branch
relocalizes (``_relocalize``): with loop closing on, against the BoW
candidate keyframes one by one (``tracking.relocalize_try``); without it,
against the whole map (brute match, PnP RANSAC).

With ``async_mapping=True`` each keyframe's local-mapping pass runs on a
snapshot of the map in a worker thread with its own CUDA stream (the
LocalMapping thread's analogue, ``_AsyncMapping``) while tracking goes on:
on a second card when there is one (``cuda:1``, as the reference takes
its second device), else on a side stream of the tracker's card; the
result is merged in at the next keyframe, when ready on the staged path,
and at ``flush_mapping``.

With ``enable_loop=True`` every keyframe gets its BoW row and goes through
loop detection (``loop.loop_closing.LoopCloser.on_keyframe``) once its
local-mapping pass is in the map: after the pass inline, or after the
merge of its async pass, on the tracker's stream.

Localization mode (``enable_mapping=False``,
``activate_localization_mode``) sends every frame down the staged path,
where the motion model also tracks temporal VO points
(``tracking.track_motion_model_vo``) and a frame with few map matches
keeps the VO pose (``vo_mode``); no object update, keyframe or mapping
merge happens while it is on. ``shutdown(checkpoint_path)`` writes the
map and the bookkeeping after the flush (slam/checkpoint.py).

State machine (Tracking.h:99-105): NOT_INITIALIZED -> OK <-> LOST.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from object_slam_tpu_torch.config import SlamConfig
from object_slam_tpu_torch.device import indexed, resolve_device
from object_slam_tpu_torch.features import matching
from object_slam_tpu_torch.geometry import se3
from object_slam_tpu_torch.loop import kfdb
from object_slam_tpu_torch.loop.loop_closing import LoopCloser
from object_slam_tpu_torch.loop.vocabulary import Vocabulary
from object_slam_tpu_torch.ops.scatter import scatter_set, topk
from object_slam_tpu_torch.slam import checkpoint, local_mapping, map_ops
from object_slam_tpu_torch.slam import tracking as trk
from object_slam_tpu_torch.slam.frame import FrameBuilder, FrameData
from object_slam_tpu_torch.slam.map_state import MapState, init_map
from object_slam_tpu_torch.slam.objects import ObjectEngine
from object_slam_tpu_torch.solvers import ransac
from object_slam_tpu_torch.solvers.epnp import pnp_ransac_sets
from object_slam_tpu_torch.solvers.initializer import initialize_mono_sets
from object_slam_tpu_torch.utils.profiling import StageProfiler

NOT_INITIALIZED, OK, LOST = 0, 1, 2
STATE_NAMES = {NOT_INITIALIZED: "NOT_INITIALIZED", OK: "OK", LOST: "LOST"}


@dataclass
class FrameRecord:
    timestamp: float
    Tcw: np.ndarray            # [4, 4] absolute (at track time)
    ref_kf: int
    Tcr: np.ndarray            # pose relative to reference KF
    tracked: bool


class _AsyncMapping:
    """The local-mapping pass off the tracking path: the LocalMapping
    thread's analogue (LocalMapping.cc:48-113) and the reference's
    ``_AsyncMapping`` (object_slam_tpu/slam/system.py:195-262).

    ``dispatch`` runs the pass on a snapshot of the map in a worker thread.
    The port's pass reads the device on the host (the BA early exits, the
    keyframe-culling loop), so it cannot be queued on a stream and left: it
    needs a host thread. On the card the thread runs on its own stream,
    which first waits on an event recorded on the tracker's stream at
    dispatch (the snapshot is complete there). The snapshot's tensors are
    recorded on the side stream, the result's on the tracker's stream at
    merge, so the caching allocator never hands memory one stream still
    reads to the other; the pending tuple holds the snapshot until the
    merge. ``merge`` joins the thread, makes the current stream wait on the
    pass's done event, then overlays what the tracker wrote meanwhile (the
    additive point counters and the object slabs). A failure in the worker
    is raised again by ``ready``, ``merge`` and ``join``. On the CPU the
    same code runs without streams.

    With ``device`` (the reference's second device) the pass runs there:
    the worker copies the snapshot to ``device`` on a stream of that card
    once the dispatch event has passed, and ``merge`` copies the result
    back to ``home_device`` (on the side stream, behind the pass) before
    the overlay; the snapshot's counters stay on the home device, as the
    reference keeps them. The copies are made even when ``device`` is the
    home device, so that this branch runs on one card and on the CPU.
    Without ``device`` the pass stays on the home device (a side stream
    of its card, or a thread on the CPU)."""

    def __init__(self, run, home_device, device=None):
        self.run = run                  # run(m, kf_id, fast) -> MapState
        self.home = indexed(home_device)
        self.device = None if device is None else indexed(device)
        on = self.home if self.device is None else self.device
        self.stream = torch.cuda.Stream(on) if on.type == "cuda" else None
        self._pool = None     # the worker thread, started at dispatch
        self.pending = None   # (future, snapshot, done event or None)
        self.pending_kf = -1  # the keyframe whose pass is in flight
        self.worker_ms: List[float] = []

    @property
    def placement(self) -> str:
        """Where the pass runs: "<card> side stream", "cpu thread", or the
        other device ("cuda:1"; "<device> (copied)" when the copies go to
        the home device itself)."""
        if self.device is None:
            return (f"{self.home} side stream" if self.stream is not None
                    else "cpu thread")
        return str(self.device) + (" (copied)" if self.device == self.home
                                   else "")

    @staticmethod
    def _merge_impl(res, m_now, s_vis, s_found, s_lc, s_lt):
        """The mapping result with the tracker's in-flight writes laid over
        it: the additive counters as result + (now - snapshot), point
        ownership where the result's point is valid, and every object field
        from the live map."""
        obj_fields = {f: getattr(m_now, f) for f in MapState._fields
                      if f.startswith("obj_")}
        return res._replace(
            pt_visible=res.pt_visible + (m_now.pt_visible - s_vis),
            pt_found=res.pt_found + (m_now.pt_found - s_found),
            pt_label_cnt=res.pt_label_cnt + (m_now.pt_label_cnt - s_lc),
            pt_label_tot=res.pt_label_tot + (m_now.pt_label_tot - s_lt),
            pt_obj=torch.where(res.pt_valid, m_now.pt_obj,
                               torch.full_like(m_now.pt_obj, -1)),
            n_obj=m_now.n_obj, next_track_id=m_now.next_track_id,
            **obj_fields)

    def _work(self, m, kf_id, fast, start, done):
        t0 = time.perf_counter()
        with torch.profiler.record_function("local_mapping_async"):
            if self.stream is None:
                res = self.run(self._side(m), kf_id, fast)
            else:
                with _on_stream(self.stream):
                    self.stream.wait_event(start)
                    res = self.run(self._side(m), kf_id, fast)
                    done.record(self.stream)
        self.worker_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    def _side(self, m):
        """The snapshot as the pass reads it: copied to ``device`` when
        there is one."""
        return m if self.device is None else _copy_map(m, self.device)

    def dispatch(self, m: MapState, kf_id: int, fast: bool):
        """Start the pass for keyframe kf_id on the snapshot m (the map the
        insertion returned; nothing writes to its tensors in place)."""
        if self.pending is not None:
            raise RuntimeError("a mapping pass is already in flight; merge "
                               "it before dispatching another")
        start = done = None
        if self.stream is not None:
            start, done = torch.cuda.Event(), torch.cuda.Event()
            start.record(torch.cuda.current_stream(self.home))
            for t in m:
                t.record_stream(self.stream)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="local-mapping")
        fut = self._pool.submit(self._work, m, kf_id, fast, start, done)
        self.pending = (fut, m, done)
        self.pending_kf = kf_id

    def ready(self) -> bool:
        """True when a pass is pending, its thread has finished and its
        device work is complete; a failed pass raises here."""
        if self.pending is None:
            return False
        fut, _, done = self.pending
        if not fut.done():
            return False
        fut.result()                     # raises the worker's exception
        return done is None or done.query()

    def merge(self, m_now: MapState) -> MapState:
        """Join the pending pass and return its result with the tracker's
        writes since the dispatch laid over it (m_now when none is
        pending)."""
        if self.pending is None:
            return m_now
        fut, snap, done = self.pending
        self.pending = None
        self.pending_kf = -1
        res = fut.result()
        if self.device is not None:
            res, done = self._home(res)
        if done is not None:
            cur = torch.cuda.current_stream(self.home)
            cur.wait_event(done)
            for t in res:
                t.record_stream(cur)
        return self._merge_impl(res, m_now, snap.pt_visible, snap.pt_found,
                                snap.pt_label_cnt, snap.pt_label_tot)

    def _home(self, res):
        """The pass's result copied to the home device, and the event the
        copy ends on (None on the CPU). On the card the copy is queued on
        the side stream, behind the pass."""
        if self.stream is None:
            return _copy_map(res, self.home), None
        with _on_stream(self.stream):
            back = _copy_map(res, self.home)
            done = torch.cuda.Event()
            done.record(self.stream)
        return back, done

    def join(self):
        """Wait for a pending pass and drop it (reset); a failed pass
        raises."""
        if self.pending is None:
            return
        fut = self.pending[0]
        self.pending = None
        self.pending_kf = -1
        fut.result()

    def close(self):
        """Stop the worker thread (a later dispatch starts a new one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def _copy_map(m: MapState, device) -> MapState:
    """Every tensor of m copied to device (a copy also on its own)."""
    return MapState(*(t.to(device, copy=True) for t in m))


@contextmanager
def _on_stream(stream):
    """stream's card current and stream selected on it."""
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


# the reference's StageProfiler names (object_slam_tpu/slam/system.py) of
# the port's _span stages; the staged path opens track.motion_model,
# track.local_map and track.kf_policy on the profiler alone
PROFILER_NAMES = {
    "object_assoc": "track.obj_associate",
    "object_update": "track.obj_update",
    "mapping_dispatch": "mapping.dispatch",
    "local_mapping": "mapping.process_kf",
    "track_fused": "track.fused",
    "resolve": "track.resolve",
}


class SlamSystem:
    def __init__(self, cfg: Optional[SlamConfig] = None,
                 enable_objects: bool = True,
                 enable_mapping: bool = True,
                 enable_loop: bool = False,
                 async_mapping: bool = False,
                 vocab_path: Optional[str] = None,
                 device=None, profile: bool = False, metrics=None):
        self.cfg = cfg or SlamConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        self.builder = FrameBuilder(cfg, device=self.device)
        self.K = self.builder.K
        self.inv_sigma2 = self.builder.inv_sigma2
        self.scale_factors = self.builder.scale_factors
        self.log_scale = math.log(cfg.orb.scale_factor)
        # the reference's stage profiler (utils/profiling.py), on with
        # ``profile`` or when a caller sets profiler.enabled: its spans
        # carry the reference's names (PROFILER_NAMES) and synchronize the
        # card at both ends
        self.profiler = StageProfiler(enabled=profile, device=self.device)
        self.loop_closer = None
        if enable_loop:
            # a DBoW2 text vocabulary (the reference's ORBvoc.txt format),
            # or the package's own
            vocab = (Vocabulary.load_dbow2_text(vocab_path) if vocab_path
                     else None)
            self.loop_closer = LoopCloser(
                cfg, self.K, vocab=vocab, fix_scale=cfg.sensor != "mono",
                device=self.device, span=self._span)
        self.map = self._empty_map()
        self.enable_mapping = enable_mapping
        self.objects = (ObjectEngine(cfg, self.K, device=self.device)
                        if enable_objects else None)
        self._obj_hooks = None
        if self.objects is not None:
            self._obj_hooks = (
                self._timed("object_assoc", self.objects.assoc_impl),
                self._timed("semopt", self.objects.semopt_impl)
                if cfg.objects.semopt_enabled else None,
                self._timed("object_update", self.objects.update_impl))
        # structured per-frame metrics (utils/metrics.MetricsStream or None)
        self.metrics = metrics

        self.state = NOT_INITIALIZED
        self.last_frame: Optional[FrameData] = None
        self.velocity = self._eye()
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.trajectory: List[FrameRecord] = []
        self._kf_inliers = 0
        self._last_n_inliers = -1
        self._host_ts = 0.0
        self._fused_pending = None   # the lagged fused readback
        self._mono_ref = None        # mono: the initializer's first view
        # the pose before the semantic refinement of the last frame that
        # took the staged objects-on branch (a tensor on the device), else
        # None; cleared at every frame's start
        self._last_presem_Tcw = None
        # the last tracked frame's stage results for the diagnostics
        # (scripts/diag_retention_torch.py): {"tr_motion", "tr_local",
        # "T_pred", "frame"} of device tensors, the fused path without
        # T_pred; None until a frame is tracked and after reset()
        self.debug_last = None
        # the RANSAC sampler's stream (the reference's PRNGKey(0))
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(0)
        self.n_relocalized = 0
        # local-mapping passes run / on the abbreviated schedule, and the
        # async merges by where they happened
        self.mapping_stats = {"passes": 0, "abbreviated": 0,
                              "barrier_merges": 0, "ready_merges": 0,
                              "flush_merges": 0}
        side = self._side_device() if async_mapping else None
        # the scale tables the mapping pass reads, on each device a pass
        # may run on (copied to the second card once, here)
        self._pass_tables = {
            d: (self.scale_factors.to(d), self.inv_sigma2.to(d))
            for d in (self.scale_factors.device, side) if d is not None}
        self._async = (_AsyncMapping(self._mapping_pass, self.device,
                                     device=side)
                       if async_mapping else None)

    def _side_device(self):
        """The async mapping pass's device: a second card when there is
        one (the reference's ``devs[1]``), else None (a side stream of the
        tracker's card, or a thread on the CPU)."""
        if self.device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        home = indexed(self.device).index
        return torch.device("cuda", 1 if home != 1 else 0)

    def _eye(self):
        return torch.eye(4, dtype=torch.float32, device=self.device)

    def _empty_map(self) -> MapState:
        """init_map, with a [max_keyframes, n_words] kf_bow when loop
        closing is on."""
        n_words = (self.loop_closer.vocab.n_words
                   if self.loop_closer is not None else 0)
        return init_map(self.cfg.caps, self.cfg.objects.history_capacity,
                        n_bow_words=n_words, device=self.device)

    def _on_keyframe(self, kf_id: int):
        """Loop detection (and closure) for a keyframe whose mapping pass
        is in the map."""
        if self.loop_closer is None or kf_id < 0:
            return
        with self._span("loop.on_keyframe"):
            self.map, _ = self.loop_closer.on_keyframe(self.map, kf_id)

    @contextmanager
    def _span(self, name: str):
        """A torch.profiler range named ``name`` and a profiler span under
        the reference's name for the stage."""
        with torch.profiler.record_function(name), \
                self.profiler.span(PROFILER_NAMES.get(name, name)):
            yield

    def _timed(self, name: str, fn):
        """fn inside a profiling span (stages nested in track_fused)."""
        def run(*args):
            with self._span(name):
                return fn(*args)
        return run

    # ------------------------------------------------------------------
    # public per-frame API
    # ------------------------------------------------------------------
    def track_rgbd(self, gray, depth, rgb, sem_arrays=None, timestamp=0.0):
        """gray [H, W] 0..255 (None: luma of rgb); depth [H, W] metric
        (or raw u16); rgb [H, W, 3]. numpy arrays or tensors."""
        with self._span("frame_build"):
            frame = self.builder.build_rgbd(gray, depth, rgb, sem_arrays,
                                            timestamp)
        self._host_ts = float(timestamp)
        return self._track_and_emit(frame)

    def track_rgbd_blob(self, blob, inst_valid, timestamp=0.0):
        """Single-transfer RGB-D entry: blob from
        FrameBuilder.pack_frame_blob (host numpy, moved by one copy from
        pinned memory, or a uint8 tensor already on the device);
        inst_valid the host's detection flags (None: no detections)."""
        with self._span("frame_build"):
            frame = self.builder.build_rgbd_blob(blob, inst_valid, timestamp)
        self._host_ts = float(timestamp)
        return self._track_and_emit(frame)

    def track_stereo(self, gray_l, gray_r, rgb, sem_arrays=None,
                     timestamp=0.0):
        """gray_l / gray_r [H, W] rectified pair (u8 or float, numpy or
        tensors); rgb [H, W, 3] or None (grayscale rig)."""
        with self._span("frame_build"):
            frame = self.builder.build_stereo(gray_l, gray_r, rgb,
                                              sem_arrays, timestamp)
        self._host_ts = float(timestamp)
        return self._track_and_emit(frame)

    def track_mono(self, gray, timestamp=0.0):
        """gray [H, W] (u8 or float, numpy or a tensor), undistorted by the
        camera's coefficients like the other sensors. Before the map
        exists the frame goes to the two-view initializer."""
        with self._span("frame_build"):
            frame = self.builder.build_mono(gray, timestamp)
        self._host_ts = float(timestamp)
        if self.state == NOT_INITIALIZED:
            return self._mono_initialize(frame)
        return self._track_and_emit(frame)

    def _track_and_emit(self, frame: FrameData):
        """_track, then one metrics record of host state the loop already
        holds (no device read)."""
        if self.metrics is None:
            return self._track(frame)
        prev_kf = self.last_kf_id
        fid = self.frame_id
        t0 = time.perf_counter()
        out = self._track(frame)
        self.metrics.emit(
            frame=fid, ts=self._host_ts, state=STATE_NAMES[self.state],
            track_ms=round((time.perf_counter() - t0) * 1e3, 3),
            n_inliers=int(self._last_n_inliers),
            kf_inserted=self.last_kf_id != prev_kf,
            ref_kf=self.last_kf_id,
            frames_since_kf=self.frames_since_kf)
        return out

    # ------------------------------------------------------------------
    def _mono_skip(self, frame: FrameData, new_ref: bool):
        """An untracked frame before the mono map exists; new_ref makes it
        the initializer's reference view."""
        if new_ref:
            self._mono_ref = frame
        self._record(frame, False)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _mono_sets(self, valid, n_trials: int = 200):
        """The initializer's [T, 8] F and [T, 4] H index sets, drawn in
        that order from this system's generator."""
        return (self._minimal_sets(valid, n_trials, 8),
                self._minimal_sets(valid, n_trials, 4))

    def _mono_initialize(self, frame: FrameData):
        """Tracking::MonocularInitialization: match the reference view,
        run the two-view initializer, and on success insert the reference
        view at the identity with the triangulated points and this frame
        at T21 observing them (CreateInitialMapMonocular)."""
        cfg = self.cfg
        ref = self._mono_ref
        if ref is None or int(torch.sum(frame.valid)) < 100:
            return self._mono_skip(frame, new_ref=True)
        midx, mok = matching.brute_match(
            ref.desc, ref.valid, frame.desc, frame.valid, th_dist=50,
            nn_ratio=0.9, angle_a=ref.angle, angle_b=frame.angle)
        if int(torch.sum(mok)) < cfg.tracking.min_init_matches:
            return self._mono_skip(frame, new_ref=True)
        N = frame.uv.shape[0]
        mi = torch.clamp(midx, 0, N - 1).long()
        with self._span("mono_init"):
            init = initialize_mono_sets(
                *self._mono_sets(mok), self.K, ref.uv, frame.uv[mi], mok,
                min_inliers=cfg.tracking.min_init_inliers)
            ok = bool(init.ok)
        if not ok:
            return self._mono_skip(frame, new_ref=False)
        # the reference scales the map to median depth 1 with jnp.median
        # over the depths of the good points and NaN elsewhere; the NaN
        # propagates and nan_to_num makes the scale 1 unless every slot is
        # good (ROADMAP.md, queue 3). torch.quantile propagates NaN too and
        # interpolates the two middles of an even count as jnp.median does.
        z = torch.where(init.good, init.pw[:, 2],
                        torch.full_like(init.pw[:, 2], math.nan))
        med = torch.clamp(torch.nan_to_num(torch.quantile(z, 0.5), nan=1.0),
                          min=1e-6)
        pw = init.pw / med
        T21 = init.T21.clone()
        T21[:3, 3] = init.T21[:3, 3] / med

        # keyframe 0 at the identity with the reference view's keypoints;
        # the triangulated points spawn through their depth in that view
        ref2 = ref._replace(depth=torch.where(init.good, pw[:, 2],
                                              torch.full_like(pw[:, 2], -1.0)))
        none = torch.full((N,), -1, dtype=torch.int32, device=self.device)
        with self._span("insert_keyframe"):
            self.map, kf0 = self._insert_impl(
                self.map, ref2, self._eye(), none, init.good,
                max(self.frame_id - 1, 0))
            # keyframe 1 observes the same points at the matched keypoints
            kp_pt1 = scatter_set(none, mi, torch.where(
                init.good, self.map.kf_kp_pt[int(kf0)], none[mi]))
            self.map, kf1 = self._insert_impl(
                self.map, frame, T21, kp_pt1,
                torch.zeros(N, dtype=torch.bool, device=self.device),
                self.frame_id)
        frame = frame._replace(Tcw=T21, kp_pt=kp_pt1,
                               pose_ok=torch.tensor(True, device=self.device))
        self.state = OK
        self.last_kf_id = int(kf1)
        self.frames_since_kf = 0
        self._record(frame, True)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _track(self, frame: FrameData):
        self._last_presem_Tcw = None
        fused = self.cfg.tracking.fused and self.enable_mapping
        if self.state == OK and fused:
            # dispatch BEFORE resolving the previous frame's lagged readback;
            # the state is one frame stale (a pending LOST costs one wasted
            # dispatch)
            return self._track_fused(frame)
        # the other paths fold in the lagged result first, so the state
        # machine is current
        self._resolve_fused_pending()
        if self.state == NOT_INITIALIZED:
            return self._initialize(frame)
        if self.state == OK and fused:
            return self._track_fused(frame)
        return self._track_staged(frame)

    def _initialize(self, frame: FrameData):
        n_depth = int(torch.sum((frame.depth > 0) & frame.valid))
        if n_depth > 100:
            with self._span("insert_keyframe"):
                self.map, kf_id, kp_pt = self._stereo_init_impl(
                    self.map, frame, self.frame_id)
            frame = frame._replace(
                kp_pt=kp_pt, Tcw=self._eye(),
                pose_ok=torch.tensor(True, device=self.device))
            if self.objects is not None:
                with self._span("object_update"):
                    self.map, frame = self.objects.update(self.map, frame)
            self.state = OK
            self.last_kf_id = int(kf_id)
            self.frames_since_kf = 0
            self._kf_inliers = n_depth
            self._on_keyframe(self.last_kf_id)
            self._record(frame, True)
        else:
            self._record(frame, False)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _stereo_init_impl(self, m, frame, frame_id):
        create = frame.valid & (frame.depth > 0)
        m, kf_id = map_ops.insert_keyframe(
            self.K, m, frame, self._eye(), self.scale_factors, create,
            frame_id=frame_id)
        return m, kf_id, m.kf_kp_pt[kf_id]

    def _insert_impl(self, m, frame, Tcw, kp_pt, close_mask, frame_id):
        """CreateNewKeyFrame: spawn the close untracked points and top up
        with the nearest untracked points to >= 100."""
        frame = frame._replace(kp_pt=kp_pt)
        untracked = frame.valid & (frame.depth > 0) & (kp_pt < 0)
        depth_key = torch.where(untracked, -frame.depth,
                                torch.full_like(frame.depth, -math.inf))
        N = frame.depth.shape[0]
        _, nearest = topk(depth_key, min(100, N))
        topup = scatter_set(torch.zeros(N, dtype=torch.bool,
                                        device=self.device),
                            nearest, True) & untracked
        spawn = close_mask | topup
        return map_ops.insert_keyframe(self.K, m, frame, Tcw,
                                       self.scale_factors, spawn,
                                       frame_id=frame_id)

    def _fast_schedule(self, kf_gap: int) -> bool:
        """The abbreviated local-BA schedule when keyframes arrive within
        ba_abort_pressure_gap frames (the mbAbortBA analogue)."""
        gap_cfg = self.cfg.mapping.ba_abort_pressure_gap
        return gap_cfg > 0 and kf_gap < gap_cfg

    def _mapping_pass(self, m, kf_id, fast: bool):
        """The local-mapping pass on keyframe kf_id, on the full or the
        abbreviated BA schedule."""
        ba_iters = tuple(self.cfg.mapping.ba_abort_iters) if fast else None
        sf, isg = self._pass_tables[m.pt_xyz.device]
        return local_mapping.process_new_keyframe(
            self.K, m, kf_id, sf, isg, self.cfg, ba_iters=ba_iters)

    def _merge_mapping(self, where: str):
        """Fold a pending async pass into the live map."""
        if self._async is None or self._async.pending is None:
            return
        merged_kf = self._async.pending_kf
        with self._span("mapping_merge"):
            self.map = self._async.merge(self.map)
        self.mapping_stats[where + "_merges"] += 1
        self._on_keyframe(merged_kf)

    def _insert_and_map(self, frame, Tcw, kp_pt, spawn, frame_id, n_inl):
        """Insert a keyframe and run the local-mapping pass on it (inline,
        or dispatched to the async mapper after folding in the pass still
        in flight: the keyframe-rate barrier). Returns the frame with the
        keyframe's point bindings adopted."""
        self._merge_mapping("barrier")
        with self._span("insert_keyframe"):
            self.map, kf_id = self._insert_impl(self.map, frame, Tcw, kp_pt,
                                                spawn, frame_id)
        kf_id = int(kf_id)
        frame = frame._replace(kp_pt=self.map.kf_kp_pt[kf_id])
        kf_gap = self.frames_since_kf
        self.last_kf_id = kf_id
        self.frames_since_kf = 0
        self._kf_inliers = n_inl
        fast = self._fast_schedule(kf_gap)
        self.mapping_stats["passes"] += 1
        self.mapping_stats["abbreviated"] += int(fast)
        if self._async is not None:
            with self._span("mapping_dispatch"):
                self._async.dispatch(self.map, kf_id, fast)
        else:
            with self._span("local_mapping"):
                self.map = self._mapping_pass(self.map, kf_id, fast)
            self._on_keyframe(kf_id)
        return frame

    # ------------------------------------------------------------------
    # the staged path (Tracking::Track's stage sequence, host-gated)
    # ------------------------------------------------------------------
    def _kf_policy_impl(self, m, depth, kp_pt, valid, last_kf, min_obs):
        """The keyframe policy's three counts in one [3] int32 tensor."""
        cam = self.cfg.camera
        close = (depth > 0) & (depth < cam.th_depth * cam.baseline)
        tracked = kp_pt >= 0
        P = m.pt_xyz.shape[0]
        ref_pt = m.kf_kp_pt[last_kf]
        rpc = torch.clamp(ref_pt, 0, P - 1).long()
        return torch.stack([
            torch.sum(close & tracked & valid),
            torch.sum(close & ~tracked & valid),
            torch.sum((ref_pt >= 0) & (m.pt_n_obs[rpc] >= min_obs)
                      & m.pt_valid[rpc])]).to(torch.int32)

    def _counts(self, *xs):
        """Several device scalars read in one transfer."""
        return [int(v) for v in torch.stack(
            [torch.as_tensor(x, device=self.device).to(torch.int64)
             for x in xs]).cpu()]

    def _track_staged(self, frame: FrameData):
        cfg = self.cfg
        last = self.last_frame
        ref_id = max(self.last_kf_id, 0)
        with self._span("track_staged"):
            T_pred = self.velocity @ last.Tcw
            vo_mode = False
            with self.profiler.span("track.motion_model"):
                if not self.enable_mapping:
                    # localization mode: temporal VO points feed the
                    # motion model where the frozen map is sparse
                    # (Tracking.cc:384-514); mbVO = few matches to map
                    # points
                    tr, n_map = trk.track_motion_model_vo(
                        self.K, self.map, frame, last, T_pred,
                        self.scale_factors, self.inv_sigma2)
                    nm, ni, n_map = self._counts(tr.n_matches,
                                                 tr.n_inliers, n_map)
                    vo_mode = n_map < 10
                else:
                    def motion(radius):
                        tr = trk.track_motion_model(
                            self.K, self.map, frame, last.uv, last.kp_pt,
                            last.level, last.valid, T_pred,
                            self.scale_factors, self.inv_sigma2,
                            radius_th=radius, T_last=last.Tcw,
                            last_angle=last.angle)
                        return (tr,) + tuple(self._counts(tr.n_matches,
                                                          tr.n_inliers))

                    tr, nm, ni = motion(cfg.tracking.motion_model_radius)
                    if nm < 20:
                        # wide-window retry (Tracking.cc:967-975 doubles th)
                        tr, nm, ni = motion(
                            2.0 * cfg.tracking.motion_model_radius)
            tr_ni = ni
            if nm < 20 or ni < 10:
                # a thin motion-model consensus is refused before it is
                # trusted (Tracking.cc:977)
                tr_kf = trk.track_reference_kf(self.K, self.map, frame,
                                               ref_id, last.Tcw,
                                               self.inv_sigma2)
                kf_ni = int(tr_kf.n_inliers)
                if kf_ni > tr_ni:
                    tr, tr_ni = tr_kf, kf_ni
            if tr_ni < 10:
                tr = self._relocalize(frame)
                if tr is None:
                    self.state = LOST
                    lost = frame._replace(Tcw=last.Tcw)
                    self._record(lost, False)
                    self.last_frame = lost
                    self.frame_id += 1
                    return lost
                tr_ni = int(tr.n_inliers)

            # object association before the local map (Tracking.cc:453)
            if self.objects is not None:
                with self._span("object_assoc"):
                    frame = self.objects.associate(
                        self.map, frame._replace(Tcw=tr.Tcw), last)

            if vo_mode:
                # VO survival: the frozen map has no local coverage, so the
                # temporal-point pose is the result (Tracking.cc:445-450
                # skips TrackLocalMap when mbOnlyTracking && mbVO)
                return self._vo_result(frame, tr, tr_ni, last, T_pred)
            with self.profiler.span("track.local_map"):
                if self.objects is not None and bool(
                        torch.any(frame.obj3d >= 0)):
                    with self._span("semopt"):
                        tr2, self.map, n_sem, self._last_presem_Tcw = \
                            self.objects.track_local_map_semantic(
                                self.map, frame, tr)
                    n_inl, n_sem = self._counts(tr2.n_inliers, n_sem)
                    self.objects.semantic_constraints += n_sem
                else:
                    tr2, self.map, _ = self._local(frame, tr, last.Tcw)
                    n_inl = int(tr2.n_inliers)
            ok = n_inl >= 30 or (n_inl >= 10 and self.frame_id < 5)
            if not ok and tr_ni >= 10:
                # the reference-KF rung before declaring LOST
                # (Tracking.cc:364-379)
                tr_kf = trk.track_reference_kf(self.K, self.map, frame,
                                               ref_id, last.Tcw,
                                               self.inv_sigma2)
                if int(tr_kf.n_inliers) >= 10:
                    tr2_kf, map_kf, _ = self._local(frame, tr_kf, last.Tcw)
                    n_kf = int(tr2_kf.n_inliers)
                    if n_kf > n_inl:
                        tr, tr2, self.map, n_inl = tr_kf, tr2_kf, map_kf, n_kf
                        ok = n_inl >= 30 or (n_inl >= 10
                                             and self.frame_id < 5)
            self._last_n_inliers = n_inl
            self.state = OK if ok else LOST
            self.debug_last = {"tr_motion": tr, "tr_local": tr2,
                               "T_pred": T_pred, "frame": frame}
            frame = frame._replace(Tcw=tr2.Tcw, kp_pt=tr2.kp_pt,
                                   pose_ok=torch.tensor(ok,
                                                        device=self.device))
        # the map is frozen in localization mode: no object update, keyframe
        # or mapping merge
        if self.objects is not None and ok and self.enable_mapping:
            with self._span("object_update"):
                self.map, frame = self.objects.update(self.map, frame)
        if ok:
            self.velocity = tr2.Tcw @ se3.inverse(last.Tcw)
        if ok and self.enable_mapping:
            if self._async is not None and self._async.ready():
                # adopt a finished mapping pass as soon as it lands
                self._merge_mapping("ready")
            with self.profiler.span("track.kf_policy"):
                n_close_trk, n_close_untrk, ref_matches = self._counts(
                    *self._kf_policy_impl(
                        self.map, frame.depth, frame.kp_pt, frame.valid,
                        ref_id, 3 if int(self.map.n_kf) > 2 else 1))
            if trk.need_new_keyframe(
                    n_inl, ref_matches, n_close_trk, n_close_untrk,
                    self.frames_since_kf,
                    max_frames=cfg.tracking.max_frames_between_kf,
                    last_kf_inliers=self._kf_inliers,
                    min_gap=cfg.tracking.min_frames_between_kf):
                close = (frame.depth > 0) & (
                    frame.depth < cfg.camera.th_depth * cfg.camera.baseline)
                spawn = close & (frame.kp_pt < 0) & frame.valid
                frame = self._insert_and_map(frame, tr2.Tcw, tr2.kp_pt,
                                             spawn, self.frame_id, n_inl)
            else:
                self.frames_since_kf += 1
                self._kf_inliers = max(self._kf_inliers, n_inl)
        self._record(frame, ok)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _vo_result(self, frame, tr, n_inl, last, T_pred):
        """Localization mode's VO pose as the frame's result: tracked with
        >= 20 inliers, no local map, no keyframe."""
        ok = n_inl >= 20
        self._last_n_inliers = n_inl
        self.state = OK if ok else LOST
        self.debug_last = {"tr_motion": tr, "tr_local": tr,
                           "T_pred": T_pred, "frame": frame}
        frame = frame._replace(Tcw=tr.Tcw, kp_pt=tr.kp_pt,
                               pose_ok=torch.tensor(ok, device=self.device))
        if ok:
            self.velocity = tr.Tcw @ se3.inverse(last.Tcw)
        self._record(frame, ok)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _local(self, frame, tr, T_last):
        cfg = self.cfg
        return trk.track_local_map(
            self.K, self.map, frame, tr, self.scale_factors, self.inv_sigma2,
            self.log_scale, T_last=T_last,
            local_cap=cfg.caps.local_search_pts,
            radius_mult=cfg.tracking.local_radius_mult,
            level_window=cfg.tracking.local_level_window)

    # ------------------------------------------------------------------
    # relocalization (no vocabulary: the frame against the whole map)
    # ------------------------------------------------------------------
    def _minimal_sets(self, valid, n_trials: int = 256, k: int = 6):
        """[T, k] RANSAC index sets over the frame's keypoints, drawn from
        this system's generator."""
        return ransac.sample_minimal_sets(self.rng, valid.shape[0], valid,
                                          n_trials, k)

    def _relocalize(self, frame):
        """Relocalization (Tracking.cc:1606-1767). With loop closing on:
        the BoW candidates (KeyFrameDatabase.cc:199-310) in score order,
        one ``tracking.relocalize_try`` each, the first with >= 50 inliers
        accepted. Without: one brute match of the frame's descriptors
        against every valid map point, PnP RANSAC on the matches, accepted
        with >= 30 inliers and a finite, sane pose."""
        if self.loop_closer is not None:
            with self._span("relocalize"):
                return self._relocalize_bow(frame)
        m = self.map
        P = m.pt_xyz.shape[0]
        with self._span("relocalize"):
            midx, mok = matching.brute_match(
                frame.desc, frame.valid, m.pt_desc, m.pt_valid, th_dist=50,
                nn_ratio=0.75, check_rotation=False)
            if int(torch.sum(mok)) < 30:
                return None
            pw = m.pt_xyz[torch.clamp(midx, 0, P - 1).long()]
            res = pnp_ransac_sets(
                self._minimal_sets(mok), self.K, pw, frame.uv, mok,
                min_inliers=max(self.cfg.solver.epnp_min_inliers, 25))
            ok, n_inl, t_norm = torch.stack([
                res.ok.to(torch.float32), res.n_inliers.to(torch.float32),
                torch.linalg.norm(res.Tcw[:3, 3])]).cpu().tolist()
        # a relocalization is trusted only with a strong consensus and a
        # sane pose (Tracking.cc:1752-1764)
        if not ok or n_inl < 30 or not math.isfinite(t_norm) or t_norm > 1e3:
            return None
        self.n_relocalized += 1
        return trk.TrackResult(
            Tcw=res.Tcw, kp_pt=torch.where(res.inliers, midx,
                                           torch.full_like(midx, -1)),
            inlier=res.inliers, n_matches=torch.sum(mok.to(torch.int32)),
            n_inliers=res.n_inliers)

    def _relocalize_bow(self, frame):
        m = self.map
        _, bow = self.loop_closer.vocab.transform(frame.desc, frame.valid)
        cand, scores = kfdb.detect_reloc_candidates(m.kf_bow, m.kf_valid,
                                                    bow)
        cand_np = cand.cpu().numpy()
        if not cand_np.any():
            return None
        # every candidate gets its own attempt until one holds
        # (Tracking.cc:1640-1751); score order gives the early exit its
        # best shot (the reference's numpy argsort, on the same values)
        order = np.argsort(-scores.cpu().numpy() * cand_np)
        for kf in order[:int(cand_np.sum())]:
            if not cand_np[kf]:
                break
            tr = trk.relocalize_try(self.K, m, frame, int(kf),
                                    self._minimal_sets, self.inv_sigma2)
            if int(tr.n_inliers) >= 50:
                self.n_relocalized += 1
                return tr
        return None

    # ------------------------------------------------------------------
    # the fused path and its lagged readback
    # ------------------------------------------------------------------
    def _readback(self, packed):
        """Start the packed vector's device->host copy: a non-blocking copy
        into a fresh pinned buffer (one per frame in flight) and an event
        that marks its end. On the CPU the tensor is already on the host."""
        if self.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _track_fused(self, frame: FrameData):
        """The whole tracking chain in one call, its host bookkeeping for
        this frame deferred to the next call (pipelined readback) or done
        at once. In pipelined mode the returned frame's pose_ok is a device
        scalar and its bookkeeping is still pending."""
        cfg = self.cfg
        last = self.last_frame
        with self._span("track_fused"):
            self.map, tr2, obj3d, packed, vel, okd = self._fused_impl(
                self.map, frame, last, self.velocity,
                max(self.last_kf_id, 0), self.frames_since_kf, self.frame_id,
                self._kf_inliers)
        frame = frame._replace(Tcw=tr2.Tcw, kp_pt=tr2.kp_pt, pose_ok=okd,
                               obj3d=obj3d)
        self.debug_last = {"tr_motion": tr2, "tr_local": tr2,
                           "frame": frame}
        # velocity advances provisionally as a device output; a LOST or
        # relocalized outcome resets it during resolve
        self.velocity = vel
        prev = self._fused_pending
        # ref: the keyframe the device composed Tcr against; a keyframe
        # inserted by the previous frame's resolve must not change it
        self._fused_pending = {"packed": self._readback(packed),
                               "frame": frame, "ts": self._host_ts,
                               "fid": self.frame_id,
                               "ref": max(self.last_kf_id, 0)}
        self.last_frame = frame
        self.frame_id += 1
        # resolve the previous frame only after this frame's dispatch
        if prev is not None:
            self._resolve_one(prev, latest=False)
        if not cfg.tracking.pipelined_readback:
            self._resolve_fused_pending()
            return self.last_frame
        return frame

    def _fused_impl(self, m, frame, last, velocity, last_kf_id,
                    frames_since_kf, frame_id, last_kf_inliers):
        """tracking.track_frame_fused with this system's configuration and
        object hooks: (map, result, obj3d, packed, velocity, pose_ok)."""
        cfg = self.cfg
        return trk.track_frame_fused(
            self.K, m, frame, last, velocity, last_kf_id, frames_since_kf,
            frame_id, last_kf_inliers, self.scale_factors, self.inv_sigma2,
            self.log_scale,
            motion_radius=cfg.tracking.motion_model_radius,
            close_depth=cfg.camera.th_depth * cfg.camera.baseline,
            max_frames_between_kf=cfg.tracking.max_frames_between_kf,
            local_cap=cfg.caps.local_search_pts,
            local_radius_mult=cfg.tracking.local_radius_mult,
            local_level_window=cfg.tracking.local_level_window,
            motion_rot_check=cfg.tracking.motion_rot_check,
            obj_hooks=self._obj_hooks)

    def _resolve_fused_pending(self):
        """Consume the newest fused dispatch's lagged result (strict
        catch-up for the other paths, state queries and flushes)."""
        pend = self._fused_pending
        if pend is None:
            return
        self._fused_pending = None
        self._resolve_one(pend, latest=True)

    def _resolve_one(self, pend, latest: bool):
        """Host bookkeeping for one fused dispatch: trajectory record,
        state machine, keyframe insertion + the local-mapping pass,
        relocalization. latest=False: a newer frame is already in flight,
        so last_frame is not rolled back to this one."""
        cfg = self.cfg
        frame = pend["frame"]
        host, done = pend["packed"]
        with self._span("resolve"):
            if done is not None:
                done.synchronize()
            p = host.numpy()
        Tcw_np = p[trk.PACKED_TCW].reshape(4, 4).copy()
        ok = p[trk.PACKED_OK] > 0.5
        need_kf = self._need_keyframe(pend, p)
        n_inl = int(p[trk.PACKED_N_INLIERS])
        self._last_n_inliers = n_inl
        if self.objects is not None:
            # N_AllSemanticConstraintNum analogue, from the same readback
            self.objects.semantic_constraints += int(
                p[trk.PACKED_N_SEMANTIC])

        relocalized = False
        if not ok and n_inl < 10:
            tr_rel = self._relocalize(frame)
            if tr_rel is None:
                self.state = LOST
                self.velocity = self._eye()
                self._record_np(pend["ts"], Tcw_np, False)
                if latest:
                    self.last_frame = frame
                return
            frame = frame._replace(Tcw=tr_rel.Tcw, kp_pt=tr_rel.kp_pt)
            Tcw_np = tr_rel.Tcw.cpu().numpy()
            ok, need_kf, relocalized = True, False, True
            self.velocity = self._eye()
            n_inl = int(tr_rel.n_inliers)

        self.state = OK if ok else LOST
        if ok and need_kf:
            close = frame.valid & (frame.depth > 0) & (
                frame.depth < cfg.camera.th_depth * cfg.camera.baseline)
            spawn = close & (frame.kp_pt < 0)
            frame = self._insert_and_map(frame, frame.Tcw, frame.kp_pt,
                                         spawn, pend["fid"], n_inl)
            self._record_np(pend["ts"], Tcw_np, True)
        elif ok:
            self.frames_since_kf += 1
            # the decay trigger anchors to the peak inlier count since the
            # last insertion
            self._kf_inliers = max(self._kf_inliers, n_inl)
            if relocalized:
                # the packed Tcr belongs to the failed fused attempt
                self._record_np(pend["ts"], Tcw_np, True)
            else:
                self._record_precomputed(
                    pend["ts"], Tcw_np, p[trk.PACKED_TCR].reshape(4, 4).copy(),
                    True, ref_kf=pend["ref"])
        else:
            self._record_np(pend["ts"], Tcw_np, False)
        if latest:
            self.last_frame = frame

    def _need_keyframe(self, pend, p) -> bool:
        """The keyframe decision for the fused dispatch pend from its packed
        readback p: the hard trigger, or the soft one once
        min_frames_between_kf frames have passed (the min-gap gate applies
        here, where frames_since_kf is current)."""
        return bool(p[trk.PACKED_NEED_KF_HARD] > 0.5) or (
            bool(p[trk.PACKED_NEED_KF] > 0.5)
            and self.frames_since_kf
            >= self.cfg.tracking.min_frames_between_kf)

    def _record_precomputed(self, timestamp, Tcw_np, Tcr_np, tracked,
                            ref_kf):
        self.trajectory.append(FrameRecord(
            timestamp=float(timestamp), Tcw=Tcw_np, ref_kf=int(ref_kf),
            Tcr=Tcr_np, tracked=tracked))

    def _record_np(self, timestamp, Tcw_np, tracked):
        ref = max(self.last_kf_id, 0)
        Tkw = self.map.kf_pose[ref].cpu().numpy()
        self.trajectory.append(FrameRecord(
            timestamp=float(timestamp), Tcw=Tcw_np, ref_kf=ref,
            Tcr=Tcw_np @ np.linalg.inv(Tkw), tracked=tracked))

    def _record(self, frame, tracked: bool):
        ref = max(self.last_kf_id, 0)
        pair = torch.stack([frame.Tcw.to(torch.float32),
                            self.map.kf_pose[ref]]).cpu().numpy()
        Tcw, Tkw = pair[0], pair[1]
        self.trajectory.append(FrameRecord(
            timestamp=float(frame.timestamp), Tcw=Tcw, ref_kf=ref,
            Tcr=Tcw @ np.linalg.inv(Tkw), tracked=tracked))

    # ------------------------------------------------------------------
    # lifecycle (System.h:64-130)
    # ------------------------------------------------------------------
    def flush_mapping(self):
        """Fold the lagged readback and any async mapping pass in flight
        into the state (the Shutdown-time join analogue); without it the
        last frame's bookkeeping, a pending keyframe insertion and the last
        keyframe's mapping pass would be dropped."""
        self._resolve_fused_pending()
        self._merge_mapping("flush")

    def final_trajectory(self):
        """Recompose each frame pose from its reference KF's (BA-corrected)
        pose, hopping culled reference KFs through the frozen
        T_child_parent (System.cc:378-436)."""
        self.flush_mapping()
        kf_pose = self.map.kf_pose.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_parent = self.map.kf_parent.cpu().numpy()
        kf_tcp = self.map.kf_tcp.cpu().numpy()
        Kcap = kf_pose.shape[0]
        out = []
        for rec in self.trajectory:
            ref, Tcr = rec.ref_kf, rec.Tcr
            hops = 0
            while (0 <= ref < Kcap and not kf_valid[ref]
                   and kf_parent[ref] >= 0 and hops < Kcap):
                Tcr = Tcr @ kf_tcp[ref]
                ref = int(kf_parent[ref])
                hops += 1
            out.append((rec.timestamp, Tcr @ kf_pose[ref], rec.tracked))
        return out

    def activate_localization_mode(self):
        """Tracking only: no keyframe, point or object update from here on
        (System::ActivateLocalizationMode, System.cc:133-150). The lagged
        readback is resolved first, under the mode it was dispatched in."""
        self._resolve_fused_pending()
        self.enable_mapping = False

    def deactivate_localization_mode(self):
        self.enable_mapping = True

    def reset(self):
        """Clear map, trajectory and tracker state (System::Reset ->
        Tracking::Reset, Tracking.cc:1769-1815); a mapping pass in flight is
        joined and dropped. With loop closing on, the BoW rows and the
        closer's consistency groups clear too."""
        if self._async is not None:
            self._async.join()
        self.map = self._empty_map()
        if self.loop_closer is not None:
            self.loop_closer.consistent_groups = []
            self.loop_closer.last_loop_kf = -10
        if self.objects is not None:
            self.objects.semantic_constraints = 0
        self.state = NOT_INITIALIZED
        self.last_frame = None
        self.velocity = self._eye()
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.trajectory = []
        self._mono_ref = None
        self._fused_pending = None
        self.debug_last = None

    def get_tracking_state(self) -> int:
        """NOT_INITIALIZED=0 / OK=1 / LOST=2 (Tracking.h:99-105), after the
        lagged readback is folded in."""
        self._resolve_fused_pending()
        return self.state

    def shutdown(self, checkpoint_path: Optional[str] = None):
        """Flush the pending bookkeeping and the mapping pass in flight,
        write the map and the bookkeeping to checkpoint_path when given
        (slam/checkpoint.py::save_system), then stop the mapping thread (a
        later keyframe starts it again)."""
        self.flush_mapping()
        if checkpoint_path:
            checkpoint.save_system(checkpoint_path, self)
        if self._async is not None:
            self._async.close()

    @property
    def n_keyframes(self):
        self._resolve_fused_pending()
        return int(self.map.n_kf)

    @property
    def n_points(self):
        self._resolve_fused_pending()
        return int(torch.sum(self.map.pt_valid))
