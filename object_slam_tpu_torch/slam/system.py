"""System facade: the per-frame orchestration loop (RGB-D).

Counterpart of object_slam_tpu/slam/system.py's strict state machine:
``track_rgbd`` builds the frame; the first frame with enough depth
initializes the map (``_stereo_init_impl``, then the object update); every
later frame runs the fused tracking chain, with the object stages as its
hooks when objects are on, and is resolved at once (``_track_fused``
followed by ``_resolve_one``: the reference's ``pipelined_readback=False``
behaviour), inserting keyframes and running the local-mapping pass
synchronously.

Not in this slice, and raising ``NotImplementedError`` with the ROADMAP
item that ports them: loop closing, async mapping, stereo and mono
sensors, the staged (non-fused) path, the pipelined readback, the
single-blob entry and relocalization. Where the reference would
relocalize, the port records the frame LOST and counts it in
``n_reloc_skipped``.

State machine (Tracking.h:99-105): NOT_INITIALIZED -> OK <-> LOST.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from object_slam_tpu_torch.config import SlamConfig
from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.ops.scatter import scatter_set, topk
from object_slam_tpu_torch.slam import local_mapping, map_ops
from object_slam_tpu_torch.slam import tracking as trk
from object_slam_tpu_torch.slam.frame import FrameBuilder, FrameData
from object_slam_tpu_torch.slam.map_state import init_map
from object_slam_tpu_torch.slam.objects import ObjectEngine

NOT_INITIALIZED, OK, LOST = 0, 1, 2


def _not_in_slice(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


@dataclass
class FrameRecord:
    timestamp: float
    Tcw: np.ndarray            # [4, 4] absolute (at track time)
    ref_kf: int
    Tcr: np.ndarray            # pose relative to reference KF
    tracked: bool


class SlamSystem:
    def __init__(self, cfg: Optional[SlamConfig] = None,
                 enable_objects: bool = True,
                 enable_mapping: bool = True,
                 enable_loop: bool = False,
                 async_mapping: bool = False,
                 device=None, profile: bool = False):
        self.cfg = cfg or SlamConfig()
        cfg = self.cfg
        if enable_loop:
            raise _not_in_slice("enable_loop=True", "loop closing")
        if async_mapping:
            raise _not_in_slice("async_mapping=True",
                                "stereo/KITTI with async mapping")
        if not enable_mapping:
            raise _not_in_slice("localization mode (enable_mapping=False)",
                                "checkpoint, localization mode and reset")
        if cfg.sensor != "rgbd":
            raise _not_in_slice(f"sensor={cfg.sensor!r}",
                                "stereo/KITTI and mono")
        if not cfg.tracking.fused:
            raise _not_in_slice("tracking.fused=False (the staged path)",
                                "the staged tracking path")
        if cfg.tracking.pipelined_readback:
            raise _not_in_slice("tracking.pipelined_readback=True",
                                "the pipelined readback")
        self.device = resolve_device(device)
        self.builder = FrameBuilder(cfg, device=self.device)
        self.K = self.builder.K
        self.inv_sigma2 = self.builder.inv_sigma2
        self.scale_factors = self.builder.scale_factors
        self.log_scale = math.log(cfg.orb.scale_factor)
        self.map = init_map(cfg.caps, cfg.objects.history_capacity,
                            device=self.device)
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

        self.state = NOT_INITIALIZED
        self.last_frame: Optional[FrameData] = None
        self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_kf_id = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.trajectory: List[FrameRecord] = []
        self._kf_inliers = 0
        self._last_n_inliers = -1
        self._host_ts = 0.0
        # frames the reference would have handed to relocalization
        self.n_reloc_skipped = 0
        # per-stage host time (ms), synchronized per span when profiling
        self.profile = profile
        self.stage_ms: dict = {}

    @contextmanager
    def _span(self, name: str):
        """A torch.profiler range named ``name``; with ``profile`` also a
        synchronized host timing into ``stage_ms``."""
        with torch.profiler.record_function(name):
            if not self.profile:
                yield
                return
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

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
        return self._track(frame)

    def track_rgbd_blob(self, blob, inst_valid, timestamp=0.0):
        raise _not_in_slice("track_rgbd_blob", "the blob ingestion")

    # ------------------------------------------------------------------
    def _track(self, frame: FrameData):
        if self.state == OK:
            return self._track_fused(frame)
        if self.state == LOST:
            # the reference tracks a LOST frame through the staged path,
            # whose failure branch relocalizes (system.py:556-567)
            self.n_reloc_skipped += 1
            last = self.last_frame
            self._record(frame._replace(Tcw=last.Tcw), False)
            self.last_frame = frame._replace(Tcw=last.Tcw)
            self.frame_id += 1
            return self.last_frame
        n_depth = int(torch.sum((frame.depth > 0) & frame.valid))
        if n_depth > 100:
            with self._span("insert_keyframe"):
                self.map, kf_id, kp_pt = self._stereo_init_impl(
                    self.map, frame, self.frame_id)
            frame = frame._replace(
                kp_pt=kp_pt, Tcw=torch.eye(4, device=self.device),
                pose_ok=torch.tensor(True, device=self.device))
            if self.objects is not None:
                with self._span("object_update"):
                    self.map, frame = self.objects.update(self.map, frame)
            self.state = OK
            self.last_kf_id = int(kf_id)
            self.frames_since_kf = 0
            self._kf_inliers = n_depth
            self._record(frame, True)
        else:
            self._record(frame, False)
        self.last_frame = frame
        self.frame_id += 1
        return frame

    def _stereo_init_impl(self, m, frame, frame_id):
        create = frame.valid & (frame.depth > 0)
        m, kf_id = map_ops.insert_keyframe(
            self.K, m, frame, torch.eye(4, device=self.device),
            self.scale_factors, create, frame_id=frame_id)
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

    def _mapping_fn(self, kf_gap: int):
        """The full local-mapping pass, or the abbreviated local-BA
        schedule when keyframes arrive within ba_abort_pressure_gap frames
        (the mbAbortBA analogue)."""
        gap_cfg = self.cfg.mapping.ba_abort_pressure_gap
        ba_iters = None
        if gap_cfg > 0 and kf_gap < gap_cfg:
            ba_iters = tuple(self.cfg.mapping.ba_abort_iters)

        def run(m, kf_id):
            return local_mapping.process_new_keyframe(
                self.K, m, kf_id, self.scale_factors, self.inv_sigma2,
                self.cfg, ba_iters=ba_iters)
        return run

    # ------------------------------------------------------------------
    def _track_fused(self, frame: FrameData):
        cfg = self.cfg
        last = self.last_frame
        with self._span("track_fused"):
            self.map, tr2, obj3d, packed, vel, okd = trk.track_frame_fused(
                self.K, self.map, frame, last, self.velocity,
                max(self.last_kf_id, 0), self.frames_since_kf, self.frame_id,
                self._kf_inliers, self.scale_factors, self.inv_sigma2,
                self.log_scale,
                motion_radius=cfg.tracking.motion_model_radius,
                close_depth=cfg.camera.th_depth * cfg.camera.baseline,
                max_frames_between_kf=cfg.tracking.max_frames_between_kf,
                local_cap=cfg.caps.local_search_pts,
                local_radius_mult=cfg.tracking.local_radius_mult,
                local_level_window=cfg.tracking.local_level_window,
                motion_rot_check=cfg.tracking.motion_rot_check,
                obj_hooks=self._obj_hooks)
        frame = frame._replace(Tcw=tr2.Tcw, kp_pt=tr2.kp_pt, pose_ok=okd,
                               obj3d=obj3d)
        self.velocity = vel
        pend = {"packed": packed, "frame": frame, "ts": self._host_ts,
                "fid": self.frame_id, "ref": max(self.last_kf_id, 0)}
        self.last_frame = frame
        self.frame_id += 1
        self._resolve_one(pend)
        return self.last_frame

    def _resolve_one(self, pend):
        """Host bookkeeping for one fused step: trajectory record, state
        machine, keyframe insertion + the local-mapping pass."""
        cfg = self.cfg
        frame = pend["frame"]
        p = pend["packed"].cpu().numpy()
        Tcw_np = p[0:16].reshape(4, 4)
        ok = p[48] > 0.5
        need_soft = p[49] > 0.5
        need_hard = p[57] > 0.5
        need_kf = bool(need_hard) or (
            bool(need_soft)
            and self.frames_since_kf >= cfg.tracking.min_frames_between_kf)
        n_inl = int(p[50])
        self._last_n_inliers = n_inl
        if self.objects is not None:
            # N_AllSemanticConstraintNum analogue, from the same readback
            self.objects.semantic_constraints += int(p[56])

        if not ok and n_inl < 10:
            self.n_reloc_skipped += 1
            self.state = LOST
            self.velocity = torch.eye(4, dtype=torch.float32,
                                      device=self.device)
            self._record_np(pend["ts"], Tcw_np, False)
            self.last_frame = frame
            return

        self.state = OK if ok else LOST
        if ok and need_kf:
            close = frame.valid & (frame.depth > 0) & (
                frame.depth < cfg.camera.th_depth * cfg.camera.baseline)
            spawn = close & (frame.kp_pt < 0)
            with self._span("insert_keyframe"):
                self.map, kf_id = self._insert_impl(
                    self.map, frame, frame.Tcw, frame.kp_pt, spawn,
                    pend["fid"])
            frame = frame._replace(kp_pt=self.map.kf_kp_pt[kf_id])
            kf_gap = self.frames_since_kf
            self.last_kf_id = int(kf_id)
            self.frames_since_kf = 0
            self._kf_inliers = n_inl
            with self._span("local_mapping"):
                self.map = self._mapping_fn(kf_gap)(self.map, int(kf_id))
            self._record_np(pend["ts"], Tcw_np, True)
        elif ok:
            self.frames_since_kf += 1
            self._kf_inliers = max(self._kf_inliers, n_inl)
            self._record_precomputed(pend["ts"], Tcw_np,
                                     p[32:48].reshape(4, 4), True,
                                     ref_kf=pend["ref"])
        else:
            self._record_np(pend["ts"], Tcw_np, False)
        self.last_frame = frame

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
    def final_trajectory(self):
        """Recompose each frame pose from its reference KF's (BA-corrected)
        pose, hopping culled reference KFs through the frozen
        T_child_parent (System.cc:378-436)."""
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

    @property
    def n_keyframes(self):
        return int(self.map.n_kf)

    @property
    def n_points(self):
        return int(torch.sum(self.map.pt_valid))
