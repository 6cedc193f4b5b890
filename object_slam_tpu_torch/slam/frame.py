"""Per-frame front-end data: ORB extraction, undistortion, RGB-D depth,
and the frame's Object2D slab.

Counterpart of object_slam_tpu/slam/frame.py for RGB-D: frames with a
valid detection take ``_build_rgbd`` (masks travel bit-packed and unpack
on the device, then ``build_object2ds``), the others the object-free
``_build_rgbd_noobj``, as the reference dispatches. The single-blob
ingestion packs a frame's device-bound arrays into one uint8 blob on the
host (``pack_frame_blob``, the reference's byte layout), moves it with one
copy from pinned memory (``upload_blob``) and reinterprets its slices on
the device (``_unpack_blob``). ``build_stereo`` extracts both images,
matches them (``features/stereo.py::match_stereo``) and always builds the
Object2D slab, as the reference's stereo build does. ``build_mono``
extracts one image and carries no depth, no virtual right coordinate and
the empty detection slab (the reference's object pipeline needs depth,
System.cc:334-338).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from object_slam_tpu_torch.device import resolve_device
from object_slam_tpu_torch.features import stereo as stereo_mod
from object_slam_tpu_torch.features.extractor import Keypoints, OrbExtractor
from object_slam_tpu_torch.geometry import camera as cam_mod
from object_slam_tpu_torch.semantic import object2d as o2d_mod


class FrameData(NamedTuple):
    timestamp: torch.Tensor       # [] f32
    uv_raw: torch.Tensor          # [N, 2] distorted pixel coords
    uv: torch.Tensor              # [N, 2] undistorted
    ur: torch.Tensor              # [N] right-u (-1 mono)
    depth: torch.Tensor           # [N] (-1 invalid)
    level: torch.Tensor           # [N] int32
    angle: torch.Tensor           # [N]
    response: torch.Tensor        # [N]
    desc: torch.Tensor            # [N, 8] int32 (uint32 bits)
    valid: torch.Tensor           # [N] bool
    obj: o2d_mod.Object2DSlab     # per-frame detections
    obj3d: torch.Tensor           # [I] int32 matched map Object3D (-1)
    kp_pt: torch.Tensor           # [N] int32 matched map point (-1)
    Tcw: torch.Tensor             # [4, 4] pose (identity until tracked)
    pose_ok: torch.Tensor         # [] bool

    @property
    def n(self):
        return self.uv.shape[0]


_LUMA = (0.299, 0.587, 0.114)     # ITU-R BT.601, the cvtColor weights


def _reinterpret(u8, dtype):
    """A 1-D uint8 slice's bytes as ``dtype`` (the reference's
    bitcast_convert_type). ``view`` needs the slice to start on a multiple
    of the element size; a slice that does not is copied first."""
    size = torch.empty((), dtype=dtype).element_size()
    if u8.storage_offset() % size:
        u8 = u8.clone()
    return u8.view(dtype)


def _luma(rgb_f32):
    """BT.601 grayscale as elementwise ops (as the reference, not a
    matmul)."""
    return (_LUMA[0] * rgb_f32[..., 0] + _LUMA[1] * rgb_f32[..., 1]
            + _LUMA[2] * rgb_f32[..., 2])


class FrameBuilder:
    """ORB extraction + frame assembly for one camera geometry."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.K = cam_mod.Intrinsics.from_config(cfg.camera)
        self.extractor = OrbExtractor(cfg, device=self.device)
        self.inv_sigma2 = self.extractor.inv_level_sigma2()
        self.scale_factors = self.extractor.scale_factors()
        # every object-free frame carries the same empty detection slab
        self._empty_obj = o2d_mod.empty_slab(
            cfg.semantic.max_instances, cfg.camera.height, cfg.camera.width,
            cfg.caps.n_kp, device=self.device)

    def _tensor(self, x):
        if x is None:
            return None
        if isinstance(x, np.ndarray) and x.dtype == np.uint16:
            x = x.astype(np.int32)           # torch has no uint16 ops
        t = torch.as_tensor(x, device=self.device)
        return t

    def _image(self, x):
        t = self._tensor(x)
        return None if t is None else t.to(torch.float32)

    def _metric_depth(self, depth_img):
        """Raw u16 depth (TUM PNG encoding) scales by DepthMapFactor;
        float depth is already metric."""
        is_u16 = (isinstance(depth_img, np.ndarray)
                  and depth_img.dtype == np.uint16)
        t = self._tensor(depth_img)
        if is_u16 or t.dtype in (torch.int32, torch.uint16):
            return t.to(torch.float32) / float(
                np.float32(self.cfg.camera.depth_map_factor))
        return t.to(torch.float32)

    # ------------------------------------------------------------------
    def build_rgbd(self, gray, depth_img, rgb, sem_arrays, timestamp):
        """gray [H, W] (or None: luma from rgb); depth_img [H, W] metric
        (or raw u16); rgb [H, W, 3]; sem_arrays = (masks, labels, probs,
        bboxes, valid), the static [I] detection slab, masks as [I, H, W]
        bool or bit-packed [I, H, ceil(W/8)] uint8 (pack_sem_arrays).

        Frames with no valid detection take the object-free build, whether
        or not the system runs objects (the reference's host dispatch)."""
        if sem_arrays is None or not np.any(np.asarray(sem_arrays[4])):
            return self._build_rgbd_noobj(gray, depth_img, timestamp,
                                          rgb if gray is None else None)
        return self._build_rgbd(gray, depth_img, rgb,
                                *self.pack_sem_arrays(sem_arrays), timestamp)

    def pack_sem_arrays(self, sem_arrays):
        """Bit-pack the mask slab for transfer (idempotent)."""
        masks = sem_arrays[0]
        if getattr(masks, "dtype", None) in (np.dtype(np.uint8),
                                             torch.uint8):
            return tuple(sem_arrays)
        return (o2d_mod.pack_mask_bits(masks),) + tuple(sem_arrays[1:])

    # ------------------------------------------------------------------
    # single-transfer ingestion: every per-frame array in ONE uint8 blob
    # ------------------------------------------------------------------
    def pack_frame_blob(self, depth16, rgb8, sem_arrays):
        """Host: concatenate the frame's device-bound arrays (u16 depth, u8
        rgb, bit-packed masks, labels / probs / bboxes, little-endian) into
        one uint8 blob, byte for byte the reference's layout. Returns (blob
        u8[*], inst_valid host bool[I] or None); inst_valid stays on the
        host for the object-free dispatch."""
        parts = [np.ascontiguousarray(depth16, dtype='<u2').tobytes(),
                 np.ascontiguousarray(rgb8, dtype=np.uint8).tobytes()]
        if sem_arrays is None:
            return np.frombuffer(b"".join(parts), np.uint8), None
        masks, labels, probs, bboxes, valid = self.pack_sem_arrays(sem_arrays)
        parts += [np.ascontiguousarray(masks, dtype=np.uint8).tobytes(),
                  np.ascontiguousarray(labels, dtype='<i4').tobytes(),
                  np.ascontiguousarray(probs, dtype='<f4').tobytes(),
                  np.ascontiguousarray(bboxes, dtype='<f4').tobytes()]
        return np.frombuffer(b"".join(parts), np.uint8), np.asarray(valid)

    def blob_bytes(self, with_sem: bool) -> int:
        H, W = self.cfg.camera.height, self.cfg.camera.width
        I = self.cfg.semantic.max_instances
        n = H * W * 5
        return n + I * (H * ((W + 7) // 8) + 24) if with_sem else n

    def upload_blob(self, blob):
        """A host blob on the builder's device: one copy, from pinned memory
        and non-blocking on the card (the caching host allocator keeps the
        pinned block until the copy has run). A tensor already on the
        device passes through."""
        if torch.is_tensor(blob):
            return blob.to(self.device)
        blob = np.asarray(blob, dtype=np.uint8).reshape(-1)
        host = torch.empty(blob.shape, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host.numpy()[:] = blob
        return host.to(self.device, non_blocking=True)

    def build_rgbd_blob(self, blob, inst_valid, timestamp):
        """The single-transfer RGB-D build: the device-side unpack of
        pack_frame_blob's layout, then the standard builds, dispatched on
        the host's inst_valid as build_rgbd dispatches."""
        with_sem = inst_valid is not None and bool(np.any(inst_valid))
        size = blob.numel() if torch.is_tensor(blob) else np.asarray(blob).size
        if size != self.blob_bytes(inst_valid is not None):
            raise ValueError(f"blob of {size} bytes; this geometry packs "
                             f"{self.blob_bytes(inst_valid is not None)}")
        d16, rgb8, *sem = self._unpack_blob(self.upload_blob(blob), with_sem)
        if not with_sem:
            return self._build_rgbd_noobj(None, d16, timestamp, rgb8)
        return self._build_rgbd(None, d16, rgb8, *sem, inst_valid, timestamp)

    def _unpack_blob(self, blob, with_sem: bool):
        """Reinterpret the blob's slices: depth as raw u16 widened to int32
        (so _metric_depth scales it), rgb and masks as uint8, labels int32,
        probs and bboxes f32."""
        cfg = self.cfg
        H, W = cfg.camera.height, cfg.camera.width
        I = cfg.semantic.max_instances
        o0 = H * W * 2
        d16 = _reinterpret(blob[:o0], torch.int16).reshape(H, W) \
            .to(torch.int32) & 0xFFFF
        o1 = o0 + H * W * 3
        rgb8 = blob[o0:o1].reshape(H, W, 3)
        if not with_sem:
            return d16, rgb8
        o2 = o1 + I * H * ((W + 7) // 8)
        masks = blob[o1:o2].reshape(I, H, (W + 7) // 8)
        o3 = o2 + I * 4
        labels = _reinterpret(blob[o2:o3], torch.int32)
        o4 = o3 + I * 4
        probs = _reinterpret(blob[o3:o4], torch.float32)
        bboxes = _reinterpret(blob[o4:o4 + I * 16], torch.float32) \
            .reshape(I, 4)
        return d16, rgb8, masks, labels, probs, bboxes

    def _keypoints(self, gray, depth_img):
        """ORB keypoints, undistorted pixels and the RGB-D depth lookup."""
        kp = self.extractor(gray.contiguous())
        uv_und = cam_mod.undistort_points(self.K, kp.uv)
        h, w = gray.shape
        yy = torch.clamp(torch.round(kp.uv[:, 1]).long(), 0, h - 1)
        xx = torch.clamp(torch.round(kp.uv[:, 0]).long(), 0, w - 1)
        z = depth_img[yy, xx]
        ur, z_ok = stereo_mod.rgbd_virtual_right(uv_und, z, self.K.bf)
        depth = torch.where(z_ok & kp.valid, z, torch.full_like(z, -1.0))
        return kp, uv_und, ur, depth

    def _build_rgbd_noobj(self, gray, depth_img, timestamp,
                          rgb=None) -> FrameData:
        cfg = self.cfg
        gray = _luma(self._image(rgb)) if gray is None else self._image(gray)
        kp, uv_und, ur, depth = self._keypoints(
            gray, self._metric_depth(depth_img))
        return self._assemble(kp, uv_und, ur, depth, self._empty_obj,
                              timestamp)

    def _build_rgbd(self, gray, depth_img, rgb, masks_packed, labels, probs,
                    bboxes, inst_valid, timestamp) -> FrameData:
        cfg = self.cfg
        masks = o2d_mod.unpack_mask_bits(self._tensor(masks_packed),
                                         cfg.camera.width)
        rgb = self._image(rgb)
        gray = _luma(rgb) if gray is None else self._image(gray)
        kp, uv_und, ur, depth = self._keypoints(
            gray, self._metric_depth(depth_img))
        with torch.profiler.record_function("object2d"):
            obj = o2d_mod.build_object2ds(
                rgb, masks, self._tensor(labels), self._image(probs),
                self._image(bboxes), self._tensor(inst_valid).to(torch.bool),
                kp.uv, depth, kp.valid,
                th_depth=cfg.camera.th_depth * cfg.camera.baseline,
                min_kps=cfg.semantic.min_kps_rgbd,
                mask_margin=cfg.semantic.mask_margin)
        return self._assemble(kp, uv_und, ur, depth, obj, timestamp)

    # ------------------------------------------------------------------
    def build_stereo(self, gray_l, gray_r, rgb, sem_arrays, timestamp):
        """gray_l / gray_r [H, W] rectified pair (u8 or float); rgb
        [H, W, 3] or None (a grayscale rig: the histograms' input is the
        left image stacked three times, made on the device); sem_arrays
        the detection slab or None (no detections)."""
        if sem_arrays is None:
            sem_arrays = self.empty_semantics()
        return self._build_stereo(gray_l, gray_r, rgb,
                                  *self.pack_sem_arrays(sem_arrays),
                                  timestamp)

    def _build_stereo(self, gray_l, gray_r, rgb, masks_packed, labels, probs,
                      bboxes, inst_valid, timestamp) -> FrameData:
        cfg = self.cfg
        masks = o2d_mod.unpack_mask_bits(self._tensor(masks_packed),
                                         cfg.camera.width)
        gray_l = self._image(gray_l).contiguous()
        gray_r = self._image(gray_r).contiguous()
        rgb = (torch.stack([gray_l] * 3, -1) if rgb is None
               else self._image(rgb))
        kp_l, kp_r = self.extractor.extract_pair(gray_l, gray_r)
        uv_und = cam_mod.undistort_points(self.K, kp_l.uv)
        with torch.profiler.record_function("match_stereo"):
            ur, depth, ok = stereo_mod.match_stereo(
                kp_l.uv, kp_l.level, kp_l.desc, kp_l.valid,
                kp_r.uv, kp_r.level, kp_r.desc, kp_r.valid,
                gray_l, gray_r, self.scale_factors,
                float(self.K.bf), float(self.K.fx),
                min_z=cfg.camera.baseline)
        depth = torch.where(ok, depth, torch.full_like(depth, -1.0))
        with torch.profiler.record_function("object2d"):
            obj = o2d_mod.build_object2ds(
                rgb, masks, self._tensor(labels), self._image(probs),
                self._image(bboxes), self._tensor(inst_valid).to(torch.bool),
                kp_l.uv, depth, kp_l.valid,
                th_depth=cfg.camera.th_depth * cfg.camera.baseline,
                min_kps=cfg.semantic.min_kps_stereo,
                mask_margin=cfg.semantic.mask_margin)
        # the rectified stereo datasets have no distortion, so the raw ur
        # is kept (the reference's comment at frame.py:297-298)
        return self._assemble(kp_l, uv_und, ur, depth, obj, timestamp)

    def build_mono(self, gray, timestamp):
        """gray [H, W] (u8 or float, numpy or a tensor): one extraction;
        depth and ur are -1 everywhere and the detection slab is empty."""
        kp = self.extractor(self._image(gray).contiguous())
        uv_und = cam_mod.undistort_points(self.K, kp.uv)
        none = torch.full((kp.uv.shape[0],), -1.0, dtype=torch.float32,
                          device=self.device)
        return self._assemble(kp, uv_und, none, none.clone(),
                              self._empty_obj, timestamp)

    def _assemble(self, kp: Keypoints, uv_und, ur, depth, obj,
                  timestamp) -> FrameData:
        n = kp.uv.shape[0]
        dev = self.device
        return FrameData(
            timestamp=torch.tensor(float(np.float32(timestamp)),
                                   dtype=torch.float32, device=dev),
            uv_raw=kp.uv, uv=uv_und, ur=ur, depth=depth,
            level=kp.level, angle=kp.angle, response=kp.response,
            desc=kp.desc, valid=kp.valid, obj=obj,
            obj3d=torch.full((obj.label.shape[0],), -1, dtype=torch.int32,
                             device=dev),
            kp_pt=torch.full((n,), -1, dtype=torch.int32, device=dev),
            Tcw=torch.eye(4, dtype=torch.float32, device=dev),
            pose_ok=torch.tensor(False, device=dev))

    def empty_semantics(self):
        cfg = self.cfg
        I = cfg.semantic.max_instances
        H, W = cfg.camera.height, cfg.camera.width
        return (np.zeros((I, H, (W + 7) // 8), np.uint8),
                np.full((I,), -1, np.int32),
                np.zeros((I,), np.float32), np.zeros((I, 4), np.float32),
                np.zeros((I,), bool))
