"""ORB describe for a whole frame: a CUDA kernel and its plain version.

For N keypoints over the levels of one pyramid, compute each keypoint's
intensity-centroid angle and its 256-bit steered-BRIEF descriptor: what
the reference computes per level from two calls of its Pallas kernel
(object_slam_tpu/ops/patch_pallas.py::extract_patches), on the raw level
for the angle and on the Gaussian-blurred level for BRIEF.

    angle [N] f32  = _ic_angle_from_patches(extract_patches(level, cy, cx))
    desc [N, 8] i32 = _brief_from_patches(
        extract_patches(gaussian_blur(level), cy, cx), angle, idx1, idx2)

with ``level = levels[lvl[k]]`` and the corners (cy, cx) clamped inside
the level as ``extract_patches`` clamps them. The kernel
(csrc/orb_describe.cu) does all levels in one launch and keeps patches
and blurred pixels in shared memory.

``orb_describe`` runs the plain version only for tensors on the CPU. For
CUDA tensors it launches the kernel or raises; there is no fallback.
``OrbDescribe`` is the launch an extractor keeps for its level geometry
(up to MAX_LEVELS levels: a stereo pair's two pyramids in one launch): it
checks the fixed parts once and, per call, what changes.
``orb_describe.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from object_slam_tpu_torch.features import pyramid as pyr_mod
from object_slam_tpu_torch.ops import build
from object_slam_tpu_torch.ops.patch import extract_patches_ref

PATCH = 32          # patch window size; keypoint sits at (HALF, HALF)
HALF = 15
N_ANGLE_BINS = 64   # steered-BRIEF rotation quantization (5.6 deg)
MAX_LEVELS = 16     # the kernel's level table (a stereo pair's pyramids)
KERNEL = "orb_describe"
_BLUR = [float(w) for w in pyr_mod.blur_weights()]   # gaussian_blur's taps


def _ic_moments(patches, radius: int = 15):
    """m10, m01 and radius * mass of [N, PATCH, PATCH] windows under the
    circular mask, keypoint at (HALF, HALF)."""
    d = torch.arange(PATCH, dtype=patches.dtype, device=patches.device) - HALF
    dy = d[:, None]
    dx = d[None, :]
    circ = (dy * dy + dx * dx) <= radius * radius
    pm = patches * circ[None]
    m10 = torch.sum(pm * dx[None], dim=(1, 2))
    m01 = torch.sum(pm * dy[None], dim=(1, 2))
    mass = torch.sum(torch.abs(pm), dim=(1, 2)) * radius
    return m10, m01, mass


def _ic_angle_from_patches(patches, radius: int = 15,
                           stability_tau: float = 0.02):
    """Intensity-centroid orientation of [N, PATCH, PATCH] windows with the
    keypoint at (HALF, HALF); near-symmetric patches fall back to 0."""
    m10, m01, mass = _ic_moments(patches, radius)
    mag = torch.sqrt(m10 * m10 + m01 * m01)
    ang = torch.atan2(m01, m10)
    return torch.where(mag > stability_tau * mass, ang, torch.zeros_like(ang))


def pack_bits(bits):
    """[n, 256] bool -> [n, 8] int32 words (bit k of word w = bit 32w+k)."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(bits.reshape(n, 8, 32).long() << shifts, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def _brief_from_patches(patches, angles, idx1, idx2,
                        n_bins: int = N_ANGLE_BINS):
    """patches [N, PATCH, PATCH] (blurred), angles [N] -> [N, 8] int32.

    The reference rounds the patches to bf16 and evaluates every bit of
    every rotation bin as one matmul with D, then selects each keypoint's
    bin. D's column holds one -1 and one +1, so that product is exactly
    p2 - p1 of the bf16-rounded samples (exact in f32); this gathers the
    two samples of the keypoint's own bin instead, with the same bits."""
    n = patches.shape[0]
    flat = patches.reshape(n, PATCH * PATCH).to(torch.bfloat16) \
        .to(torch.float32)
    bin_idx = torch.remainder(
        torch.round(angles / (2.0 * math.pi) * n_bins).to(torch.int64),
        n_bins)
    p1 = torch.gather(flat, 1, idx1[bin_idx].long())
    p2 = torch.gather(flat, 1, idx2[bin_idx].long())
    return pack_bits((p2 - p1) > 0)


def orb_describe_ref(levels, cy, cx, lvl, idx1, idx2, radius: int = 15,
                     tau: float = 0.02):
    """Plain PyTorch version: per level, the blur, two patch gathers, the
    IC angle and steered BRIEF, as the reference runs them."""
    n = cy.shape[0]
    dev = cy.device
    angle = torch.zeros(n, dtype=torch.float32, device=dev)
    desc = torch.zeros((n, 8), dtype=torch.int32, device=dev)
    for l, img in enumerate(levels):
        sel = torch.nonzero(lvl == l)[:, 0]
        if sel.numel() == 0:
            continue
        ys, xs = cy[sel], cx[sel]
        p_raw = extract_patches_ref(img, ys, xs)
        p_blur = extract_patches_ref(pyr_mod.gaussian_blur(img), ys, xs)
        ang = _ic_angle_from_patches(p_raw, radius, tau)
        angle[sel] = ang
        desc[sel] = _brief_from_patches(p_blur, ang, idx1, idx2)
    return angle, desc


def near_gate(levels, cy, cx, lvl, radius: int = 15, tau: float = 0.02,
              rel: float = 1e-4):
    """[N] bool: keypoints whose stability margin |mag - tau * mass| in
    the plain version is below rel * tau * mass. Summing the moments in
    another order may flip the gate there, so a comparison of the kernel
    with the plain version counts these apart."""
    out = torch.zeros(cy.shape[0], dtype=torch.bool, device=cy.device)
    for l, img in enumerate(levels):
        sel = torch.nonzero(lvl == l)[:, 0]
        m10, m01, mass = _ic_moments(
            extract_patches_ref(img, cy[sel], cx[sel]), radius)
        mag = torch.sqrt(m10 * m10 + m01 * m01)
        out[sel] = (mag - tau * mass).abs() < rel * tau * mass
    return out


class _Params(ctypes.Structure):
    """The kernel's by-value parameter block (struct OrbParams in the .cu
    source): the level table, the blur taps and the IC-angle settings."""
    _fields_ = [("img", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("n_levels", ctypes.c_int),
                ("blur", ctypes.c_float * 7),
                ("radius", ctypes.c_int),
                ("tau", ctypes.c_float)]


def _lib():
    lib = build.load(KERNEL)
    fn = lib.orb_describe
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.POINTER(_Params)] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, dim, device):
    if t.device != device or t.dtype != dtype or t.dim() != dim or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} "
                         f"tensor on {device}")


class OrbDescribe:
    """One launch of the kernel per call for a fixed level geometry: the
    shapes of up to MAX_LEVELS contiguous f32 level images on one CUDA
    device (a stereo pair's two pyramids side by side), the BRIEF tables
    and the IC-angle settings, checked once here. A call checks what
    changes between calls (each level's and each keypoint array's device,
    dtype, contiguity and shape) and rewrites only the level pointers of
    the parameter block it keeps."""

    def __init__(self, shapes, device, idx1, idx2, radius: int = 15,
                 tau: float = 0.02):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("OrbDescribe needs a CUDA device")
        shapes = [tuple(int(x) for x in hw) for hw in shapes]
        if any(len(hw) != 2 for hw in shapes):
            raise ValueError("every level must be a 2-D image")
        if not 1 <= len(shapes) <= MAX_LEVELS:
            raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(shapes)}")
        for l, (h, w) in enumerate(shapes):
            if h < PATCH or w < PATCH:
                raise ValueError(f"levels[{l}] must be at least "
                                 f"{PATCH}x{PATCH}")
        for name, t in (("idx1", idx1), ("idx2", idx2)):
            if t.device.type != "cuda":
                raise ValueError(f"{name} must be on {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        for name, t in (("idx1", idx1), ("idx2", idx2)):
            _check(name, t, torch.int16, 2, device)
            if tuple(t.shape) != (N_ANGLE_BINS, 256) or t.data_ptr() % 16:
                raise ValueError(f"{name} must be [{N_ANGLE_BINS}, 256], "
                                 f"16-byte aligned")
        self.shapes = shapes
        self.device = device
        self._dev = device.index
        self._idx = (idx1, idx2, idx1.data_ptr(), idx2.data_ptr())
        p = _Params()
        for l, (h, w) in enumerate(shapes):
            p.h[l], p.w[l] = h, w
        p.n_levels = len(shapes)
        p.blur[:] = _BLUR
        p.radius = radius
        p.tau = tau
        self._p = p
        self._pref = ctypes.byref(p)
        self._fn = None
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, levels, cy, cx, lvl):
        """(angle [N] f32, desc [N, 8] int32) for corners cy, cx and level
        slots lvl ([N] int32, contiguous, on the device) over `levels`."""
        dev = self._dev
        if len(levels) != len(self.shapes):
            raise ValueError(f"{len(self.shapes)} levels expected, got "
                             f"{len(levels)}")
        img = self._p.img
        for l, (t, hw) in enumerate(zip(levels, self.shapes)):
            if t.get_device() != dev or t.dtype is not torch.float32 or \
                    t.shape != hw or not t.is_contiguous():
                raise ValueError(f"levels[{l}] must be a contiguous "
                                 f"{hw[0]}x{hw[1]} float32 tensor on "
                                 f"{self.device}")
            img[l] = t.data_ptr()
        n = cy.shape[0] if cy.dim() == 1 else -1
        for name, t in (("cy", cy), ("cx", cx), ("lvl", lvl)):
            if t.get_device() != dev or t.dtype is not torch.int32 or \
                    t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous [{n}] int32 "
                                 f"tensor on {self.device}")
        out = torch.empty(9 * n, dtype=torch.int32, device=self.device)
        angle = out[:n].view(torch.float32)
        desc = out[n:].view(n, 8)
        if n == 0:
            return angle, desc
        if self._fn is None:
            self._fn = _lib()
        rc = self._fn(self._pref, cy.data_ptr(), cx.data_ptr(),
                      lvl.data_ptr(), n, self._idx[2], self._idx[3],
                      angle.data_ptr(), desc.data_ptr(), dev,
                      self._stream(dev))
        if rc != 0:
            raise RuntimeError(f"orb_describe launch failed: CUDA error {rc}")
        orb_describe.launches += 1
        return angle, desc


def orb_describe_cuda(levels, cy, cx, lvl, idx1, idx2, radius: int = 15,
                      tau: float = 0.02):
    """Launch the kernel once for all levels. levels: 1..MAX_LEVELS
    contiguous [H, W] f32 CUDA tensors (H, W >= 32); cy, cx, lvl [N] int32
    (lvl in [0, len(levels)); a slot outside gives a NaN angle and a zero
    descriptor); idx1, idx2 [64, 256] int16, all on one device."""
    if not levels or levels[0].device.type != "cuda":
        raise ValueError("orb_describe_cuda needs CUDA tensors")
    call = OrbDescribe([tuple(t.shape) for t in levels], levels[0].device,
                       idx1, idx2, radius, tau)
    return call(levels, cy, cx, lvl)


def orb_describe(levels, cy, cx, lvl, idx1, idx2, radius: int = 15,
                 tau: float = 0.02):
    """(angle [N] f32, desc [N, 8] int32) for keypoints over a pyramid:
    the plain version on the CPU, one kernel launch on the card."""
    if cy.device.type == "cpu":
        return orb_describe_ref(levels, cy, cx, lvl, idx1, idx2, radius, tau)
    return orb_describe_cuda(levels, cy, cx, lvl, idx1, idx2, radius, tau)


orb_describe.launches = 0
