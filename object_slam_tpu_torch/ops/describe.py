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
MAX_LEVELS = 8      # the kernel's level table
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
            [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, dim, device):
    if t.device != device or t.dtype != dtype or t.dim() != dim or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} "
                         f"tensor on {device}")


def orb_describe_cuda(levels, cy, cx, lvl, idx1, idx2, radius: int = 15,
                      tau: float = 0.02):
    """Launch the kernel once for all levels. levels: 1..8 contiguous
    [H, W] f32 CUDA tensors (H, W >= 32); cy, cx, lvl [N] int32 (lvl in
    [0, len(levels))); idx1, idx2 [64, 256] int16, all on one device."""
    if not levels or levels[0].device.type != "cuda":
        raise ValueError("orb_describe_cuda needs CUDA tensors")
    dev = levels[0].device
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(levels)}")
    for l, img in enumerate(levels):
        _check(f"levels[{l}]", img, torch.float32, 2, dev)
        if img.shape[0] < PATCH or img.shape[1] < PATCH:
            raise ValueError(f"levels[{l}] must be at least {PATCH}x{PATCH}")
    for name, t in (("cy", cy), ("cx", cx), ("lvl", lvl)):
        _check(name, t, torch.int32, 1, dev)
    if not cy.shape == cx.shape == lvl.shape:
        raise ValueError("cy, cx and lvl must have the same shape")
    for name, t in (("idx1", idx1), ("idx2", idx2)):
        _check(name, t, torch.int16, 2, dev)
        if tuple(t.shape) != (N_ANGLE_BINS, 256):
            raise ValueError(f"{name} must be [{N_ANGLE_BINS}, 256]")
    n = cy.shape[0]
    angle = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return angle, desc
    p = _Params()
    for l, img in enumerate(levels):
        p.img[l] = img.data_ptr()
        p.h[l], p.w[l] = img.shape
    p.n_levels = len(levels)
    p.blur[:] = _BLUR
    p.radius = radius
    p.tau = tau
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ctypes.byref(p), cy.data_ptr(), cx.data_ptr(), lvl.data_ptr(),
                n, idx1.data_ptr(), idx2.data_ptr(), angle.data_ptr(),
                desc.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"orb_describe launch failed: CUDA error {rc}")
    orb_describe.launches += 1
    return angle, desc


def orb_describe(levels, cy, cx, lvl, idx1, idx2, radius: int = 15,
                 tau: float = 0.02):
    """(angle [N] f32, desc [N, 8] int32) for keypoints over a pyramid:
    the plain version on the CPU, one kernel launch on the card."""
    if cy.device.type == "cpu":
        return orb_describe_ref(levels, cy, cx, lvl, idx1, idx2, radius, tau)
    return orb_describe_cuda(levels, cy, cx, lvl, idx1, idx2, radius, tau)


orb_describe.launches = 0
