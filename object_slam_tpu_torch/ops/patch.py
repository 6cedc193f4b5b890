"""Batched keypoint patch extraction: a CUDA kernel and its plain version.

Replaces the reference's only Pallas kernel,
object_slam_tpu/ops/patch_pallas.py::extract_patches, whose contract is
``extract_patches_xla`` there: for N window corners (ys, xs), clamped to
[0, H-32] x [0, W-32], return ``img[y:y+32, x:x+32]`` as [N, 32, 32] f32.

``extract_patches_levels`` takes the windows of every level of a pyramid
at once (a level slot per window) and launches one kernel for them all.

Both run the plain version only for tensors on the CPU. For CUDA tensors
they launch a kernel of csrc/patch_extract.cu or raise; there is no
fallback. ``extract_patches.launches`` counts the launches of both.
"""

from __future__ import annotations

import ctypes

import torch

from object_slam_tpu_torch.ops import build

PATCH = 32
MAX_LEVELS = 16     # the level table of extract_patches_levels
KERNEL = "patch_extract"


def extract_patches_ref(img, ys, xs):
    """Plain PyTorch version: one advanced-indexing gather."""
    H, W = img.shape
    y0 = torch.clamp(ys.long(), 0, H - PATCH)
    x0 = torch.clamp(xs.long(), 0, W - PATCH)
    d = torch.arange(PATCH, device=img.device)
    yy = y0[:, None, None] + d[None, :, None]
    xx = x0[:, None, None] + d[None, None, :]
    return img[yy, xx]


def extract_patches_levels_ref(levels, ys, xs, lvl):
    """Plain PyTorch version of extract_patches_levels: extract_patches_ref
    level by level, each window back in its place (zeros where lvl is not
    a level of the table)."""
    out = torch.zeros((ys.shape[0], PATCH, PATCH), dtype=torch.float32,
                      device=ys.device)
    for l, img in enumerate(levels):
        sel = torch.nonzero(lvl == l)[:, 0]
        if sel.numel():
            out[sel] = extract_patches_ref(img, ys[sel], xs[sel])
    return out


class _Levels(ctypes.Structure):
    """The level table (struct PatchLevels in the .cu source)."""
    _fields_ = [("img", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("n_levels", ctypes.c_int)]


def _lib():
    lib = build.load(KERNEL)
    fn = lib.patch_extract
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fl = lib.patch_extract_levels
    if fl.restype is not ctypes.c_int or not fl.argtypes:
        fl.argtypes = [ctypes.POINTER(_Levels)] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fl.restype = ctypes.c_int
    return lib


def extract_patches_cuda(img, ys, xs):
    """Launch the kernel. img [H, W] f32 contiguous CUDA (H, W >= 32);
    ys, xs [N] int32 contiguous on the same device."""
    if img.device.type != "cuda":
        raise ValueError("extract_patches_cuda needs a CUDA tensor")
    if img.dim() != 2 or img.dtype != torch.float32 or \
            not img.is_contiguous():
        raise ValueError("img must be a contiguous 2-D float32 tensor")
    H, W = img.shape
    if H < PATCH or W < PATCH:
        raise ValueError(f"img must be at least {PATCH}x{PATCH}")
    for name, t in (("ys", ys), ("xs", xs)):
        if t.device != img.device or t.dtype != torch.int32 or \
                t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"on {img.device}")
    if ys.shape != xs.shape:
        raise ValueError("ys and xs must have the same shape")
    n = ys.shape[0]
    out = torch.empty((n, PATCH, PATCH), dtype=torch.float32,
                      device=img.device)
    if n == 0:
        return out
    fn = _lib().patch_extract
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = fn(img.data_ptr(), H, W, ys.data_ptr(), xs.data_ptr(), n,
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"patch_extract launch failed: CUDA error {rc}")
    extract_patches.launches += 1
    return out


def extract_patches(img, ys, xs):
    """[N, 32, 32] windows img[y:y+32, x:x+32] at clamped corners: the
    plain version on the CPU, the kernel on the card."""
    if img.device.type == "cpu":
        return extract_patches_ref(img, ys, xs)
    return extract_patches_cuda(img, ys, xs)


def extract_patches_levels_cuda(levels, ys, xs, lvl):
    """Launch the level-table kernel once. levels: 1..MAX_LEVELS contiguous
    [H, W] f32 CUDA tensors (H, W >= 32); ys, xs, lvl [N] int32 contiguous
    on the same device (lvl outside [0, len(levels)) gives a zero
    window)."""
    if not levels or levels[0].device.type != "cuda":
        raise ValueError("extract_patches_levels_cuda needs CUDA tensors")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].get_device()
    p = _Levels()
    for l, img in enumerate(levels):
        if img.get_device() != dev or img.dtype is not torch.float32 or \
                img.dim() != 2 or not img.is_contiguous():
            raise ValueError(f"levels[{l}] must be a contiguous 2-D float32 "
                             f"tensor on {levels[0].device}")
        if img.shape[0] < PATCH or img.shape[1] < PATCH:
            raise ValueError(f"levels[{l}] must be at least {PATCH}x{PATCH}")
        p.img[l] = img.data_ptr()
        p.h[l], p.w[l] = img.shape
    p.n_levels = len(levels)
    n = ys.shape[0]
    for name, t in (("ys", ys), ("xs", xs), ("lvl", lvl)):
        if t.get_device() != dev or t.dtype is not torch.int32 or \
                t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] int32 "
                             f"tensor on {levels[0].device}")
    out = torch.empty((n, PATCH, PATCH), dtype=torch.float32,
                      device=levels[0].device)
    if n == 0:
        return out
    rc = _lib().patch_extract_levels(
        ctypes.byref(p), ys.data_ptr(), xs.data_ptr(), lvl.data_ptr(), n,
        out.data_ptr(), dev, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"patch_extract_levels launch failed: CUDA error "
                           f"{rc}")
    extract_patches.launches += 1
    return out


def extract_patches_levels(levels, ys, xs, lvl):
    """[N, 32, 32] windows levels[lvl[n]][y:y+32, x:x+32] at clamped
    corners: the plain version on the CPU, one kernel launch on the card."""
    if ys.device.type == "cpu":
        return extract_patches_levels_ref(levels, ys, xs, lvl)
    return extract_patches_levels_cuda(levels, ys, xs, lvl)


extract_patches.launches = 0
