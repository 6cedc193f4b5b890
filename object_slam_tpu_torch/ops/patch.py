"""Batched keypoint patch extraction: a CUDA kernel and its plain version.

Replaces the reference's only Pallas kernel,
object_slam_tpu/ops/patch_pallas.py::extract_patches, whose contract is
``extract_patches_xla`` there: for N window corners (ys, xs), clamped to
[0, H-32] x [0, W-32], return ``img[y:y+32, x:x+32]`` as [N, 32, 32] f32.

``extract_patches`` runs the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel (csrc/patch_extract.cu) or
raises; there is no fallback. ``extract_patches.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from object_slam_tpu_torch.ops import build

PATCH = 32
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


def _lib():
    lib = build.load(KERNEL)
    fn = lib.patch_extract
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    fn = _lib()
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


extract_patches.launches = 0
