"""HSV conversion + masked appearance histograms.

Counterpart of object_slam_tpu/semantic/hsv.py: per-instance histograms of
the H (30 bins, range 0..180), S (32, 0..256) and V (32, 0..256) channels
over the mask, concatenated and L1-normalized as one 94-vector; the
association scores are their cosine similarities. All instances of a frame
histogram in one f32 product of the masks with the bins' one-hot: the
counts are exact integers (below 2^24, TF32 off).

The reference runs compiled, and XLA rewrites its arithmetic: the division
by 255 becomes a product with f32(1/255), and each bin's chain of constant
scales folds into one product (H: 1/2 * 1/180 * 30 -> f32(1/12) on the
hue in degrees; S and V: 255 * 1/256 * 32 -> 31.875 on the [0, 1] value).
The port computes those same products, so every pixel lands in the same
bin and the histograms are equal. ``batched_histograms_hsv`` takes an HSV
image in OpenCV ranges, where the folds are 1/180 * 30 and 1/256 * 32.
"""

from __future__ import annotations

import numpy as np
import torch

H_BINS, S_BINS, V_BINS = 30, 32, 32
HIST_DIM = H_BINS + S_BINS + V_BINS     # 94

_F = np.float32
_INV255 = float(_F(1.0 / 255.0))
_H_DEG_SCALE = float(_F(_F(_F(0.5) * _F(1.0 / 180.0)) * _F(H_BINS)))
_SV_UNIT_SCALE = float(_F(_F(255.0) * _F(1.0 / 256.0)) * _F(S_BINS))
_H_CV_SCALE = float(_F(_F(1.0 / 180.0) * _F(H_BINS)))
_SV_CV_SCALE = float(_F(_F(1.0 / 256.0) * _F(S_BINS)))


def _mod(x, y: float):
    """jnp.mod for floats: fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def _hsv_unit(rgb):
    """RGB [..., 3] in [0, 255] -> (hue in degrees [0, 360), saturation
    and value in [0, 1])."""
    r, g, b = (rgb[..., 0] * _INV255, rgb[..., 1] * _INV255,
               rgb[..., 2] * _INV255)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c == 0, torch.ones_like(c), c)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = _mod(h * 60.0, 360.0)
    h = torch.where(c == 0, torch.zeros_like(h), h)
    s = torch.where(v == 0, torch.zeros_like(v),
                    c / torch.clamp(v, min=1e-9))
    return h, s, v


def rgb_to_hsv_cv(rgb):
    """RGB [..., 3] float in [0, 255] -> OpenCV-convention HSV:
    H in [0, 180), S in [0, 255], V in [0, 255]."""
    h, s, v = _hsv_unit(rgb)
    return torch.stack([h * 0.5, s * 255.0, v * 255.0], dim=-1)


def _onehot(h, s, v, h_scale: float, sv_scale: float):
    """Per-pixel bins (truncation, as the reference's int32 cast, then
    clipped) -> [H*W, 94] f32 one-hot."""
    def bins(x, scale, n):
        b = torch.clamp((x.reshape(-1) * scale).to(torch.int32), 0, n - 1)
        return b[:, None] == torch.arange(n, device=x.device)[None]
    return torch.cat([bins(h, h_scale, H_BINS), bins(s, sv_scale, S_BINS),
                      bins(v, sv_scale, V_BINS)], dim=-1).to(torch.float32)


def _bin_onehot(hsv_img):
    """[H, W, 3] (OpenCV ranges) -> [H*W, 94] f32 one-hot."""
    return _onehot(hsv_img[..., 0], hsv_img[..., 1], hsv_img[..., 2],
                   _H_CV_SCALE, _SV_CV_SCALE)


def _histograms(onehot, masks):
    I = masks.shape[0]
    hist = masks.reshape(I, -1).to(torch.float32) @ onehot
    return hist / torch.clamp(torch.sum(hist, dim=-1, keepdim=True),
                              min=1e-9)


def masked_hsv_histogram(hsv_img, mask):
    """hsv_img [H, W, 3] (OpenCV ranges), mask [H, W] bool -> [94]
    L1-normed."""
    return batched_histograms_hsv(hsv_img, mask[None])[0]


def batched_histograms_hsv(hsv_img, masks):
    """[H, W, 3] hsv (OpenCV ranges) + [I, H, W] bool masks -> [I, 94]."""
    return _histograms(_bin_onehot(hsv_img), masks)


def batched_histograms(rgb_img, masks):
    """rgb [H, W, 3], masks [I, H, W] bool -> [I, 94]."""
    h, s, v = _hsv_unit(rgb_img)
    return _histograms(_onehot(h, s, v, _H_DEG_SCALE, _SV_UNIT_SCALE),
                       masks)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def cosine_similarity(a, b):
    """a [..., D], b [..., D] -> cosine similarity (broadcast)."""
    num = torch.sum(a * b, dim=-1)
    den = _norm(a) * _norm(b)
    return num / torch.clamp(den, min=1e-12)
