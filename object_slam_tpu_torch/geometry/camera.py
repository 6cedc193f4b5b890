"""Pinhole camera model: projection, unprojection, undistortion, frustum test.

Counterpart of object_slam_tpu/geometry/camera.py. The intrinsics are
Python floats rounded to float32 (the reference holds f32 scalars), so
every product with a float32 tensor sees the same constants.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float                                   # baseline * fx (0 for mono)
    dist: Tuple[float, float, float, float, float]   # k1 k2 p1 p2 k3
    width: float
    height: float

    @staticmethod
    def from_config(cam) -> "Intrinsics":
        return Intrinsics(
            fx=_f32(cam.fx), fy=_f32(cam.fy), cx=_f32(cam.cx),
            cy=_f32(cam.cy), bf=_f32(cam.bf),
            dist=tuple(_f32(d) for d in cam.dist),
            width=_f32(cam.width), height=_f32(cam.height))

    def matrix(self, device=None):
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)


def project(K: Intrinsics, pc):
    """Camera-frame points [..., 3] -> pixel (u, v) [..., 2]."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K.fx * pc[..., 0] / z + K.cx
    v = K.fy * pc[..., 1] / z + K.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(K: Intrinsics, pc):
    """[..., 3] -> (u, v, u_right) [..., 3] with u_r = u - bf/z."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = K.fx * pc[..., 0] / z + K.cx
    v = K.fy * pc[..., 1] / z + K.cy
    ur = u - K.bf / z
    return torch.stack([u, v, ur], dim=-1)


def backproject(K: Intrinsics, uv, z):
    """Pixels [..., 2] + depth [...] -> camera-frame [..., 3]."""
    x = (uv[..., 0] - K.cx) * z / K.fx
    y = (uv[..., 1] - K.cy) * z / K.fy
    return torch.stack([x, y, z], dim=-1)


def distort_normalized(dist, xn):
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


# Shared fixed-point iteration count for inverting the radial-tangential
# model; datasets/synthetic.py uses the same constant.
UNDISTORT_ITERS = 8


def undistort_points(K: Intrinsics, uv, iters: int = UNDISTORT_ITERS):
    """Iterative (fixed-point) undistortion: [..., 2] distorted pixels ->
    [..., 2] undistorted pixels."""
    xn_d = torch.stack([(uv[..., 0] - K.cx) / K.fx,
                        (uv[..., 1] - K.cy) / K.fy], dim=-1)
    xn = xn_d
    for _ in range(iters):
        d = distort_normalized(K.dist, xn)
        xn = xn - (d - xn_d)
    return torch.stack([xn[..., 0] * K.fx + K.cx,
                        xn[..., 1] * K.fy + K.cy], dim=-1)


def in_image(K: Intrinsics, uv, margin=0.0):
    return ((uv[..., 0] >= margin) & (uv[..., 0] < K.width - margin) &
            (uv[..., 1] >= margin) & (uv[..., 1] < K.height - margin))


def frustum_check(K: Intrinsics, Tcw, pw, normal, min_dist, max_dist,
                  view_cos_limit: float = 0.5):
    """Vectorized Frame::isInFrustum. Returns (visible [N], uv [N, 2],
    z [N], dist [N], view_cos [N])."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pw @ R.T + t
    z = pc[..., 2]
    uv = project(K, pc)
    cam_center = -R.T @ t
    po = pw - cam_center
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-6)
    ok = ((z > 0.0) & in_image(K, uv)
          & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos > view_cos_limit))
    return ok, uv, z, dist, view_cos


def predict_scale_level(dist, max_dist, log_scale_factor, n_levels):
    """MapPoint::PredictScale — octave from distance ratio."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    level = torch.ceil(torch.log(ratio) / log_scale_factor).to(torch.int32)
    return torch.clamp(level, 0, n_levels - 1)
