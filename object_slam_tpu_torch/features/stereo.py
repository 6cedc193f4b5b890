"""RGB-D virtual right coordinate (Frame::ComputeStereoFromRGBD).

Counterpart of object_slam_tpu/features/stereo.py::rgbd_virtual_right.
Stereo L/R matching (``match_stereo``) is not in this slice; ROADMAP.md
queues it with the stereo/KITTI path.
"""

from __future__ import annotations

import torch


def rgbd_virtual_right(uv, depth, bf):
    """uv [N, 2] (undistorted), depth [N] -> (ur [N], valid_depth [N]);
    ur = -1 where the depth is invalid."""
    ok = depth > 0
    ur = torch.where(ok, uv[..., 0] - bf / torch.clamp(depth, min=1e-6),
                     torch.full_like(depth, -1.0))
    return ur, ok
