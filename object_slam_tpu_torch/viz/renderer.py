"""Offline visualization: frame overlays and 3D map renders.

Counterpart of object_slam_tpu/viz/renderer.py, after the reference's
viewer side-car (``FrameDrawer.cc:38-233``: keypoint/match overlay, object
masks + boxes; ``MapDrawer.cc:44-356``: map points, keyframes,
covisibility graph, object point clouds + AABB wireframes). Rendering is
offline, PNG frames (datasets/png.py's writer) and a matplotlib 3D plot,
because visualization is not on the metric path.
"""

from __future__ import annotations

import numpy as np
import torch

from object_slam_tpu_torch.datasets.png import write_png
from object_slam_tpu_torch.slam.map_state import MapState, covisibility

_COLORS = np.array([
    [230, 80, 80], [80, 200, 90], [90, 120, 240], [240, 200, 60],
    [200, 90, 220], [70, 210, 210], [245, 140, 50], [150, 150, 150],
], np.uint8)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_frame(rgb, frame, draw_objects: bool = True):
    """FrameDrawer::DrawFrame equivalent: an RGB uint8 overlay.

    rgb: [H, W, 3] float/uint8; frame: slam.frame.FrameData. Tracked
    keypoints (kp_pt >= 0) draw green, untracked blue; object member
    keypoints take their instance color; masks alpha-blend; bboxes
    outline.
    """
    img = np.ascontiguousarray(np.asarray(to_numpy(rgb), np.float32))
    H, W = img.shape[:2]

    if draw_objects:
        masks = to_numpy(frame.obj.masks)
        valid = to_numpy(frame.obj.valid)
        bbox = to_numpy(frame.obj.bbox)
        for i in range(masks.shape[0]):
            if not valid[i]:
                continue
            c = _COLORS[i % len(_COLORS)].astype(np.float32)
            m = masks[i]
            img[m] = 0.55 * img[m] + 0.45 * c
            x, y, w, h = bbox[i].astype(int)
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + w, W - 1), min(y + h, H - 1)
            img[y0:y1, x0:x0 + 2] = c
            img[y0:y1, x1 - 1:x1 + 1] = c
            img[y0:y0 + 2, x0:x1] = c
            img[y1 - 1:y1 + 1, x0:x1] = c

    uv = to_numpy(frame.uv_raw)
    ok = to_numpy(frame.valid)
    tracked = to_numpy(frame.kp_pt) >= 0
    kp_obj = to_numpy(frame.obj.kp2obj)
    for n in range(uv.shape[0]):
        if not ok[n]:
            continue
        x, y = int(uv[n, 0]), int(uv[n, 1])
        if not (1 <= x < W - 1 and 1 <= y < H - 1):
            continue
        if kp_obj[n] >= 0:
            c = _COLORS[kp_obj[n] % len(_COLORS)]
        elif tracked[n]:
            c = np.array([40, 230, 60], np.uint8)
        else:
            c = np.array([70, 110, 230], np.uint8)
        img[y - 1:y + 2, x - 1:x + 2] = c
    return np.clip(img, 0, 255).astype(np.uint8)


def save_frame_png(path, rgb, frame, **kw):
    write_png(path, draw_frame(rgb, frame, **kw))


def render_map_3d(m: MapState, path: str | None = None,
                  show_covisibility: bool = True,
                  show_objects: bool = True, elev: float = -60,
                  azim: float = -90):
    """MapDrawer equivalent: 3D scatter of map points, keyframe frusta
    (as axes), covisibility edges, object boxes. Saves a PNG if path is
    given; returns the matplotlib figure (matplotlib is imported here, on
    first use)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")

    pts = to_numpy(m.pt_xyz)
    ok = to_numpy(m.pt_valid)
    obj = to_numpy(m.pt_obj)
    free = ok & (obj < 0)
    ax.scatter(pts[free, 0], pts[free, 1], pts[free, 2], s=1, c="k",
               alpha=0.4, linewidths=0)
    if show_objects:
        obj_bbox = to_numpy(m.obj_bbox)
        for j in np.unique(obj[ok & (obj >= 0)]):
            sel = ok & (obj == j)
            c = _COLORS[int(j) % len(_COLORS)] / 255.0
            ax.scatter(pts[sel, 0], pts[sel, 1], pts[sel, 2], s=4,
                       color=c, linewidths=0)
            bb = obj_bbox[int(j)]
            if np.isfinite(bb).all():
                _draw_aabb(ax, bb[:3], bb[3:], c)

    kf_pose = to_numpy(m.kf_pose)
    kf_ok = to_numpy(m.kf_valid)
    centers = []
    for k in range(kf_pose.shape[0]):
        if not kf_ok[k]:
            continue
        Twc = np.linalg.inv(kf_pose[k])
        c = Twc[:3, 3]
        centers.append((k, c))
        z = Twc[:3, 2] * 0.15
        ax.plot([c[0], c[0] + z[0]], [c[1], c[1] + z[1]],
                [c[2], c[2] + z[2]], color="g", lw=1)
    if centers:
        cs = np.array([c for _, c in centers])
        ax.plot(cs[:, 0], cs[:, 1], cs[:, 2], color="g", lw=0.8)

    if show_covisibility and len(centers) > 1:
        W = to_numpy(covisibility(m))
        for (ka, ca) in centers:
            for (kb, cb) in centers:
                if kb > ka and W[ka, kb] >= 50:
                    ax.plot([ca[0], cb[0]], [ca[1], cb[1]], [ca[2], cb[2]],
                            color="0.6", lw=0.3)

    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def _draw_aabb(ax, mn, mx, color):
    for a in range(3):
        b, c = [i for i in range(3) if i != a]
        for vb in (mn[b], mx[b]):
            for vc in (mn[c], mx[c]):
                seg = [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]
                seg[a] = [mn[a], mx[a]]
                seg[b] = [vb, vb]
                seg[c] = [vc, vc]
                ax.plot(*seg, color=color, lw=0.8)
