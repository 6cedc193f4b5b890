"""Synthetic RGB-D / stereo scene generator for tests and benchmarks.

A numpy copy of the parts of object_slam_tpu/datasets/synthetic.py that
the port's tests and chip_smoke.py use (scene, RGB-D render, detection
slab, orbit trajectory), so the port renders the same frames from the same seed
without importing the JAX package.

The reference repository ships no data (images/masks are external
downloads, README.md:64); correctness here is established on synthetic
scenes with exact ground truth: a textured random world rendered as sparse
depth + image patches, plus box-shaped "objects" with instance masks — the
scene generator that SURVEY.md §4 calls for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def _upsample_bilinear(t, size):
    idx = np.linspace(0, t.shape[0] - 1, size)
    xi = np.floor(idx).astype(int)
    fi = (idx - xi)[:, None]
    xi2 = np.minimum(xi + 1, t.shape[0] - 1)
    rows = t[xi] * (1 - fi) + t[xi2] * fi
    fj = (idx - xi)[None, :]
    cols = rows[:, xi] * (1 - fj) + rows[:, xi2] * fj
    return cols.astype(np.float32)


def _smooth_texture(rng, size):
    """Multi-octave band-limited random field: sharp enough for FAST
    corners, smooth enough for stable intensity-centroid orientations,
    and DISTINCTIVE enough locally that descriptor matching cannot alias
    between look-alike patches (a single low-pass octave reads like
    repetitive wallpaper — brute-force matching under fast pan then locks
    onto a self-consistent wrong association; diagnosed round 2)."""
    out = np.zeros((size, size), np.float32)
    for div, amp in [(16, 0.45), (8, 0.3), (4, 0.25)]:
        t = rng.uniform(0, 255, (max(size // div, 2),) * 2).astype(np.float32)
        out += amp * _upsample_bilinear(t, size)
    return out


def _tex_sample(tex, u, v):
    """Bilinear periodic texture lookup with float coords. Non-finite
    coords (rays that escape every surface, t_hit = inf) sample texel 0 —
    the np.where callers mask those pixels out, but both branches are
    evaluated eagerly, so the lookup itself must not fault."""
    th, tw = tex.shape
    u = np.where(np.isfinite(u), u, 0.0)
    v = np.where(np.isfinite(v), v, 0.0)
    u = np.mod(u, tw - 1)
    v = np.mod(v, th - 1)
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    fu = u - u0
    fv = v - v0
    u1 = np.minimum(u0 + 1, tw - 1)
    v1 = np.minimum(v0 + 1, th - 1)
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def _undistort_grid(h, w, fx, fy, cx, cy, dist, iters: int | None = None):
    """Per-pixel ideal (undistorted) normalized coordinates for a camera
    whose IMAGE GRID is distorted: pixel (u, v) of the rendered image is
    the distorted observation of normalized ray (xn, yn, 1). Fixed-point
    inversion of the radial-tangential model with the SAME iteration count
    as geometry/camera.undistort_points (UNDISTORT_ITERS), so the renderer
    and the front end agree on the inverse model by construction."""
    if iters is None:
        from object_slam_tpu_torch.geometry.camera import UNDISTORT_ITERS
        iters = UNDISTORT_ITERS
    k1, k2, p1, p2, k3 = dist
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xd = (xs - cx) / fx
    yd = (ys - cy) / fy
    xn, yn = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = xn * xn + yn * yn
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
        dy = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
        xn -= dx - xd
        yn -= dy - yd
    return np.stack([xn, yn, np.ones_like(xn)], axis=-1).astype(np.float32)


@dataclass
class SyntheticScene:
    h: int
    w: int
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    rng: np.random.RandomState
    # world content
    tex: np.ndarray            # back-wall texture (plane z = plane_z)
    plane_z: float
    boxes: List[dict]          # semantic object boxes {center, size, label, tex}
    rays: np.ndarray           # [H, W, 3] per-pixel camera rays (z = 1)
    surfaces: List[dict]       # room planes {axis, offset, tex, uax, vax}
    structures: List[dict]     # unlabeled furniture boxes {center, size, tex}
    bounds_lo: np.ndarray      # room AABB (for surface clipping)
    bounds_hi: np.ndarray
    uv_scale: float = 80.0     # texture texels per world unit
    lane: np.ndarray = None    # [N, 3] drive path (street mode): road
                               # markings render relative to this curve

    @staticmethod
    def make(cfg, seed=0, n_objects=2, plane_z=4.0, n_structures=10,
             room=True, scale=1.0, corridor_len=None, path=None):
        """A closed textured room (floor/ceiling/4 walls) with unlabeled
        furniture boxes at varied depths plus labeled object boxes.

        scale multiplies every world dimension (room, boxes, distances) —
        scale 8+ with the KITTI camera approximates an outdoor street
        canyon (ground + building walls + car-sized boxes).

        Depth diversity matters: a single fronto-parallel far plane leaves
        camera z observable only through the virtual-right residual at
        ~0.4 px per 100 mm — pose drift along the optical axis then feeds
        back through spawned-point depth and compounds (diagnosed round-2;
        the round-1 single-plane scene was the main collapse driver on
        long sequences). room=False reproduces the old degenerate layout.
        """
        rng = np.random.RandomState(seed)
        cam = cfg.camera
        # Texture period MUST exceed every surface extent: _tex_sample
        # wraps periodically, and at 80 texels/unit a 256-texel texture
        # repeats every 3.2 units — wall segments one period apart were
        # PIXEL-IDENTICAL, and descriptor matching locked onto the alias
        # as a consistent wrong consensus (measured round 2: 98%-wrong
        # matches under pan, one-frame 250 mm pose jumps). 1024 texels =
        # a 12.8-unit period, larger than any room dimension.
        tex = _smooth_texture(rng, 1024)
        boxes = []
        for i in range(n_objects):
            boxes.append(dict(
                center=np.array([rng.uniform(-1.0, 1.0),
                                 rng.uniform(-0.7, 0.7),
                                 plane_z - rng.uniform(0.8, 1.6)]),
                size=rng.uniform(0.4, 0.7),
                label=int([56, 62, 73][i % 3]),
                tex=_smooth_texture(rng, 64)))
        bounds_lo = np.array([-2.2, -1.4, -1.2], np.float32)
        bounds_hi = np.array([2.2, 1.0, plane_z], np.float32)
        surfaces = [dict(axis=2, offset=plane_z, tex=tex, uax=0, vax=1)]
        structures = []
        if room:
            # floor / ceiling / side walls / front wall, each own texture
            for axis, offset, uax, vax in [(1, 1.0, 0, 2), (1, -1.4, 0, 2),
                                           (0, -2.2, 2, 1), (0, 2.2, 2, 1),
                                           (2, -1.2, 0, 1)]:
                surfaces.append(dict(axis=axis, offset=offset,
                                     tex=_smooth_texture(rng, 1024),
                                     uax=uax, vax=vax))
            # furniture all around the camera ring (loop_trajectory pans a
            # full turn — every viewing direction needs close structure or
            # the frame degenerates to a fronto-parallel bare wall), with
            # an exclusion zone so no box swallows the camera path
            while len(structures) < n_structures:
                size = rng.uniform(0.25, 0.8)
                c = np.array([rng.uniform(-1.9, 1.9),
                              1.0 - size / 2 - rng.uniform(0, 0.6),
                              rng.uniform(-0.9, 3.6)])
                # clearance from the camera PATH, not just the ring
                # center: loop_trajectory reaches 0.85 from (0, 0.35) in
                # x-z, so a box must keep its half-diagonal plus ~0.5 m
                # beyond that or it ends up centimeters from the lens
                # (measured: a box at 0.47 m filled half the image and
                # collapsed association under pan)
                if np.hypot(c[0], c[2] - 0.35) < 0.85 + size * 0.87 + 0.5:
                    continue
                structures.append(dict(center=c, size=size,
                                       tex=_smooth_texture(rng, 64)))
        # Lens model: the rendered image is DISTORTED exactly like the real
        # sensor the config describes (TUM2 has strong k1/k2/k3), so the
        # front end's undistortion path is exercised end-to-end. A pinhole
        # render under a distorted config would inject a position-dependent
        # systematic warp into every synthetic e2e metric.
        if scale != 1.0:
            plane_z *= scale
            bounds_lo = bounds_lo * scale
            bounds_hi = bounds_hi * scale
            for s in surfaces:
                s['offset'] *= scale
            for b in boxes + structures:
                b['center'] = b['center'] * scale
                b['size'] *= scale
        if corridor_len is not None:
            # Street-canyon mode (KITTI drives): stretch the room so the
            # WHOLE camera `path` (array of world camera centers) stays
            # inside the closed surface set (a ray escaping every surface
            # renders depth 0 and starves tracking), and respawn all box
            # content along the drive with clearance from the path.
            # Bounds derive from the path extents + margin — a curving
            # drive leaves x=0, and fixed side walls let the camera graze
            # or exit the room (ADVICE r2). All quantities POST-scale.
            pth = (np.asarray(path, np.float64) if path is not None
                   else np.zeros((1, 3)))
            margin = 4.0 * scale
            bounds_lo = bounds_lo.copy()
            bounds_hi = bounds_hi.copy()
            bounds_lo[0] = min(float(bounds_lo[0]),
                               float(pth[:, 0].min()) - margin)
            bounds_hi[0] = max(float(bounds_hi[0]),
                               float(pth[:, 0].max()) + margin)
            bounds_lo[2] = min(float(bounds_lo[2]),
                               float(pth[:, 2].min()) - margin)
            bounds_hi[2] = max(float(corridor_len),
                               float(pth[:, 2].max()) + margin)
            # road height: the KITTI camera rides ~1.65 m above the
            # ground with a +-14.7 deg vertical FOV (376 px) — with the
            # room's floor 1.0*scale (= 8 units) below the camera,
            # ground-level objects drop out of frame at ~21 units and
            # NEVER get close enough for the ThDepth membership gate
            # (measured r3: zero object detections over a whole drive).
            floor_y = 0.2 * scale
            bounds_hi[1] = floor_y
            for s in surfaces:
                if s['axis'] == 2:
                    s['offset'] = float(bounds_hi[2] if s['offset'] > 0
                                        else bounds_lo[2])
                elif s['axis'] == 0:
                    s['offset'] = float(bounds_hi[0] if s['offset'] > 0
                                        else bounds_lo[0])
                elif s['axis'] == 1 and s['offset'] > 0:
                    # the ROAD: with the camera 1.6 units up, nearby
                    # asphalt projects the default texel to ~25 px — no
                    # FAST corners, no close points, no translation
                    # observability. 8x denser texture (from a finer
                    # 256-texel field) gives the near field asphalt-like
                    # detail: ~12 mm texels ≈ 1.5-3 px at the 6-12 m
                    # close range, sharp enough for FAST yet still
                    # magnified (aliased minification decorrelates
                    # descriptors frame to frame — measured as 65% of
                    # close corners failing to re-detect).
                    s['offset'] = floor_y
                    s['tex'] = _smooth_texture(rng, 256)
                    s['tex_density'] = 8.0
                    s['road'] = True
            plane_z = float(bounds_hi[2])

            def _clear_of_path(c, size, margin=2.0):
                if path is None:
                    return True
                d = np.min(np.linalg.norm(pth - c[None, :], axis=1))
                return d > size * 0.87 + margin

            def _lane_x(z):
                """Path x at depth z (the drive may curve) so boxes line
                the lane instead of hugging x=0."""
                if path is None or len(pth) < 2:
                    return 0.0
                return float(np.interp(z, pth[:, 2], pth[:, 0]))

            z_lo = float(pth[:, 2].min()) + 2.0 * scale
            z_hi = max(float(pth[:, 2].max()), corridor_len) - 2.0 * scale
            structures = []
            while len(structures) < n_structures:
                size = rng.uniform(0.25, 0.8) * scale
                z = rng.uniform(z_lo, z_hi)
                # roadside band 0.5-1.8x scale off the lane (real streets:
                # facades, poles, parked clutter within ~15 m) — these
                # pass INSIDE the close-depth budget (ThDepth*baseline
                # ~18.8 units) during the drive-by and are the stable
                # close features the road's grazing texture cannot supply
                # (KF-policy retention, tracking.kf_decision need_close)
                side = rng.choice([-1.0, 1.0])
                c = np.array([_lane_x(z) + side
                              * rng.uniform(0.5, 1.8) * scale,
                              floor_y - size / 2, z])
                if _clear_of_path(c, size):
                    structures.append(dict(center=c, size=size,
                                           tex=_smooth_texture(rng, 128),
                                           tex_density=2.0))
            old_labels = [b['label'] for b in boxes]
            boxes = []
            while len(boxes) < n_objects:
                # car-sized boxes (~1.5-2.4 units at scale 8): the room
                # defaults are furniture-scale; a 5-unit cube on the road
                # towers over the camera and clips the narrow vertical FOV
                size = rng.uniform(0.18, 0.3) * scale
                z = rng.uniform(z_lo + 2.0 * scale, z_hi * 0.8)
                # parked close to the lane: object membership requires
                # keypoint depth < ThDepth*baseline (Frame.cc:240-384
                # gate, ~18.8 units at the KITTI calib), so a drive-by
                # must bring the box inside that range while still in the
                # field of view — wide lateral offsets never do
                c = np.array([_lane_x(z) + rng.choice([-1, 1])
                              * rng.uniform(0.45, 1.0) * scale,
                              floor_y - size / 2, z])
                if _clear_of_path(c, size, margin=1.0):
                    boxes.append(dict(center=c, size=size,
                                      label=old_labels[len(boxes)
                                                       % len(old_labels)],
                                      tex=_smooth_texture(rng, 256),
                                      tex_density=3.0))
        rays = _undistort_grid(cam.height, cam.width, cam.fx, cam.fy,
                               cam.cx, cam.cy, cam.dist)
        return SyntheticScene(h=cam.height, w=cam.width,
                              fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                              bf=cam.bf, rng=rng, tex=tex,
                              plane_z=plane_z, boxes=boxes, rays=rays,
                              surfaces=surfaces, structures=structures,
                              bounds_lo=bounds_lo, bounds_hi=bounds_hi,
                              uv_scale=80.0 / scale,
                              lane=(np.asarray(path, np.float64)
                                    if corridor_len is not None
                                    and path is not None else None))

    # ------------------------------------------------------------------
    def render_rgbd(self, Tcw: np.ndarray):
        """Ray-cast room surfaces + furniture + object boxes: returns
        (gray [H,W], depth [H,W], rgb [H,W,3],
        sem = (masks, labels, probs, bboxes, valid))."""
        h, w = self.h, self.w
        Twc = np.linalg.inv(Tcw)
        R, t = Twc[:3, :3], Twc[:3, 3]
        dirs_w = self.rays @ R.T
        o = t

        # room surfaces: nearest axis-aligned plane hit inside the room box
        t_hit = np.full((h, w), np.inf, np.float32)
        surf_id = np.full((h, w), -1, np.int32)
        for si, s in enumerate(self.surfaces):
            a = s['axis']
            denom = dirs_w[..., a]
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            tt = (s['offset'] - o[a]) / denom
            p = o + dirs_w * tt[..., None]
            inside = tt > 0.1
            for c in range(3):
                if c == a:
                    continue
                inside &= ((p[..., c] >= self.bounds_lo[c] - 1e-3)
                           & (p[..., c] <= self.bounds_hi[c] + 1e-3))
            tt = np.where(inside, tt, np.inf)
            upd = tt < t_hit
            t_hit = np.where(upd, tt, t_hit)
            surf_id = np.where(upd, si, surf_id)

        # boxes: axis-aligned slab test (furniture first, then objects —
        # objects win ties since they are drawn later)
        hit_struct = np.full((h, w), -1, np.int32)
        hit_obj = np.full((h, w), -1, np.int32)
        for i, b in enumerate(self.structures + self.boxes):
            lo = b['center'] - b['size'] / 2
            hi = b['center'] + b['size'] / 2
            with np.errstate(divide='ignore', invalid='ignore'):
                t0 = (lo - o) / dirs_w
                t1 = (hi - o) / dirs_w
            tmin = np.minimum(t0, t1).max(axis=-1)
            tmax = np.maximum(t0, t1).min(axis=-1)
            hit = (tmax > tmin) & (tmin > 0.1) & (tmin < t_hit)
            t_hit = np.where(hit, tmin, t_hit)
            if i < len(self.structures):
                hit_struct = np.where(hit, i, hit_struct)
            else:
                hit_obj = np.where(hit, i - len(self.structures), hit_obj)
                hit_struct = np.where(hit, -1, hit_struct)
        box_mask = (hit_obj >= 0) | (hit_struct >= 0)
        surf_id = np.where(box_mask, -1, surf_id)

        pts_w = o + dirs_w * t_hit[..., None]
        depth = t_hit * self.rays[..., 2]     # z-depth in camera frame
        depth = np.where(np.isfinite(depth), depth, 0.0)

        # texture lookup (bilinear, continuous coords -> subpixel-stable)
        img = np.zeros((h, w), np.float32)
        for si, s in enumerate(self.surfaces):
            mask = surf_id == si
            if not mask.any():
                continue
            sd = self.uv_scale * s.get('tex_density', 1.0)
            img = np.where(mask,
                           _tex_sample(s['tex'],
                                       pts_w[..., s['uax']] * sd,
                                       pts_w[..., s['vax']] * sd),
                           img)
            if s.get('road') and self.lane is not None:
                # painted lane markings (KITTI asphalt): a dashed center
                # line and solid edge lines relative to the drive path.
                # High-contrast paint edges give the near field STABLE
                # FAST corners at every scale — the smooth asphalt
                # texture alone re-detects only ~40% of its close
                # corners between frames under forward motion, and the
                # close-point budget (kf_decision need_close) starves
                # without them.
                lx = np.interp(pts_w[..., 2], self.lane[:, 2],
                               self.lane[:, 0])
                dx = pts_w[..., 0] - lx
                z = pts_w[..., 2]
                dash = np.mod(z, 4.0) < 2.2
                center = (np.abs(dx) < 0.12) & dash
                edges = (np.abs(np.abs(dx) - 3.2) < 0.15)
                paint = mask & (center | edges)
                img = np.where(paint, 235.0, img)
        bs = 1.25 * self.uv_scale
        # Box UV: both texture coordinates mix ALL THREE world axes with
        # rank-2 Jacobian on every face. The old mapping (u=x, v=y+0.6z)
        # was DEGENERATE on x-normal faces — u constant across the face —
        # so the side faces of roadside boxes (exactly the close surfaces
        # a passing camera must track) rendered as 1-D vertical stripes
        # with no FAST corners (visible in the r4 KITTI frames; close-
        # point retention collapsed there).
        bu = (pts_w[..., 0] + 0.71 * pts_w[..., 2]) * bs
        bv = (pts_w[..., 1] + 0.43 * pts_w[..., 2]
              + 0.23 * pts_w[..., 0]) * bs
        for i, b in enumerate(self.structures):
            mask = hit_struct == i
            if not mask.any():
                continue
            td = b.get('tex_density', 1.0)
            img = np.where(mask,
                           _tex_sample(b['tex'], bu * td, bv * td), img)
        for i, b in enumerate(self.boxes):
            mask = hit_obj == i
            bt = b['tex']
            # tex_density > 1 = finer surface detail (corridor cars: at
            # 5-15 units the default texel projects to ~10 px and FAST
            # finds no corners on the blur — zero object members)
            td = b.get('tex_density', 1.0)
            img = np.where(mask,
                           _tex_sample(bt, bu * td, bv * td), img)

        rgb = np.stack([img, img * 0.9, img * 0.8], axis=-1)
        # distinct hue per object for HSV association
        for i, b in enumerate(self.boxes):
            mask = hit_obj == i
            scale = [(1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.3, 0.3, 1.0)][i % 3]
            for c in range(3):
                rgb[..., c] = np.where(mask, img * scale[c], rgb[..., c])

        # semantics
        masks, labels, probs, bboxes, valid = [], [], [], [], []
        for i, b in enumerate(self.boxes):
            mask = hit_obj == i
            if mask.sum() < 400:
                continue
            ys_, xs_ = np.nonzero(mask)
            masks.append(mask)
            labels.append(b['label'])
            probs.append(0.95)
            bboxes.append([xs_.min(), ys_.min(),
                           xs_.max() - xs_.min(), ys_.max() - ys_.min()])
            valid.append(True)
        return img, depth, rgb, (masks, labels, probs, bboxes, valid)

    def sem_arrays(self, sem, max_instances):
        """render_rgbd's detection lists -> the static [I] slab
        (masks, labels, probs, bboxes, valid) that track_rgbd takes."""
        masks, labels, probs, bboxes, valid = sem
        I = max_instances
        M = np.zeros((I, self.h, self.w), bool)
        L = np.full((I,), -1, np.int32)
        Pb = np.zeros((I,), np.float32)
        B = np.zeros((I, 4), np.float32)
        V = np.zeros((I,), bool)
        for i in range(min(len(masks), I)):
            M[i], L[i], Pb[i], B[i], V[i] = (masks[i], labels[i], probs[i],
                                             bboxes[i], valid[i])
        return M, L, Pb, B, V


def orbit_poses(n: int, radius: float = 0.4, step: float = 0.03):
    """A gentle sideways trajectory looking at the scene (world->camera)."""
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-(i * step), 0.02 * np.sin(i * 0.3), 0.0]
        ang = 0.01 * i
        c, s = np.cos(ang), np.sin(ang)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(T)
    return poses
