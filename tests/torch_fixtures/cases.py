"""Seeded numpy inputs for the object layer, shared by the port's tests and
make_reference.py. Each builder returns plain numpy arrays: overrides of
the initial map's fields, the frame's fields and its detection slab's
fields, so that either package builds its own structures from them."""

from __future__ import annotations

import numpy as np

W, H = 160, 120
FX = FY = 130.0
CX, CY = 80.0, 60.0
BF = 13.0


def rotation(w):
    """Rodrigues: axis-angle [3] -> [3, 3] f32."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    return R.astype(np.float32)


def pose(w, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = rotation(w)
    T[:3, 3] = t
    return T


def project(T, pw):
    pc = pw @ T[:3, :3].T + T[:3, 3]
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    return np.stack([u, v], -1).astype(np.float32), pc[:, 2], \
        (u - BF / pc[:, 2]).astype(np.float32)


def random_masks(rng, I, h=H, w=W, n_blobs=6):
    """[I, h, w] bool: unions of random ellipses and boxes (some empty
    rows at the end), with holes, touching the borders now and then."""
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((I, h, w), bool)
    for i in range(I - 1):
        for _ in range(rng.randint(1, n_blobs)):
            cy, cx = rng.uniform(-10, h + 10), rng.uniform(-10, w + 10)
            ry, rx = rng.uniform(3, 30), rng.uniform(3, 40)
            if rng.rand() < 0.5:
                m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            else:
                m = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
            masks[i] |= m
        if rng.rand() < 0.3:
            hy, hx = rng.randint(0, h), rng.randint(0, w)
            masks[i, max(hy - 3, 0):hy + 3, max(hx - 3, 0):hx + 3] = False
    return masks


def detections(rng, I=8, n_kp=256, h=H, w=W):
    """A frame's detector rows and keypoints for build_object2ds: rgb
    [h, w, 3] with grey, black and pure-red rows, masks, labels, probs,
    bboxes (from the masks), inst_valid, keypoint uv / depth / valid."""
    masks = random_masks(rng, I, h, w)
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    # grey (c == 0), black (v == 0) and pure-red rows
    rgb[:8] = rng.randint(0, 256, (8, w, 1)).astype(np.float32)
    rgb[8:12] = 0.0
    rgb[12:16, :, 0] = 255.0
    rgb[12:16, :, 1] = 0.0
    labels = rng.choice([56, 62, 73, 41], I).astype(np.int32)
    probs = rng.uniform(0.7, 1.0, I).astype(np.float32)
    bboxes = np.zeros((I, 4), np.float32)
    for i in range(I):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            bboxes[i] = [xs.min(), ys.min(), xs.max() - xs.min(),
                         ys.max() - ys.min()]
    inst_valid = masks.any(axis=(1, 2))
    inst_valid[rng.randint(0, I)] = False
    kp_uv = np.stack([rng.uniform(-2, w + 2, n_kp),
                      rng.uniform(-2, h + 2, n_kp)], -1).astype(np.float32)
    # half of the keypoints on mask pixels, a few on round-half ties
    ys, xs = np.nonzero(masks.any(axis=0))
    pick = rng.randint(0, len(ys), n_kp // 2)
    kp_uv[:n_kp // 2] = np.stack([xs[pick], ys[pick]], -1) + rng.uniform(
        -0.5, 0.5, (n_kp // 2, 2))
    kp_uv[:8] = np.round(kp_uv[:8]) + 0.5
    kp_depth = rng.uniform(0.2, 6.0, n_kp).astype(np.float32)
    kp_depth[rng.rand(n_kp) < 0.1] = -1.0
    kp_valid = rng.rand(n_kp) < 0.9
    return dict(rgb=rgb, masks=masks, labels=labels, probs=probs,
                bboxes=bboxes, inst_valid=inst_valid, kp_uv=kp_uv,
                kp_depth=kp_depth, kp_valid=kp_valid)


def association(rng, I=16, J=8, Hc=16):
    """A map with objects and history rings, a last frame and a current
    frame whose detections partly re-observe them. Returns (map
    overrides, frame fields, frame slab, last fields, last slab)."""
    D = 94
    base = rng.dirichlet(np.ones(D) * 0.3, J).astype(np.float32)
    obj_label = rng.choice([56, 62, 73], J).astype(np.int32)
    centers = np.stack([rng.uniform(-1, 1, J), rng.uniform(-0.5, 0.5, J),
                        rng.uniform(2.0, 4.0, J)], -1).astype(np.float32)
    hist_n = rng.randint(0, 2 * Hc, J).astype(np.int32)
    hist_n[0] = 3
    ring = np.clip(base[:, None, :] + rng.normal(0, 0.004, (J, Hc, D)),
                   0, None).astype(np.float32)
    center_ring = (centers[:, None, :]
                   + rng.normal(0, 0.05, (J, Hc, 3))).astype(np.float32)
    obj_valid = rng.rand(J) < 0.85
    obj_valid[:3] = True
    obj_replaced = np.full(J, -1, np.int32)
    obj_replaced[J - 1] = 2
    m = dict(obj_valid=obj_valid, obj_label=obj_label,
             obj_track_id=np.arange(J, dtype=np.int32),
             obj_replaced=obj_replaced, obj_hist_ring=ring,
             obj_center_ring=center_ring, obj_campos_ring=np.zeros(
                 (J, Hc, 3), np.float32),
             obj_hist_n=hist_n, n_obj=np.int32(J),
             next_track_id=np.int32(J))

    T = pose([0.01, -0.02, 0.005], [0.02, -0.01, 0.03])
    Twc = np.linalg.inv(T)

    def slab(src_obj, n_valid):
        """Detections of map objects src_obj[i] (-1: a new object)."""
        label = np.full(I, -1, np.int32)
        valid = np.zeros(I, bool)
        hist = np.zeros((I, D), np.float32)
        bbox = np.zeros((I, 4), np.float32)
        cuv = np.zeros((I, 2), np.float32)
        md = np.zeros(I, np.float32)
        for i in range(n_valid):
            j = src_obj[i]
            if j >= 0:
                label[i] = obj_label[j]
                hist[i] = np.clip(base[j] + rng.normal(0, 0.004, D), 0, None)
                pc = (T[:3, :3] @ centers[j] + T[:3, 3]
                      + rng.normal(0, 0.03, 3))
            else:
                label[i] = rng.choice([56, 62, 73])
                hist[i] = rng.dirichlet(np.ones(D) * 0.3)
                pc = np.array([rng.uniform(-1, 1), rng.uniform(-0.5, 0.5),
                               rng.uniform(2, 4)])
            hist[i] /= hist[i].sum()
            cuv[i] = [FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY]
            md[i] = pc[2]
            bbox[i] = [cuv[i, 0] - 15, cuv[i, 1] - 12, 30, 24]
            valid[i] = True
        return dict(label=label, prob=np.full(I, 0.9, np.float32),
                    bbox=bbox.astype(np.float32), hist=hist, valid=valid,
                    centroid_uv=cuv, mean_depth=md)

    # last frame: detections of objects 0, 1, 2, 3 and one unmatched
    last_src = [0, 1, 2, 3, -1]
    last = slab(last_src, 5)
    last_obj3d = np.full(I, -1, np.int32)
    last_obj3d[:4] = [0, 1, J - 1, 3]        # J-1 was merged into 2
    # current: the same objects, shuffled, a duplicate claimant and news
    cur_src = [1, 0, 3, 2, 4, 5, 0, -1, -1]
    cur = slab(cur_src, len(cur_src))
    # the last frame's boxes are moved a little so that the IoU gate holds
    for i, j in enumerate(cur_src):
        if j in last_src[:4]:
            li = last_src.index(j)
            last["bbox"][li] = cur["bbox"][i] + rng.normal(0, 2.0, 4)
            last["label"][li] = cur["label"][i]
    frame = dict(Tcw=T, obj3d=np.full(I, -1, np.int32))
    last_f = dict(Tcw=T, obj3d=last_obj3d)
    return m, frame, cur, last_f, last, Twc


def update(rng, I=16, J=8, P=1024, N=256, Hc=16):
    """A map with points owned by objects and a tracked frame with
    detections: some matched to map objects, some new, keypoints bound to
    points (with duplicates, unmatched rows, far outliers and a small
    far sub-cluster per object). Returns (map overrides, frame fields,
    frame slab)."""
    n_obj = 4
    centers = np.stack([np.linspace(-1.2, 1.2, n_obj + 2),
                        rng.uniform(-0.3, 0.3, n_obj + 2),
                        rng.uniform(2.5, 3.5, n_obj + 2)], -1)
    pts = np.zeros((P, 3), np.float32)
    pt_valid = np.zeros(P, bool)
    pt_obj = np.full(P, -1, np.int32)
    owner_det = np.full(P, -1, np.int32)
    n = 0
    groups = []
    for k in range(n_obj + 2):
        cnt = [60, 45, 30, 12, 40, 25][k]
        g = centers[k] + rng.normal(0, 0.06, (cnt, 3))
        g[:3] += rng.normal(0, 1.0, (3, 3))            # 3-sigma outliers
        g[3:7] = centers[k] + np.array([0.5, 0.5, 0]) + rng.normal(
            0, 0.02, (4, 3))                              # far sub-cluster
        pts[n:n + cnt] = g
        pt_valid[n:n + cnt] = True
        groups.append(np.arange(n, n + cnt))
        n += cnt
    # background points
    nb = 200
    pts[n:n + nb] = np.stack([rng.uniform(-2, 2, nb), rng.uniform(-1, 1, nb),
                              rng.uniform(3, 6, nb)], -1)
    pt_valid[n:n + nb] = True
    pt_valid[P - 1] = True
    # map objects 0..3 own part of their groups already
    for k in range(n_obj):
        pt_obj[groups[k][::2]] = k
    label_cnt = np.zeros((P, 16), np.int32)
    label_tot = np.zeros(P, np.int32)
    own = pt_obj >= 0
    slot_of = {56: 3, 62: 5, 73: 10, 41: 2}
    obj_label = np.array([56, 62, 56, 73, -1, -1, -1, -1], np.int32)
    for p in np.nonzero(own)[0]:
        s = slot_of[int(obj_label[pt_obj[p]])]
        label_cnt[p, s] = rng.randint(0, 4)
        label_cnt[p, rng.randint(0, 16)] += rng.randint(0, 3)
        label_tot[p] = label_cnt[p].sum()
    bb = np.zeros((J, 6), np.float32)
    for k in range(n_obj):
        bb[k, :3] = centers[k] - 0.2
        bb[k, 3:] = centers[k] + 0.2
    bb[2, :3] = bb[0, :3] + 0.02                     # 0 and 2 overlap
    bb[2, 3:] = bb[0, 3:] + 0.02
    m = dict(pt_xyz=pts, pt_valid=pt_valid, pt_obj=pt_obj,
             pt_label_cnt=label_cnt, pt_label_tot=label_tot,
             n_pt=np.int32(n + nb),
             obj_valid=np.array([1, 1, 1, 1, 0, 0, 0, 0], bool),
             obj_label=obj_label,
             obj_track_id=np.array([0, 1, 2, 3, -1, -1, -1, -1], np.int32),
             obj_n_updates=np.array([3, 9, 2, 7, 0, 0, 0, 0], np.int32),
             obj_hist_n=np.array([3, 20, 5, 17, 0, 0, 0, 0], np.int32),
             obj_hist_ring=rng.uniform(0, 0.02, (J, Hc, 94)).astype(
                 np.float32),
             obj_bbox=bb, n_obj=np.int32(n_obj), next_track_id=np.int32(4))

    # frame: detections 0..5 see groups 0..5; 0..2 matched to objects 0, 1
    # and 3, 3..5 new (4 and 5 with enough 3D support)
    det_group = [0, 1, 3, 2, 4, 5]
    obj3d = np.full(I, -1, np.int32)
    obj3d[:3] = [0, 1, 3]
    label = np.full(I, -1, np.int32)
    label[:6] = [56, 62, 73, 56, 41, 99]
    valid = np.zeros(I, bool)
    valid[:6] = True
    kp2obj = np.full(N, -1, np.int32)
    kp_pt = np.full(N, -1, np.int32)
    i = 0
    for d, g in enumerate(det_group):
        members = groups[g][1::2] if g < n_obj else groups[g]
        for p in members[:30]:
            if i >= N - 20:
                break
            kp2obj[i] = d
            kp_pt[i] = p
            i += 1
    kp_pt[i:i + 3] = kp_pt[:3]                       # duplicate bindings
    kp2obj[i:i + 3] = 1
    kp_pt[i + 3:i + 10] = rng.randint(n, n + nb, 7)  # background
    fvalid = np.ones(N, bool)
    fvalid[rng.randint(0, N, 8)] = False
    T = pose([0.02, 0.01, -0.01], [0.05, -0.02, 0.01])
    cuv = rng.uniform(20, 140, (I, 2)).astype(np.float32)
    md = rng.uniform(1.5, 4.0, I).astype(np.float32)
    hist = rng.dirichlet(np.ones(94), I).astype(np.float32)
    frame = dict(Tcw=T, obj3d=obj3d, kp_pt=kp_pt, valid=fvalid)
    slab = dict(label=label, valid=valid, kp2obj=kp2obj, hist=hist,
                centroid_uv=cuv, mean_depth=md)
    return m, frame, slab


def regularize(rng, J=8):
    """Overlapping same-label boxes (a chain across three objects),
    different labels, an invalid object and a degenerate box."""
    c = rng.uniform(-1, 1, (J, 3)).astype(np.float32)
    s = rng.uniform(0.1, 0.3, (J, 1)).astype(np.float32)
    c[1] = c[0] + 0.05
    c[2] = c[1] + 0.05
    c[4] = c[3]
    bb = np.concatenate([c - s, c + s], -1).astype(np.float32)
    bb[6, 3:] = bb[6, :3]                            # zero volume
    label = np.array([56, 56, 56, 62, 73, 56, 56, 62], np.int32)
    valid = np.ones(J, bool)
    valid[7] = False
    tid = rng.permutation(J).astype(np.int32)
    pt_obj = rng.randint(-1, J, 512).astype(np.int32)
    return dict(obj_bbox=bb, obj_label=label, obj_valid=valid,
                obj_track_id=tid, pt_obj=pt_obj)


def semopt(rng, n_kp=256):
    """PoseOptimization2 on a known scene: 180 background and 40 object
    points, every one matched, a mask around the object's projection at
    the true pose, a perturbed start, pixel noise and a few gross
    outliers. Half of the object keypoints lie in the detection
    (kp2obj = 0); the rest are M_joint candidates. Returns (map overrides,
    frame fields, slab fields, T_true, T0)."""
    n_bg, n_obj = 180, 40
    pw_bg = rng.uniform([-1.5, -1.0, 2.5], [1.5, 1.0, 5.0], (n_bg, 3))
    pw_obj = rng.uniform([-0.3, -0.3, 2.8], [0.3, 0.3, 3.4], (n_obj, 3))
    pw = np.concatenate([pw_bg, pw_obj]).astype(np.float32)
    n_tot = n_bg + n_obj
    T_true = pose([0.01, -0.02, 0.01], [0.05, -0.02, 0.03])
    T0 = pose([0.015, -0.014, 0.016], [0.07, -0.03, 0.045])
    uv, z, ur = project(T_true, pw)
    desc = rng.randint(0, 2 ** 32, (n_tot, 8), dtype=np.uint64).astype(
        np.uint32)

    m = dict(pt_xyz=np.pad(pw, ((0, 1024 - n_tot), (0, 0))),
             pt_desc=np.pad(desc, ((0, 1024 - n_tot), (0, 0))),
             pt_valid=np.arange(1024) < n_tot,
             pt_obj=np.where((np.arange(1024) >= n_bg)
                             & (np.arange(1024) < n_tot), 0, -1).astype(
                                 np.int32),
             obj_valid=np.arange(8) == 0,
             obj_label=np.where(np.arange(8) == 0, 56, -1).astype(np.int32),
             obj_track_id=np.where(np.arange(8) == 0, 0, -1).astype(
                 np.int32),
             n_pt=np.int32(n_tot), n_obj=np.int32(1))

    uv_obj = uv[n_bg:]
    mask = np.zeros((H, W), bool)
    yy = np.clip(np.round(uv_obj[:, 1]).astype(int), 2, H - 3)
    xx = np.clip(np.round(uv_obj[:, 0]).astype(int), 2, W - 3)
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            mask[yy + dy, xx + dx] = True

    pad = n_kp - n_tot
    uvn = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
    uvn[rng.choice(n_bg, 6, replace=False)] += 25.0   # gross outliers
    kp2obj = np.full(n_kp, -1, np.int32)
    kp2obj[n_bg:n_tot:2] = 0
    level = rng.randint(0, 3, n_kp).astype(np.int32)
    frame = dict(
        uv=np.concatenate([uvn, np.zeros((pad, 2), np.float32)]),
        ur=np.concatenate([np.where(rng.rand(n_tot) < 0.7, ur, -1.0),
                           np.full(pad, -1.0)]).astype(np.float32),
        level=level,
        valid=np.arange(n_kp) < n_tot,
        kp_pt=np.where(np.arange(n_kp) < n_tot, np.arange(n_kp),
                       -1).astype(np.int32),
        obj3d=np.where(np.arange(16) == 0, 0, -1).astype(np.int32))
    slab = dict(valid=np.arange(16) == 0,
                label=np.where(np.arange(16) == 0, 56, -1).astype(np.int32),
                kp2obj=kp2obj, mask=mask)
    return m, frame, slab, T_true, T0


# ---------------------------------------------------------------------------
# Full field sets (numpy) from the overrides above
# ---------------------------------------------------------------------------

def slab_fields(I, h, w, n_kp, **over):
    """Object2DSlab fields of the empty slab, with overrides."""
    c_h, c_w = min(256, h), min(256, w)
    f = dict(label=np.full(I, -1, np.int32), prob=np.zeros(I, np.float32),
             bbox=np.zeros((I, 4), np.float32),
             kp2obj=np.full(n_kp, -1, np.int32),
             n_kps=np.zeros(I, np.int32),
             hist=np.zeros((I, 94), np.float32),
             ftmap=np.full((I, c_h, c_w, 2), -1.0, np.float32),
             ft_origin=np.zeros((I, 2), np.int32),
             masks=np.zeros((I, h, w), bool),
             centroid_uv=np.zeros((I, 2), np.float32),
             mean_depth=np.zeros(I, np.float32),
             valid=np.zeros(I, bool))
    for k, v in over.items():
        f[k] = np.asarray(v, f[k].dtype)
    return f


def frame_fields(I, n_kp, **over):
    """FrameData fields (all but obj) of an empty tracked frame, with
    overrides."""
    f = dict(timestamp=np.float32(0.0),
             uv_raw=np.zeros((n_kp, 2), np.float32),
             uv=np.zeros((n_kp, 2), np.float32),
             ur=np.full(n_kp, -1.0, np.float32),
             depth=np.full(n_kp, -1.0, np.float32),
             level=np.zeros(n_kp, np.int32),
             angle=np.zeros(n_kp, np.float32),
             response=np.ones(n_kp, np.float32),
             desc=np.zeros((n_kp, 8), np.uint32),
             valid=np.zeros(n_kp, bool),
             obj3d=np.full(I, -1, np.int32),
             kp_pt=np.full(n_kp, -1, np.int32),
             Tcw=np.eye(4, dtype=np.float32),
             pose_ok=np.bool_(True))
    for k, v in over.items():
        f[k] = np.asarray(v, f[k].dtype)
    if "uv" in over and "uv_raw" not in over:
        f["uv_raw"] = f["uv"].copy()
    return f


def map_fields(init_numpy, **over):
    """An initial map's numpy fields (either package's init_map), with
    overrides."""
    f = {k: np.array(v) for k, v in init_numpy.items()}
    for k, v in over.items():
        f[k] = np.asarray(v, f[k].dtype).reshape(f[k].shape) \
            if np.ndim(v) == np.ndim(f[k]) else np.asarray(v, f[k].dtype)
    return f
