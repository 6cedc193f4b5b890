"""The object layer of the PyTorch port against the JAX package, function by
function, on the CPU: HSV histograms, erosion, the jump-flooding feature
transform and its queries, the Object2D build, association, the object
update with its rejection and merge, and the semantic optimizer. Inputs
come from tests/torch_fixtures/cases.py (numpy, seeded); both packages run
live.

Tolerances: bins, counts, histograms, eroded masks, feature-transform maps
and nearest-pixel answers identical; Object2D kp2obj / n_kps / valid
exact and its floats 1e-5; IoU 1e-6; association obj3d exact; the update's
integer slabs exact and floats 1e-5; the merge exact; the semantic
optimizer's pose 1e-5 m / 1e-4 rad with kp_pt and n_sem exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.config import CameraConfig as JCameraConfig
from object_slam_tpu.config import CapacityConfig as JCapacityConfig
from object_slam_tpu.config import SemanticConfig as JSemanticConfig
from object_slam_tpu.config import SlamConfig as JSlamConfig
from object_slam_tpu.geometry.camera import Intrinsics as JIntrinsics
from object_slam_tpu.ops import distance_transform as jdt
from object_slam_tpu.semantic import hsv as jhsv
from object_slam_tpu.semantic import object2d as jo2d
from object_slam_tpu.slam import objects as jobj
from object_slam_tpu.slam.frame import FrameData as JFrameData
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu.slam.map_state import init_map as j_init_map
from object_slam_tpu.slam.tracking import TrackResult as JTrackResult
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import CameraConfig, CapacityConfig
from object_slam_tpu_torch.config import SemanticConfig, SlamConfig
from object_slam_tpu_torch.geometry.camera import Intrinsics
from object_slam_tpu_torch.ops import distance_transform as tdt
from object_slam_tpu_torch.semantic import hsv as thsv
from object_slam_tpu_torch.semantic import object2d as to2d
from object_slam_tpu_torch.slam import objects as tobj
from object_slam_tpu_torch.slam.map_state import init_map
from object_slam_tpu_torch.slam.tracking import TrackResult
from torch_fixtures import cases
from torch_fixtures.threads import share_cores

share_cores()

I_DET, N_KP, HC = 16, 256, 16


def _cfgs():
    cam = dict(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
               dist=(0, 0, 0, 0, 0), bf=13.0, th_depth=40.0,
               depth_map_factor=1.0)
    caps = dict(n_kp=N_KP, max_points=1024, max_keyframes=8, max_objects=8)
    return (JSlamConfig(camera=JCameraConfig(**cam),
                        caps=JCapacityConfig(**caps)),
            SlamConfig(camera=CameraConfig(**cam), caps=CapacityConfig(**caps)))


JCFG, TCFG = _cfgs()


def t(a):
    return torch.from_numpy(np.array(a))


def npy(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# builders: one numpy description, a structure in each package
# ---------------------------------------------------------------------------

def maps(over, Hc=HC):
    """(JAX MapState, port MapState) from the same overrides."""
    init = {f: np.asarray(getattr(j_init_map(JCFG.caps, Hc), f))
            for f in JMapState._fields}
    full = cases.map_fields(init, **over)
    return (JMapState(**{k: jnp.asarray(v) for k, v in full.items()}),
            interop.map_state_from_numpy(full, device="cpu"))


def frames(fields, slab):
    """(JAX FrameData, port FrameData) with a detection slab."""
    ff = cases.frame_fields(I_DET, N_KP, **fields)
    sf = cases.slab_fields(I_DET, 120, 160, N_KP, **slab)
    jf = JFrameData(obj=jo2d.Object2DSlab(**{k: jnp.asarray(v)
                                            for k, v in sf.items()}),
                    **{k: jnp.asarray(v) for k, v in ff.items()})
    return jf, interop.frame_from_numpy(ff, TCFG, device="cpu", obj=sf)


def engines():
    return (jobj.ObjectEngine(JCFG, JIntrinsics.from_config(JCFG.camera)),
            tobj.ObjectEngine(TCFG, Intrinsics.from_config(TCFG.camera),
                              device="cpu"))


def assert_maps(jm, tm, fields=None, atol=1e-5):
    got = interop.map_state_to_numpy(tm)
    for f in fields or JMapState._fields:
        want = np.asarray(getattr(jm, f))
        assert got[f].dtype == want.dtype, f
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got[f], want, rtol=0, atol=atol,
                                       err_msg=f)
        else:
            assert np.array_equal(got[f], want), f


# ---------------------------------------------------------------------------
# HSV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_bins_counts_and_histograms_exact(seed):
    """Against the compiled reference (as the system runs it)."""
    d = cases.detections(np.random.RandomState(seed))
    rgb, masks = jnp.asarray(d["rgb"]), jnp.asarray(d["masks"])
    j_hsv = np.asarray(jax.jit(jhsv.rgb_to_hsv_cv)(rgb))
    t_hsv = npy(thsv.rgb_to_hsv_cv(t(d["rgb"])))
    assert np.array_equal(t_hsv, j_hsv)
    j_oh = np.asarray(jax.jit(lambda x: jhsv._bin_onehot(
        jhsv.rgb_to_hsv_cv(x)))(rgb)).astype(np.float32)
    t_oh = npy(thsv._onehot(*thsv._hsv_unit(t(d["rgb"])),
                            thsv._H_DEG_SCALE, thsv._SV_UNIT_SCALE))
    assert np.array_equal(t_oh, j_oh)
    mf = d["masks"].reshape(d["masks"].shape[0], -1).astype(np.float32)
    counts = npy(t(mf) @ t(t_oh))
    assert np.array_equal(counts, mf @ j_oh)
    assert np.array_equal(counts, np.round(counts))
    j_h = np.asarray(jax.jit(jhsv.batched_histograms)(rgb, masks))
    assert np.array_equal(npy(thsv.batched_histograms(t(d["rgb"]),
                                                      t(d["masks"]))), j_h)
    # an HSV image given as input bins by the unfolded scales
    j_hh = np.asarray(jax.jit(jhsv.batched_histograms_hsv)(
        jnp.asarray(j_hsv), masks))
    assert np.array_equal(npy(thsv.batched_histograms_hsv(
        t(j_hsv), t(d["masks"]))), j_hh)
    assert np.array_equal(npy(thsv.masked_hsv_histogram(
        t(j_hsv), t(d["masks"][0]))), j_hh[0])


def test_cosine_similarity():
    rng = np.random.RandomState(3)
    a = rng.rand(5, 1, 94).astype(np.float32)
    b = rng.rand(1, 7, 94).astype(np.float32)
    b[0, 0] = 0.0
    np.testing.assert_allclose(
        npy(thsv.cosine_similarity(t(a), t(b))),
        np.asarray(jhsv.cosine_similarity(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# erosion, feature transform, nearest mask pixel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", [1, 3, 10])
def test_erode_identical(half):
    masks = cases.random_masks(np.random.RandomState(half), 6)
    masks[0] = True                       # outside counts as inside
    j = np.stack([np.asarray(jdt.erode(jnp.asarray(m), half))
                  for m in masks])
    assert np.array_equal(npy(tdt.erode(t(masks), half)), j)


@pytest.mark.parametrize("h,w", [(120, 120), (120, 160), (37, 53)])
def test_feature_transform_identical(h, w):
    rng = np.random.RandomState(h + w)
    masks = cases.random_masks(rng, 5, h, w)
    masks[1] = False
    masks[1, h - 1, 0] = True             # one seed in a corner
    j = np.asarray(jax.jit(jdt.feature_transform_batch)(jnp.asarray(masks)))
    got = npy(tdt.feature_transform_batch(t(masks)))
    assert np.array_equal(got, j)
    assert np.array_equal(npy(tdt.feature_transform(t(masks[0]))), j[0])
    assert np.all(got[4] == -1.0)         # the empty mask
    dj = np.asarray(jdt.distance_transform(jnp.asarray(masks[0])))
    assert np.array_equal(npy(tdt.distance_transform(t(masks[0]))), dj)


def test_nearest_mask_pixel_exact():
    rng = np.random.RandomState(11)
    masks = cases.random_masks(rng, 4, 120, 120)
    ft = np.asarray(jax.jit(jdt.feature_transform_batch)(
        jnp.asarray(masks)))
    S = 500
    idx = rng.randint(0, 4, S).astype(np.int32)
    uv = rng.uniform(-5, 125, (S, 2)).astype(np.float32)
    uv[:20] = np.round(uv[:20]) + 0.5     # round-half-even ties
    jn, jd = jdt.nearest_mask_pixel_batched(jnp.asarray(ft),
                                            jnp.asarray(idx), jnp.asarray(uv))
    tn, td = tdt.nearest_mask_pixel_batched(t(ft), t(idx), t(uv))
    assert np.array_equal(npy(tn), np.asarray(jn))
    assert np.array_equal(npy(td), np.asarray(jd))
    jn1, jd1 = jdt.nearest_mask_pixel(jnp.asarray(ft[0]), jnp.asarray(uv))
    tn1, td1 = tdt.nearest_mask_pixel(t(ft[0]), t(uv))
    assert np.array_equal(npy(tn1), np.asarray(jn1))
    assert np.array_equal(npy(td1), np.asarray(jd1))


# ---------------------------------------------------------------------------
# Object2D
# ---------------------------------------------------------------------------

def test_mask_bits_roundtrip():
    masks = cases.random_masks(np.random.RandomState(5), 3, 7, 21)
    packed = to2d.pack_mask_bits(masks)
    assert np.array_equal(packed, jo2d.pack_mask_bits(masks))
    got = npy(to2d.unpack_mask_bits(t(packed), 21))
    assert np.array_equal(got, masks)
    assert np.array_equal(got, np.asarray(jo2d.unpack_mask_bits(
        jnp.asarray(packed), 21)))


@pytest.mark.parametrize("I,margin,size", [(4, 10, (120, 160)),
                                           (16, 3, (120, 160)),
                                           (8, 5, (300, 320))])
def test_build_object2ds(I, margin, size):
    h, w = size
    d = cases.detections(np.random.RandomState(I + margin), I=I,
                         n_kp=N_KP, h=h, w=w)
    args = [d[k] for k in ("rgb", "masks", "labels", "probs", "bboxes",
                           "inst_valid", "kp_uv", "kp_depth", "kp_valid")]
    build = jax.jit(jo2d.build_object2ds,
                    static_argnames=("th_depth", "min_kps", "mask_margin"))
    js = build(*[jnp.asarray(a) for a in args], th_depth=4.0, min_kps=3,
               mask_margin=margin)
    ts = to2d.build_object2ds(*[t(a) for a in args], th_depth=4.0,
                              min_kps=3, mask_margin=margin)
    assert int(np.sum(np.asarray(js.valid))) >= 1
    for f in jo2d.Object2DSlab._fields:
        want, got = np.asarray(getattr(js, f)), npy(getattr(ts, f))
        assert got.shape == want.shape, f
        if f in ("centroid_uv", "mean_depth", "prob", "bbox"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            assert np.array_equal(got, want), f


def test_bbox_iou_2d():
    rng = np.random.RandomState(2)
    a = np.concatenate([rng.uniform(0, 100, (6, 2)),
                        rng.uniform(0, 40, (6, 2))], 1).astype(np.float32)
    b = np.concatenate([a[:3] + rng.normal(0, 3, (3, 4)),
                        np.zeros((2, 4))]).astype(np.float32)
    np.testing.assert_allclose(
        npy(to2d.bbox_iou_2d(t(a), t(b))),
        np.asarray(jo2d.bbox_iou_2d(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


def test_empty_slab_matches_reference():
    j = jo2d.empty_slab(16, 120, 160, N_KP)
    got = interop.slab_to_numpy(to2d.empty_slab(16, 120, 160, N_KP))
    for f in jo2d.Object2DSlab._fields:
        want = np.asarray(getattr(j, f))
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want), f


# ---------------------------------------------------------------------------
# association
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assoc_case():
    m, fr, cur, lf, last, _ = cases.association(np.random.RandomState(4),
                                                I=I_DET, J=8, Hc=HC)
    jm, tm = maps(m)
    jf, tf = frames(fr, cur)
    jl, tl = frames(lf, last)
    return jm, tm, jf, tf, jl, tl


def test_match_two_frame_exact(assoc_case):
    jm, tm, jf, tf, jl, tl = assoc_case
    want = np.asarray(jobj.match_two_frame(jm, jf, jl))
    got = npy(tobj.match_two_frame(tm, tf, tl))
    assert np.array_equal(got, want)
    assert np.sum(want >= 0) >= 3


def test_match_map_to_frame_exact(assoc_case):
    jm, tm, jf, tf, jl, tl = assoc_case
    jK = JIntrinsics.from_config(JCFG.camera)
    tK = Intrinsics.from_config(TCFG.camera)
    obj3d = np.full(I_DET, -1, np.int32)
    obj3d[0] = 1
    want = np.asarray(jobj.match_map_to_frame(jm, jf, jnp.asarray(obj3d),
                                              jK, 0.3, 0.1))
    got = npy(tobj.match_map_to_frame(tm, tf, t(obj3d), tK, 0.3, 0.1))
    assert np.array_equal(got, want)
    assert np.sum(want >= 0) >= 3


def test_assoc_impl_exact(assoc_case):
    jm, tm, jf, tf, jl, tl = assoc_case
    je, te = engines()
    want = np.asarray(jax.jit(je._assoc_impl)(jm, jf, jl))
    got = npy(te.assoc_impl(tm, tf, tl))
    assert np.array_equal(got, want)
    assert np.array_equal(npy(te.associate(tm, tf, tl).obj3d), want)


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_update_impl():
    m, fr, sl = cases.update(np.random.RandomState(6), I=I_DET, J=8,
                             P=1024, N=N_KP, Hc=HC)
    jm, tm = maps(m)
    jf, tf = frames(fr, sl)
    je, te = engines()
    jm2, jo = jax.jit(je._update_impl)(jm, jf)
    tm2, to = te.update_impl(tm, tf)
    assert np.array_equal(npy(to), np.asarray(jo))
    assert_maps(jm2, tm2)
    # the case exercises creation, rejection and the merge
    assert int(jm2.n_obj) > int(jm.n_obj)
    assert np.sum(np.asarray(jm2.pt_obj) != np.asarray(jm.pt_obj)) > 20
    assert np.any(np.asarray(jm2.obj_replaced) >= 0)


def test_cluster_reject_batched_exact():
    rng = np.random.RandomState(9)
    B, n = 3, 64
    pts = rng.normal(0, 0.05, (B, n, 3)).astype(np.float32)
    pts[:, :4] += 0.5                      # a small far cluster
    pts[:, 4:6] += rng.normal(0, 2, (B, 2, 3)).astype(np.float32)
    valid = rng.rand(B, n) < 0.9
    valid[2, 10:] = False                  # too few points to cluster
    cen = np.stack([pts[b][valid[b]].mean(0) for b in range(B)]).astype(
        np.float32)
    want = np.stack([np.asarray(jobj._cluster_reject(
        jnp.asarray(pts[b]), jnp.asarray(valid[b]), jnp.asarray(cen[b]),
        0.1)) for b in range(B)])
    got = npy(tobj._cluster_reject(t(pts), t(valid), t(cen), 0.1))
    assert np.array_equal(got, want)
    assert not want[:2, :4].any()


def test_regularize_exact():
    m = cases.regularize(np.random.RandomState(12), J=8)
    m["pt_obj"] = np.pad(m["pt_obj"], (0, 1024 - 512), constant_values=-1)
    jm, tm = maps(m)
    je, te = engines()
    want = je._regularize(jm)
    got = te._regularize(tm)
    assert_maps(want, got, fields=("pt_obj", "obj_valid", "obj_replaced"))
    assert np.any(np.asarray(want.obj_replaced) >= 0)


# ---------------------------------------------------------------------------
# semantic refinement
# ---------------------------------------------------------------------------

def test_semopt_from_a_jax_slab_through_interop():
    m_over, fr, sl, T_true, T0 = cases.semopt(np.random.RandomState(7))
    mask = sl.pop("mask")
    ft = np.asarray(jax.jit(jdt.feature_transform)(jnp.asarray(mask)))
    first = (np.arange(I_DET) == 0)
    sl.update(masks=np.where(first[:, None, None], mask[None], False),
              ftmap=np.where(first[:, None, None, None], ft[None], -1.0))
    jm, tm = maps(m_over, Hc=JCFG.objects.history_capacity)
    jf, _ = frames(fr, sl)
    # the port's frame carries the JAX slab, carried over by interop
    slab_np = {f: np.asarray(getattr(jf.obj, f))
               for f in jo2d.Object2DSlab._fields}
    tf = interop.frame_from_numpy(cases.frame_fields(I_DET, N_KP, **fr),
                                  TCFG, device="cpu", obj=slab_np)
    n = int(np.sum(fr["kp_pt"] >= 0))
    jres = JTrackResult(Tcw=jnp.asarray(T0), kp_pt=jf.kp_pt,
                        inlier=jf.kp_pt >= 0, n_matches=jnp.int32(n),
                        n_inliers=jnp.int32(n))
    tres = TrackResult(Tcw=t(T0), kp_pt=tf.kp_pt, inlier=tf.kp_pt >= 0,
                       n_matches=torch.tensor(n), n_inliers=torch.tensor(n))
    je, te = engines()
    jT, jkp, jinl, jn = jax.jit(je._semopt_impl)(jm, jf, jres)
    tT, tkp, tinl, tn = te.semopt_impl(tm, tf, tres)
    jT, tT = np.asarray(jT, np.float64), npy(tT).astype(np.float64)
    assert np.abs(tT[:3, 3] - jT[:3, 3]).max() < 1e-5
    # the small rotation between them: the skew part of Rt^T Rj
    Rd = tT[:3, :3].T @ jT[:3, :3]
    w = np.array([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0],
                  Rd[1, 0] - Rd[0, 1]]) / 2.0
    assert np.linalg.norm(w) < 1e-4
    assert np.array_equal(npy(tkp), np.asarray(jkp))
    assert np.array_equal(npy(tinl), np.asarray(jinl))
    assert int(tn) == int(jn) > 10
    # the case engages the optimizer: it moves the pose towards the truth
    assert np.linalg.norm(tT[:3, 3] - T_true[:3, 3]) < \
        np.linalg.norm(T0[:3, 3] - T_true[:3, 3])


def test_staged_semantic_local_map_matches_jax():
    """ObjectEngine.track_local_map_semantic (the staged path's local map
    with the object edges) live in both packages, on the inputs of one
    call of the JAX staged run (tests/torch_fixtures/pipelined.npz,
    make_reference.py pipelined): pose 1e-5 m / 1e-4 rad, matches and
    n_sem exact, the search's visible / found counters exact."""
    fx = np.load(os.path.join(os.path.dirname(__file__), "torch_fixtures",
                              "pipelined.npz"))
    sub = {k[len("semlocal."):]: fx[k] for k in fx.files
           if k.startswith("semlocal.")}
    m_np = {k[5:]: v for k, v in sub.items() if k.startswith("m_in.")}
    fr_np = {k[6:]: v for k, v in sub.items() if k.startswith("frame.")
             and not k.startswith("frame.obj.")}
    sl = {k[10:]: v for k, v in sub.items() if k.startswith("frame.obj.")}
    sl["masks"] = np.unpackbits(sl.pop("masks_packed"), axis=-1)[
        ..., :160].astype(bool)
    cam = dict(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
               dist=(0, 0, 0, 0, 0), bf=13.0, th_depth=40.0,
               depth_map_factor=1.0)
    caps = dict(n_kp=384, max_points=8192, max_keyframes=64)
    jcfg = JSlamConfig(camera=JCameraConfig(**cam),
                       caps=JCapacityConfig(**caps),
                       semantic=JSemanticConfig(mask_margin=3,
                                                min_kps_rgbd=4))
    tcfg = SlamConfig(camera=CameraConfig(**cam), caps=CapacityConfig(**caps),
                      semantic=SemanticConfig(mask_margin=3, min_kps_rgbd=4))
    jm = JMapState(**{k: jnp.asarray(v) for k, v in m_np.items()})
    jf = JFrameData(obj=jo2d.Object2DSlab(**{k: jnp.asarray(v)
                                            for k, v in sl.items()}),
                    **{k: jnp.asarray(v) for k, v in fr_np.items()})
    kp = sub["tr_kp_pt"]
    jtr = JTrackResult(Tcw=jnp.asarray(sub["tr_Tcw"]), kp_pt=jnp.asarray(kp),
                       inlier=jnp.asarray(kp >= 0),
                       n_matches=jnp.int32(sub["tr_n_matches"]),
                       n_inliers=jnp.int32(sub["tr_n_inliers"]))
    tm = interop.map_state_from_numpy(m_np, device="cpu")
    tf = interop.frame_from_numpy(fr_np, tcfg, device="cpu", obj=sl)
    ttr = TrackResult(Tcw=t(sub["tr_Tcw"]), kp_pt=t(kp), inlier=t(kp >= 0),
                      n_matches=torch.tensor(int(sub["tr_n_matches"])),
                      n_inliers=torch.tensor(int(sub["tr_n_inliers"])))
    je = jobj.ObjectEngine(jcfg, JIntrinsics.from_config(jcfg.camera))
    te = tobj.ObjectEngine(tcfg, Intrinsics.from_config(tcfg.camera),
                           device="cpu")
    assert bool(np.any(sub["frame.obj3d"] >= 0))
    (jres, jm2, jn, jpre) = jax.jit(je._semlocal_impl)(jm, jf, jtr)
    tres, tm2, tn, tpre = te.track_local_map_semantic(tm, tf, ttr)
    for a, b in ((tres.Tcw, jres.Tcw), (tpre, jpre)):
        a, b = npy(a).astype(np.float64), np.asarray(b, np.float64)
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < 1e-5
        Rd = a[:3, :3].T @ b[:3, :3]
        assert np.linalg.norm([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0],
                               Rd[1, 0] - Rd[0, 1]]) / 2.0 < 1e-4
    assert np.array_equal(npy(tres.kp_pt), np.asarray(jres.kp_pt))
    assert int(tres.n_inliers) == int(jres.n_inliers) > 30
    assert int(tres.n_matches) == int(jres.n_matches)
    assert int(tn) == int(jn) > 0
    assert_maps(jm2, tm2, fields=("pt_visible", "pt_found"))


def test_engine_defaults_to_the_card():
    """Without a device the engine resolves to the card: with none, it
    raises instead of building its tables on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tobj.ObjectEngine(TCFG, Intrinsics.from_config(TCFG.camera))
