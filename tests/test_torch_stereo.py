"""Stereo of the PyTorch port against the JAX package, live, on the CPU: the
renderer's stereo copies, match_stereo, the stereo frame build, and the
async mapper's merge. Inputs are numpy (seeded textures, the small street
canyon of tests/torch_fixtures/make_reference.py::stereo_cfg).

Tolerances: renders bit-equal; the best right match of each left keypoint
and ``ok`` exact; ``ur`` and ``depth`` within 1e-4 relative (the same
arithmetic in f32; on u8 images every SAD is an exact integer sum);
keypoints of the frame build as tests/test_torch_features.py holds them
(valid and level identical, uv 1e-3 px, angles 1e-4 rad, descriptors
exact where the angle bins agree); the Object2D slab as
tests/test_torch_objects.py holds it (integers exact, floats 1e-5); the
merge exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu import config as jc
from object_slam_tpu.datasets import synthetic as jsyn
from object_slam_tpu.features import extractor as j_ex
from object_slam_tpu.features import matching as j_match
from object_slam_tpu.features import stereo as j_stereo
from object_slam_tpu.semantic import object2d as jo2d
from object_slam_tpu.slam import system as jsys
from object_slam_tpu.slam.frame import FrameBuilder as JFrameBuilder
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu.slam.map_state import init_map as j_init_map
from object_slam_tpu_torch import config as tc
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.datasets import synthetic as tsyn
from object_slam_tpu_torch.features import extractor as t_ex
from object_slam_tpu_torch.features import stereo as t_stereo
from object_slam_tpu_torch.slam import system as tsys
from object_slam_tpu_torch.slam.frame import FrameBuilder
from torch_fixtures import street
from torch_fixtures.threads import share_cores

share_cores()


JCFG, TCFG = street.stereo_cfg(jc), street.stereo_cfg(tc)


def j_street(cfg, n_frames):
    """scripts/make_synth_kitti.py's street canyon, by the JAX package."""
    poses = jsyn.drive_trajectory(n_frames, speed=0.8)
    centers = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    scene = jsyn.SyntheticScene.make(
        cfg, seed=5, n_objects=6, plane_z=4.0, scale=8.0, n_structures=24,
        corridor_len=float(n_frames * 0.8 + 20.0), path=centers)
    for b in scene.boxes:
        b["label"] = 2
    return scene, poses


@pytest.fixture(scope="module")
def pair():
    """Frame 4 of the 12-frame drive (a car close enough to hold member
    keypoints) as u8 images, with its detection slab, rendered by the
    port."""
    scene, poses = tsyn.street_scene(TCFG, 12)
    gl, gr, _, _, sem = scene.render_stereo(poses[4])
    return (np.clip(gl, 0, 255).astype(np.uint8),
            np.clip(gr, 0, 255).astype(np.uint8),
            scene.sem_arrays(sem, TCFG.semantic.max_instances))


def test_stereo_renders_and_drive_bit_equal():
    js, jposes = j_street(JCFG, 12)
    ts, tposes = tsyn.street_scene(TCFG, 12)
    for a, b in zip(jposes, tposes):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = js.render_stereo(jposes[4])
    got = ts.render_stereo(tposes[4])
    for a, b in zip(want[:4], got[:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(want[4], got[4]):
        assert len(a) == len(b) >= 1
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _texture(seed, h=120, w=160):
    """Random 4x4 blocks (test_features.py's textured image, from numpy)."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, (h // 4, w // 4)).astype(np.float32)
    return np.repeat(np.repeat(img, 4, 0), 4, 1)


def _shift_case():
    """tests/test_features.py:165's case: the right image is the left one
    shifted by 8 px; bf 40, fx 500, min_z = 10 x bf / 500."""
    cfg = jc.SlamConfig(orb=jc.OrbConfig(n_features=200, n_levels=4),
                        caps=jc.CapacityConfig(n_kp=256))
    ex = j_ex.OrbExtractor(cfg, height=120, width=160)
    img_l = _texture(4)
    img_r = np.roll(img_l, (0, -8), axis=(0, 1))
    return ex, img_l, img_r, 40.0, 500.0, 40.0 / 500.0 * 10


def _pair_case(pair):
    gl, gr, _ = pair
    ex = j_ex.OrbExtractor(JCFG)
    K = JCFG.camera
    return (ex, gl.astype(np.float32), gr.astype(np.float32),
            float(np.float32(K.bf)), float(np.float32(K.fx)), K.baseline)


@pytest.fixture(scope="module", params=["shifted", "rendered"])
def stereo_case(request, pair):
    ex, img_l, img_r, bf, fx, min_z = (_shift_case() if request.param ==
                                       "shifted" else _pair_case(pair))
    kl = jax.tree_util.tree_map(np.asarray, ex(jnp.asarray(img_l)))
    kr = jax.tree_util.tree_map(np.asarray, ex(jnp.asarray(img_r)))
    sf = np.asarray(ex.scale_factors())
    jargs = [jnp.asarray(a) for a in (
        kl.uv, kl.level, kl.desc, kl.valid, kr.uv, kr.level, kr.desc,
        kr.valid, img_l, img_r, sf)]
    j_out = [np.asarray(a) for a in j_stereo.match_stereo(
        *jargs, bf, fx, min_z=min_z)]

    def t(a):
        a = np.array(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)
    targs = [t(a) for a in (kl.uv, kl.level, kl.desc, kl.valid, kr.uv,
                            kr.level, kr.desc, kr.valid, img_l, img_r, sf)]
    t_out = [a.numpy() for a in t_stereo.match_stereo(*targs, bf, fx,
                                                      min_z=min_z)]
    return dict(jargs=jargs, targs=targs, j=j_out, t=t_out,
                max_d=bf / min_z)


def test_match_stereo_ok_exact_and_depth_within_1e_4(stereo_case):
    (jur, jdepth, jok), (tur, tdepth, tok) = stereo_case["j"], \
        stereo_case["t"]
    assert np.array_equal(tok, jok)
    assert jok.sum() > 20
    np.testing.assert_allclose(tur, jur, rtol=1e-4, atol=0)
    np.testing.assert_allclose(tdepth, jdepth, rtol=1e-4, atol=0)


def test_match_stereo_best_matches_exact(stereo_case):
    """The best right keypoint of every left one and the Hamming gate,
    against the reference's mask and masked_best2 (stereo.py:44-55)."""
    (kl_uv, kl_lvl, kl_desc, kl_valid, kr_uv, kr_lvl, kr_desc, kr_valid,
     _, _, sf) = stereo_case["jargs"]
    max_d = stereo_case["max_d"]
    band = 2.0 * sf[kl_lvl]
    dv = jnp.abs(kl_uv[:, None, 1] - kr_uv[None, :, 1])
    disp = kl_uv[:, None, 0] - kr_uv[None, :, 0]
    lvl_ok = jnp.abs(kl_lvl[:, None] - kr_lvl[None, :]) <= 1
    mask = ((dv <= band[:, None]) & (disp > 0.1) & (disp < max_d)
            & lvl_ok & kl_valid[:, None] & kr_valid[None, :])
    j_idx, j_best, _ = j_match.masked_best2(
        j_match.hamming_matrix(kl_desc, kr_desc), mask)
    ta = stereo_case["targs"]
    t_idx, t_matched = t_stereo.stereo_candidates(*ta[:8], ta[10], max_d,
                                                  100)
    assert np.array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(t_matched.numpy(), np.asarray(j_best) <= 100)


@pytest.fixture(scope="module")
def built(pair):
    gl, gr, sa = pair
    jb = JFrameBuilder(JCFG)
    tb = FrameBuilder(TCFG, device="cpu")
    out = {}
    for name, rgb in (("gray_rig", None),
                      ("rgb", np.stack([gl] * 3, -1).astype(np.float32))):
        jf = jb.build_stereo(jnp.asarray(gl), jnp.asarray(gr),
                             None if rgb is None else jnp.asarray(rgb), sa,
                             0.9)
        tf = tb.build_stereo(gl, gr, rgb, sa, 0.9)
        out[name] = (jax.tree_util.tree_map(np.asarray, jf),
                     interop.frame_to_numpy(tf))
    return out


@pytest.mark.parametrize("rgb", ["gray_rig", "rgb"])
def test_build_stereo_keypoints(built, rgb):
    jf, tf = built[rgb]
    v = jf.valid
    assert np.array_equal(tf["valid"], v) and v.sum() > 200
    assert np.array_equal(tf["level"], jf.level)
    np.testing.assert_allclose(tf["uv_raw"][v], jf.uv_raw[v], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(tf["uv"][v], jf.uv[v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tf["angle"][v], jf.angle[v], atol=1e-4,
                               rtol=0)
    n_bins = t_ex.N_ANGLE_BINS

    def bins(a):
        return np.mod(np.round(a / (2 * np.pi) * n_bins).astype(np.int64),
                      n_bins)
    same = bins(tf["angle"]) == bins(jf.angle)
    assert same[v].mean() >= 0.995
    assert np.array_equal(tf["desc"][v & same], jf.desc[v & same])


@pytest.mark.parametrize("rgb", ["gray_rig", "rgb"])
def test_build_stereo_depth_and_ur(built, rgb):
    jf, tf = built[rgb]
    ok = jf.depth > 0
    assert np.array_equal(tf["depth"] > 0, ok) and ok.sum() > 100
    np.testing.assert_allclose(tf["depth"], jf.depth, rtol=1e-4, atol=0)
    np.testing.assert_allclose(tf["ur"], jf.ur, rtol=1e-4, atol=0)
    assert np.array_equal(tf["ur"] < 0, jf.ur < 0)


@pytest.mark.parametrize("rgb", ["gray_rig", "rgb"])
def test_build_stereo_object_slab(built, rgb):
    jf, tf = built[rgb]
    assert int(jf.obj.valid.sum()) >= 1
    for f in jo2d.Object2DSlab._fields:
        want, got = np.asarray(getattr(jf.obj, f)), tf["obj"][f]
        assert got.shape == want.shape, f
        if f in ("centroid_uv", "mean_depth", "prob", "bbox"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
        else:
            assert np.array_equal(got, want), f


def test_build_stereo_extracts_the_pair_in_one_call(pair, monkeypatch):
    """build_stereo extracts both images through OrbExtractor.extract_pair
    (one describe launch for the pair on the card), and the frame's
    keypoints are the ones two one-image extractions give (the path before
    the pair had one launch), bit for bit, the right image's too."""
    gl, gr, sa = pair
    tb = FrameBuilder(TCFG, device="cpu")
    seen = []
    orig = t_ex.OrbExtractor.extract_pair

    def spy(self, a, b):
        out = orig(self, a, b)
        seen.append(out)
        return out

    monkeypatch.setattr(t_ex.OrbExtractor, "extract_pair", spy)
    tf = interop.frame_to_numpy(tb.build_stereo(gl, gr, None, sa, 0.9))
    assert len(seen) == 1
    one_l = tb.extractor(tb._image(gl).contiguous())
    one_r = tb.extractor(tb._image(gr).contiguous())
    for got, want in zip(seen[0], (one_l, one_r)):
        for f in t_ex.Keypoints._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f, g in (("uv_raw", "uv"), ("level", "level"), ("angle", "angle"),
                 ("valid", "valid")):
        assert np.array_equal(tf[f], getattr(one_l, g).numpy()), f
    assert np.array_equal(tf["desc"].view(np.int32), one_l.desc.numpy())


def test_build_stereo_rgb_none_is_the_stacked_left_image(built):
    """A grayscale rig's frame equals the one built with the left image
    stacked three times as its rgb."""
    a, b = built["gray_rig"][1], built["rgb"][1]
    for f in ("uv", "ur", "depth", "desc", "valid"):
        assert np.array_equal(a[f], b[f]), f
    for f in a["obj"]:
        assert np.array_equal(a["obj"][f], b["obj"][f]), f


def _random_maps(seed):
    """Three seeded maps (result, live, snapshot) as reference fields."""
    caps = jc.CapacityConfig(max_points=512, max_keyframes=8, max_objects=8)
    init = {f: np.asarray(getattr(j_init_map(caps, 8), f))
            for f in JMapState._fields}
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        m = {k: v.copy() for k, v in init.items()}
        for f in ("pt_visible", "pt_found", "pt_label_tot", "pt_obj",
                  "obj_label", "obj_track_id", "obj_n_updates",
                  "obj_hist_n"):
            m[f] = rng.randint(-1, 50, m[f].shape).astype(m[f].dtype)
        m["pt_label_cnt"] = rng.randint(0, 9, m["pt_label_cnt"].shape) \
            .astype(np.int32)
        for f in ("pt_valid", "obj_valid", "obj_replaced"):
            m[f] = rng.rand(*m[f].shape) < 0.5
        for f in ("pt_xyz", "obj_centroid", "obj_bbox", "obj_center_ring",
                  "obj_hist_ring", "obj_campos_ring"):
            m[f] = rng.normal(size=m[f].shape).astype(m[f].dtype)
        m["n_obj"] = np.int32(rng.randint(0, 8))
        m["next_track_id"] = np.int32(rng.randint(0, 99))
        out.append(m)
    return out


def test_merge_impl_matches_jax():
    res, now, snap = _random_maps(3)
    jm = [JMapState(**{k: jnp.asarray(v) for k, v in d.items()})
          for d in (res, now, snap)]
    want = jsys._AsyncMapping._merge_impl(
        jm[0], jm[1], jm[2].pt_visible, jm[2].pt_found, jm[2].pt_label_cnt,
        jm[2].pt_label_tot)
    tm = [interop.map_state_from_numpy(d, device="cpu")
          for d in (res, now, snap)]
    got = interop.map_state_to_numpy(tsys._AsyncMapping._merge_impl(
        tm[0], tm[1], tm[2].pt_visible, tm[2].pt_found, tm[2].pt_label_cnt,
        tm[2].pt_label_tot))
    for f in JMapState._fields:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype and np.array_equal(got[f], w), f


class _Boom(RuntimeError):
    pass


def test_a_failed_mapping_pass_is_raised_not_swallowed():
    cfg = tc.SlamConfig.kitti_stereo().replace(
        caps=tc.CapacityConfig(n_kp=64, max_points=256, max_keyframes=8))
    sys_ = tsys.SlamSystem(cfg, enable_objects=False, async_mapping=True,
                           device="cpu")

    def fail(m, kf_id, fast):
        raise _Boom("mapping pass failed")
    sys_._async.run = fail
    for check in (lambda: sys_._async.ready(),
                  lambda: sys_._async.merge(sys_.map),
                  sys_.flush_mapping):
        sys_._async.dispatch(sys_.map, 0, False)
        sys_._async.pending[0].exception(timeout=30)
        with pytest.raises(_Boom):
            check()
        sys_._async.pending = None
    sys_._async.dispatch(sys_.map, 0, False)
    with pytest.raises(RuntimeError, match="already in flight"):
        sys_._async.dispatch(sys_.map, 0, False)
    with pytest.raises(_Boom):
        sys_.reset()
    sys_.shutdown()
