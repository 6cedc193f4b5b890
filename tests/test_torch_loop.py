"""Loop closing of the PyTorch port against the JAX package on the CPU, on
the same seeded numpy inputs, module by module: the vocabulary (copy,
DBoW2 text IO, transform, L1 score), the keyframe database, Sim3 /
Horn, the Sim3 RANSAC with the reference's index sets and its
Gauss-Newton, the essential graph, global BA, and ``LoopCloser`` on the
port copy of tests/test_loop.py::make_loop_map (torch_fixtures/
loop_cases.py): verification, correction, each gate tripped on purpose,
and the consistency bookkeeping.

Tolerances, stated beside each check: integers and masks exact; BoW
values 1e-6 (f32 sums over 10^4 words in another order); Sim3 / Horn
1e-5; RANSAC inlier sets exact and the refined transform 1e-4; pose
graph and global BA 1e-4 m / 1e-4 rad; the closer's events to 1e-3
relative (their numbers are reductions over the whole map)."""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_slam_tpu.config import CapacityConfig as JCaps
from object_slam_tpu.config import LoopConfig as JLoopConfig
from object_slam_tpu.config import SlamConfig as JSlamConfig
from object_slam_tpu.geometry import camera as j_cam
from object_slam_tpu.geometry import horn as j_horn
from object_slam_tpu.geometry import sim3 as j_sim3
from object_slam_tpu.loop import kfdb as j_kfdb
from object_slam_tpu.loop import loop_closing as j_lc
from object_slam_tpu.loop import vocabulary as j_voc
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu.slam.map_state import init_map as j_init_map
from object_slam_tpu.solvers import ba as j_ba
from object_slam_tpu.solvers import pose_graph as j_pg
from object_slam_tpu.solvers import ransac as j_ransac
from object_slam_tpu.solvers import sim3_solver as j_ss
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.config import CapacityConfig, LoopConfig, SlamConfig
from object_slam_tpu_torch.geometry import camera as t_cam
from object_slam_tpu_torch.geometry import horn as t_horn
from object_slam_tpu_torch.geometry import sim3 as t_sim3
from object_slam_tpu_torch.loop import kfdb as t_kfdb
from object_slam_tpu_torch.loop import loop_closing as t_lc
from object_slam_tpu_torch.loop import vocabulary as t_voc
from object_slam_tpu_torch.solvers import ba as t_ba
from object_slam_tpu_torch.solvers import pose_graph as t_pg
from object_slam_tpu_torch.solvers import sim3_solver as t_ss
from torch_fixtures import loop_cases
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF_VOCAB = os.path.join(ROOT, "object_slam_tpu", "loop", "vocab_synth.txt")
PORT_VOCAB = os.path.join(ROOT, "object_slam_tpu_torch", "loop",
                          "vocab_synth.txt")


def _desc(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ti(d):
    """uint32 descriptors -> the port's int32 view."""
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


@pytest.fixture(scope="module")
def vocabs():
    return (j_voc.Vocabulary.load_dbow2_text(REF_VOCAB),
            t_voc.Vocabulary.load_dbow2_text(PORT_VOCAB))


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

def test_vocabulary_copy_is_byte_equal():
    """The port's vocab_synth.txt is the reference's, byte for byte."""
    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert sha(PORT_VOCAB) == sha(REF_VOCAB)


def test_load_dbow2_text_tables(vocabs):
    """Exact: every level's centers and the idf (f32) equal the
    reference's, and so does the content key."""
    jv, tv = vocabs
    assert (tv.branching, tv.depth, tv.n_words) == (10, 4, 10000)
    for cj, ct in zip(jv.centers, tv.centers_np):
        np.testing.assert_array_equal(np.asarray(cj), ct)
    np.testing.assert_array_equal(np.asarray(jv.idf), tv.idf_np)
    assert tv.content_key() == jv.content_key()


def test_vocabulary_from_numpy(vocabs):
    """interop.vocabulary_from_numpy on the reference's tables: the same
    content key and words (exact) as the port's own load."""
    jv, tv = vocabs
    v = interop.vocabulary_from_numpy([np.asarray(c) for c in jv.centers],
                                      np.asarray(jv.idf))
    assert v.content_key() == tv.content_key() == jv.content_key()
    d = _desc(np.random.RandomState(9), 64)
    ones = torch.ones(64, dtype=torch.bool)
    np.testing.assert_array_equal(v.transform(_ti(d), ones)[0].numpy(),
                                  tv.transform(_ti(d), ones)[0].numpy())


def _unbalanced(path):
    d = lambda v: " ".join([str(v)] * 32)  # noqa: E731
    lines = ["2 2 0 0", f"0 0 {d(1)} 0.0", f"0 1 {d(200)} 0.7",
             f"1 1 {d(2)} 0.5", f"1 1 {d(3)} 0.4"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_load_unbalanced_tree(tmp_path):
    """tests/test_loop.py's unbalanced tree (an early leaf): tables
    exact, and the early leaf's words as the reference's."""
    p = str(tmp_path / "voc.txt")
    _unbalanced(p)
    jv, tv = j_voc.Vocabulary.load_dbow2_text(p), \
        t_voc.Vocabulary.load_dbow2_text(p)
    for cj, ct in zip(jv.centers, tv.centers_np):
        np.testing.assert_array_equal(np.asarray(cj), ct)
    np.testing.assert_array_equal(np.asarray(jv.idf), tv.idf_np)
    for v, want in ((2, 0), (200, 2)):
        d = np.full((1, 32), v, np.uint8).view(np.uint32)
        w, _ = tv.transform(_ti(d), torch.ones(1, dtype=torch.bool))
        wj, _ = jv.transform(jnp.asarray(d), jnp.ones(1, bool))
        assert int(w[0]) == int(wj[0]) == want


@pytest.mark.parametrize("seed,n_valid", [(0, 1024), (1, 700), (2, 0)])
def test_transform(vocabs, seed, n_valid):
    """Words exact (first index on ties), bow within 1e-6."""
    jv, tv = vocabs
    rng = np.random.RandomState(seed)
    d = _desc(rng, 1024)
    d[::7] = d[3]                       # repeated descriptors, tied words
    valid = np.zeros(1024, bool)
    valid[rng.permutation(1024)[:n_valid]] = True
    wj, bj = jv.transform(jnp.asarray(d), jnp.asarray(valid))
    wt, bt = tv.transform(_ti(d), _t(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6,
                               rtol=0)


def test_save_load_roundtrip(tmp_path):
    """A trained tree written and read back by the port: the same words
    and bow (1e-6) as the reference's own round trip, and the files are
    equal."""
    rng = np.random.RandomState(4)
    pool = _desc(rng, 3000)
    tv = t_voc.Vocabulary.train(pool, branching=3, depth=3, seed=4)
    jv = j_voc.Vocabulary.train(pool, branching=3, depth=3, seed=4)
    for cj, ct in zip(jv.centers, tv.centers_np):
        np.testing.assert_array_equal(np.asarray(cj), ct)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tv.save_dbow2_text(pt)
    jv.save_dbow2_text(pj)
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    tv2 = t_voc.Vocabulary.load_dbow2_text(pt)
    d = _desc(rng, 120)
    ones = torch.ones(120, dtype=torch.bool)
    w1, b1 = tv.transform(_ti(d), ones)
    w2, b2 = tv2.transform(_ti(d), ones)
    np.testing.assert_array_equal(w1.numpy(), w2.numpy())
    np.testing.assert_allclose(b1.numpy(), b2.numpy(), atol=1e-6)


def test_l1_score(vocabs):
    """1e-6 against the reference; a row against itself scores 1."""
    jv, tv = vocabs
    rng = np.random.RandomState(5)
    rows = np.stack([np.asarray(jv.transform(
        jnp.asarray(_desc(rng, 400)), jnp.ones(400, bool))[1])
        for _ in range(4)])
    sj = np.asarray(j_voc.l1_score(jnp.asarray(rows), jnp.asarray(rows[0])))
    st = t_voc.l1_score(_t(rows), _t(rows[0])).numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    assert abs(st[0] - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# keyframe database
# ---------------------------------------------------------------------------

def _bows(seed, K=24, W=500):
    rng = np.random.RandomState(seed)
    b = rng.uniform(0, 1, (K, W)) * (rng.rand(K, W) < 0.1)
    b[5] = b[0]
    b[9] = b[0] * (rng.rand(W) < 0.8)
    b = (b / np.maximum(b.sum(-1, keepdims=True), 1e-9)).astype(np.float32)
    valid = rng.rand(K) < 0.9
    valid[[0, 5, 9]] = True
    covis = (rng.rand(K, K) < 0.2) * rng.randint(1, 200, (K, K))
    covis = np.triu(covis, 1)
    covis = (covis + covis.T).astype(np.int32)
    return b, valid, covis


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kfdb_functions(seed):
    """detect_loop_candidates, aggregate_group_scores and
    detect_reloc_candidates: masks exact, scores 1e-6."""
    b, valid, covis = _bows(seed)
    q = 0
    covis_row = covis[q] > 0
    cj, sj = j_kfdb.detect_loop_candidates(
        jnp.asarray(b), jnp.asarray(valid), jnp.asarray(b[q]), q,
        jnp.asarray(covis_row), 0.05)
    ct, st = t_kfdb.detect_loop_candidates(
        _t(b), _t(valid), _t(b[q]), q, _t(covis_row), 0.05)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    assert ct.numpy()[5]

    kj, gj = j_kfdb.aggregate_group_scores(cj, sj, jnp.asarray(covis))
    kt, gt = t_kfdb.aggregate_group_scores(ct, st, _t(covis))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)

    rj, rsj = j_kfdb.detect_reloc_candidates(jnp.asarray(b),
                                             jnp.asarray(valid),
                                             jnp.asarray(b[q]))
    rt, rst = t_kfdb.detect_reloc_candidates(_t(b), _t(valid), _t(b[q]))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(rst.numpy(), np.asarray(rsj), atol=1e-6)


# ---------------------------------------------------------------------------
# Sim3 and Horn
# ---------------------------------------------------------------------------

def _sim3s(rng, n):
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)),
                         rng.normal(0, 0.4, (n, 3)),
                         rng.normal(0, 0.2, (n, 1))], -1).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:6] = 1e-5
    return xi


def test_sim3_ops():
    """exp / log / compose / inverse / apply / retract: 1e-5."""
    rng = np.random.RandomState(0)
    xa, xb = _sim3s(rng, 16), _sim3s(rng, 16)
    Tj, sj = j_sim3.exp(jnp.asarray(xa))
    Tt, st = t_sim3.exp(_t(xa))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_allclose(t_sim3.log(Tt, st).numpy(),
                               np.asarray(j_sim3.log(Tj, sj)), atol=1e-5)
    Tbj, sbj = j_sim3.exp(jnp.asarray(xb))
    Tbt, sbt = t_sim3.exp(_t(xb))
    cj = j_sim3.compose(Tj, sj, Tbj, sbj)
    ct = t_sim3.compose(Tt, st, Tbt, sbt)
    np.testing.assert_allclose(ct[0].numpy(), np.asarray(cj[0]), atol=1e-5)
    np.testing.assert_allclose(ct[1].numpy(), np.asarray(cj[1]), rtol=1e-6)
    ij, it = j_sim3.inverse(Tj, sj), t_sim3.inverse(Tt, st)
    np.testing.assert_allclose(it[0].numpy(), np.asarray(ij[0]), atol=1e-5)
    np.testing.assert_allclose(it[1].numpy(), np.asarray(ij[1]), rtol=1e-6)
    p = rng.normal(0, 2, (16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_sim3.apply(Tt, st, _t(p)).numpy(),
        np.asarray(j_sim3.apply(Tj, sj, jnp.asarray(p))), atol=1e-5)
    np.testing.assert_allclose(
        t_sim3.error(Tt, st, Tbt, sbt).numpy(),
        np.asarray(j_sim3.error(Tj, sj, Tbj, sbj)), atol=2e-5)
    rj = j_sim3.retract(Tj, sj, jnp.asarray(xb) * 0.01)
    rt = t_sim3.retract(Tt, st, _t(xb) * 0.01)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), atol=1e-5)


def _pairs(rng, n, s=1.0, noise=0.0):
    xi = np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 0.3, 3), 0.0]
    T = np.asarray(j_sim3.exp(jnp.asarray(xi, jnp.float32))[0])
    p_src = rng.uniform([-2, -1.5, 2], [2, 1.5, 6], (n, 3)).astype(np.float32)
    p_dst = (s * p_src @ T[:3, :3].T + T[:3, 3]
             + rng.normal(0, noise, (n, 3))).astype(np.float32)
    return p_src, p_dst


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_align_batched_weighted(fix_scale):
    """Batched [8, 20] and weighted: T and s within 1e-5."""
    rng = np.random.RandomState(1)
    src, dst = zip(*[_pairs(rng, 20, s=1.3, noise=0.01) for _ in range(8)])
    src, dst = np.stack(src), np.stack(dst)
    w = (rng.rand(8, 20) < 0.7).astype(np.float32)
    for weights in (None, w):
        Tj, sj = j_horn.horn_align(jnp.asarray(src), jnp.asarray(dst),
                                   None if weights is None
                                   else jnp.asarray(weights), fix_scale)
        Tt, st = t_horn.horn_align(_t(src), _t(dst),
                                   None if weights is None else _t(weights),
                                   fix_scale)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


TUM = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
           bf=40.0, dist=(0.0,) * 5, width=640.0, height=480.0)
JK = j_cam.Intrinsics(**TUM)
TK = t_cam.Intrinsics(**TUM)


def _sim3_pairs(seed, n=300, out_frac=0.3):
    rng = np.random.RandomState(seed)
    p2, p1 = _pairs(rng, n, s=1.0, noise=0.002)
    bad = rng.rand(n) < out_frac
    p1[bad] += rng.normal(0, 0.5, (bad.sum(), 3)).astype(np.float32)
    valid = rng.rand(n) < 0.9
    return p1, p2, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_sim3_ransac_with_reference_sets(seed):
    """The reference's own index sets injected: the same winner inlier
    set (exact) and count; the refined T12 within 1e-4, s12 1e-5."""
    p1, p2, valid = _sim3_pairs(seed)
    key = jax.random.PRNGKey(seed)
    sets = np.asarray(j_ransac.sample_minimal_sets(
        key, p1.shape[0], jnp.asarray(valid), 256, 3))
    rj = j_ss.sim3_ransac(key, JK, jnp.asarray(p1), jnp.asarray(p2),
                          jnp.asarray(valid))
    rt = t_ss.sim3_ransac_sets(_t(sets), TK, _t(p1), _t(p2), _t(valid))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and bool(rt.ok)
    np.testing.assert_allclose(rt.T12.numpy(), np.asarray(rj.T12), atol=1e-4)
    np.testing.assert_allclose(float(rt.s12), float(rj.s12), rtol=1e-5)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_gn_refine(fix_scale):
    """From the RANSAC winner: the same inlier set (exact), T12 within
    1e-4, s12 within 1e-5; the Jacobian is torch.func.jacfwd."""
    p1, p2, valid = _sim3_pairs(3)
    key = jax.random.PRNGKey(3)
    rj = j_ss.sim3_ransac(key, JK, jnp.asarray(p1), jnp.asarray(p2),
                          jnp.asarray(valid), fix_scale=fix_scale)
    T0 = np.asarray(rj.T12)
    T0 = T0 @ np.asarray(j_sim3.exp(jnp.asarray(
        [0.01, -0.01, 0.02, 0.005, 0.0, -0.004, 0.0], jnp.float32))[0])
    gj = j_ss.sim3_gn_refine(JK, jnp.asarray(p1), jnp.asarray(p2),
                             rj.inliers, jnp.asarray(T0), rj.s12,
                             fix_scale=fix_scale)
    gt = t_ss.sim3_gn_refine(TK, _t(p1), _t(p2), _t(np.asarray(rj.inliers)),
                             _t(T0), torch.tensor(float(rj.s12)),
                             fix_scale=fix_scale)
    np.testing.assert_array_equal(gt[2].numpy(), np.asarray(gj[2]))
    assert int(gt[3]) == int(gj[3])
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj[0]), atol=1e-4)
    np.testing.assert_allclose(float(gt[1]), float(gj[1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# essential graph and global BA
# ---------------------------------------------------------------------------

def test_pose_graph_and_correct_points():
    """20 GN iterations on a drifted 6-vertex chain with a loop edge:
    poses within 1e-4 (m and rotation entries), s 1e-5; correct_points
    1e-4 m."""
    T0, s0, ei, ej, rel_T, rel_s, valid, fixed = loop_cases.pose_graph_case()
    pj = j_pg.PoseGraphProblem(
        T=jnp.asarray(T0), s=jnp.asarray(s0), fixed=jnp.asarray(fixed),
        ei=jnp.asarray(ei), ej=jnp.asarray(ej), rel_T=jnp.asarray(rel_T),
        rel_s=jnp.asarray(rel_s), valid=jnp.asarray(valid),
        weight=jnp.ones(len(ei)))
    pt = t_pg.PoseGraphProblem(
        T=_t(T0), s=_t(s0), fixed=_t(fixed), ei=_t(ei), ej=_t(ej),
        rel_T=_t(rel_T), rel_s=_t(rel_s), valid=_t(valid),
        weight=torch.ones(len(ei)))
    Tj, sj = j_pg.optimize_pose_graph(pj)
    Tt, st = t_pg.optimize_pose_graph(pt)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    # the loop pulled the drifted chain back toward its measurements
    assert np.abs(Tt.numpy() - T0).max() > 1e-3

    rng = np.random.RandomState(7)
    pts = rng.normal(0, 2, (50, 3)).astype(np.float32)
    ref = rng.randint(0, len(T0), 50).astype(np.int32)
    cj = j_pg.correct_points(jnp.asarray(pts), jnp.asarray(ref),
                             jnp.asarray(T0), jnp.asarray(s0), Tj, sj)
    ct = t_pg.correct_points(_t(pts), _t(ref), _t(T0), _t(s0), Tt, st)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)


def test_global_ba():
    """global_ba (segment-sum form, kf_fixed[0]) on a 5-keyframe seeded
    problem where every point has several observers: poses and points
    within 1e-4."""
    f = loop_cases.ba_case()
    pj = j_ba.BAProblem(**{k: jnp.asarray(v) for k, v in f.items()})
    pt = t_ba.BAProblem(**{k: _t(v) for k, v in f.items()})
    kj, xj = j_ba.global_ba(JK, pj, iters=10, block_n=64)
    kt, xt = t_ba.global_ba(TK, pt, iters=10, block_n=64)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    assert np.abs(kt.numpy() - f["kf_pose"]).max() > 1e-4


# ---------------------------------------------------------------------------
# LoopCloser on the port copy of make_loop_map
# ---------------------------------------------------------------------------

def _cfgs(**loop):
    caps = dict(n_kp=256, max_points=1024, max_keyframes=16)
    return (JSlamConfig(caps=JCaps(**caps), loop=JLoopConfig(**loop)),
            SlamConfig(caps=CapacityConfig(**caps), loop=LoopConfig(**loop)))


def _maps(jcfg):
    base = {f: np.asarray(v) for f, v in
            j_init_map(jcfg.caps)._asdict().items()}
    c = jcfg.camera
    # a 0.1 m drift: make_loop_map's 0.3 m over a 5-slot chain predicts a
    # bend of 1.2 edge lengths per edge, which the absolute pre-gate
    # (pregate_bend_frac_abs = 0.5) refuses in both packages
    fields, T_true, _ = loop_cases.loop_map(base, c.fx, c.fy, c.cx, c.cy,
                                            c.bf, drift=0.1)
    mj = JMapState(**{k: jnp.asarray(v) for k, v in fields.items()})
    mt = interop.map_state_from_numpy(fields, device="cpu")
    return mj, mt, T_true


@pytest.fixture(scope="module")
def closers():
    jcfg, tcfg = _cfgs()
    mj, mt, T_true = _maps(jcfg)
    jK = j_cam.Intrinsics.from_config(jcfg.camera)
    tK = t_cam.Intrinsics.from_config(tcfg.camera)
    jl = j_lc.LoopCloser(jcfg, jK, vocab=j_voc.Vocabulary.train_random(
        3, 2, seed=0, n_train=500))
    tl = t_lc.LoopCloser(tcfg, tK, vocab=t_voc.Vocabulary.train_random(
        3, 2, seed=0, n_train=500), device="cpu")
    # the reference's first Sim3 draw: PRNGKey(42) split once
    _, key = jax.random.split(jax.random.PRNGKey(42))
    _, _, mok = jl._jit_match_pairs(mj, jnp.int32(5), jnp.int32(0))
    sets = torch.from_numpy(np.array(j_ransac.sample_minimal_sets(
        key, mok.shape[0], mok, 256, 3)))
    tl._minimal_sets = lambda valid, n_trials=256: sets
    return jl, tl, mj, mt, T_true


@pytest.fixture(scope="module")
def sim3_results(closers):
    jl, tl, mj, mt, _ = closers
    rt = tl._compute_sim3(mt, 5, 0)
    rj = jl._compute_sim3(mj, 5, 0)
    return rj, rt


def test_compute_sim3(closers, sim3_results):
    """Match pairs exact; ok, inlier count exact; T12 within 1e-4; the
    corrected query pose within 5 cm / 0.05 rad of the true revisit (the
    reference test's check)."""
    jl, tl, mj, mt, T_true = closers
    pj = jl._jit_match_pairs(mj, jnp.int32(5), jnp.int32(0))
    pt = tl.match_pairs(mt, 5, 0)
    np.testing.assert_array_equal(pt[2].numpy(), np.asarray(pj[2]))
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj[0]), atol=1e-5)
    np.testing.assert_allclose(pt[1].numpy(), np.asarray(pj[1]), atol=1e-5)
    rj, rt = sim3_results
    assert rt[0] and rj[0]
    assert rt[3] == rj[3]
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=1e-4)
    Tq = rt[1].numpy() @ mt.kf_pose[0].numpy()
    d = Tq @ np.linalg.inv(T_true[0])
    assert np.abs(d[:3, 3]).max() < 0.05
    assert tl.guided_matches(mt, 5, 0, rt[1], rt[2]) == \
        jl._guided_matches(mj, 5, 0, rj[1], rj[2])


# the median edge bend is an arccos of f32 rotations near the identity:
# one f32 ulp in a rotation entry moves it by up to sqrt(2 * 6e-8) rad,
# 0.02 deg (the budget is 0.3 deg)
BEND_DEG_ATOL = 0.02


def _event_close(et, ej, rtol=1e-3, atol=1e-6):
    assert et.keys() - {"wall_ms"} == ej.keys() - {"wall_ms"}
    for k, v in ej.items():
        if k == "wall_ms":
            continue
        if isinstance(v, bool) or isinstance(v, int):
            assert et[k] == v, (k, et[k], v)
        elif k == "bend_deg":
            assert abs(et[k] - v) <= BEND_DEG_ATOL, (k, et[k], v)
        else:
            assert abs(et[k] - v) <= atol + rtol * abs(v), (k, et[k], v)


def test_correct_loop_accepted(closers, sim3_results):
    """The genuine drift is accepted by both, with equal events (1e-3
    relative); the corrected poses within 1e-4 of the reference's; the
    query's error to the truth halves (the reference test's check)."""
    jl, tl, mj, mt, T_true = closers
    rj, rt = sim3_results
    m2j, aj = jl._correct_loop(mj, 5, 0, rj[1], jnp.float32(rj[2]))
    m2t, at = tl._correct_loop(mt, 5, 0, rt[1], rt[2])
    assert aj and at
    _event_close(tl.events[-1], jl.events[-1])
    np.testing.assert_allclose(m2t.kf_pose.numpy(), np.asarray(m2j.kf_pose),
                               atol=1e-4)
    np.testing.assert_array_equal(m2t.kf_kp_pt.numpy(),
                                  np.asarray(m2j.kf_kp_pt))
    np.testing.assert_array_equal(m2t.pt_valid.numpy(),
                                  np.asarray(m2j.pt_valid))
    assert int(m2t.kf_loop_edge[5]) == 0
    before = np.linalg.norm((mt.kf_pose[5].numpy()
                             @ np.linalg.inv(T_true[0]))[:3, 3])
    after = np.linalg.norm((m2t.kf_pose[5].numpy()
                            @ np.linalg.inv(T_true[0]))[:3, 3])
    assert after < 0.5 * before


def _rot_y(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    R = np.eye(4, dtype=np.float32)
    R[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return R


@pytest.mark.parametrize("gate", ["pre_gate", "bend", "benefit"])
def test_gates_reject_as_reference(sim3_results, gate):
    """Each gate tripped on purpose rejects in both packages with equal
    events (1e-3 relative) and hands back the map unchanged:
    pre_gate: a Sim3 claiming a 30 deg correction (6 deg per edge over
    the 5-slot chain); bend: the measured Sim3 with the bend budgets at
    1e-9 and the pre-gate caps wide; benefit: a gate tolerance that no
    map meets."""
    rj, rt = sim3_results
    loop = {"pre_gate": {},
            "bend": dict(max_edge_bend_deg=1e-9, max_edge_bend_frac=1e-9,
                         pregate_bend_deg_abs=1e9,
                         pregate_bend_frac_abs=1e9),
            "benefit": dict(benefit_gate_tolerance=-0.999999,
                            benefit_gate_abs_floor=0.0)}[gate]
    jcfg, tcfg = _cfgs(**loop)
    mj, mt, _ = _maps(jcfg)
    jK = j_cam.Intrinsics.from_config(jcfg.camera)
    tK = t_cam.Intrinsics.from_config(tcfg.camera)
    v = (3, 2, 0, 500)
    jl = j_lc.LoopCloser(jcfg, jK, vocab=j_voc.Vocabulary.train_random(*v))
    tl = t_lc.LoopCloser(tcfg, tK, vocab=t_voc.Vocabulary.train_random(*v),
                         device="cpu")
    T12j, T12t = np.asarray(rj[1]), rt[1].numpy()
    if gate == "pre_gate":
        T12j, T12t = _rot_y(30.0) @ T12j, _rot_y(30.0) @ T12t
    m2j, aj = jl._correct_loop(mj, 5, 0, jnp.asarray(T12j),
                               jnp.float32(rj[2]))
    m2t, at = tl._correct_loop(mt, 5, 0, _t(T12t), rt[2])
    assert not aj and not at
    _event_close(tl.events[-1], jl.events[-1])
    assert tl.events[-1].get("pre_gated", False) == (gate == "pre_gate")
    assert m2t is mt
    ev = tl.events[-1]
    if gate == "bend":
        assert ev["bend_deg"] > ev["budget_deg"] \
            or ev["bend_frac"] > ev["budget_frac"]
    if gate == "benefit":
        assert ev["q_after"] > ev["q_before"] * 1e-6


def test_consistency_bookkeeping():
    """A scripted candidate sequence through on_keyframe (BoW, detection
    and Sim3 stubbed alike in both packages, every closure attempt
    rejected): the consistency groups, their counts, the attempts and the
    cooldown bookkeeping equal the reference's after every call."""
    jcfg, tcfg = _cfgs()
    jK = j_cam.Intrinsics.from_config(jcfg.camera)
    tK = t_cam.Intrinsics.from_config(tcfg.camera)
    v = (3, 2, 0, 500)
    jl = j_lc.LoopCloser(jcfg, jK, vocab=j_voc.Vocabulary.train_random(*v))
    tl = t_lc.LoopCloser(tcfg, tK, vocab=t_voc.Vocabulary.train_random(*v),
                         device="cpu")
    K = 16
    rng = np.random.RandomState(3)
    W = (rng.rand(K, K) < 0.25).astype(np.int32) * 30
    W = np.triu(W, 1)
    W = W + W.T
    script = [(10, [1]), (11, [1, 2]), (12, [2]), (13, [3]), (14, []),
              (15, [4, 7]), (16, [7]), (17, [8]), (18, [9]), (19, [12]),
              (20, [12, 1]), (21, [0])]
    attempts = {"j": [], "t": []}
    for kf, cands in script:
        mask = np.zeros(K, bool)
        mask[cands] = True
        jl._jit_bow = lambda m, k: m
        jl._jit_detect = lambda m, k, mask=mask: (jnp.asarray(mask),
                                                  jnp.asarray(W))
        tl.bow_row = lambda m, k: m
        tl.detect = lambda m, k, mask=mask: (_t(mask), _t(W))
        jl._compute_sim3 = lambda m, q, l: (
            attempts["j"].append((q, l)) or (True, None, None, 0))
        tl._compute_sim3 = lambda m, q, l: (
            attempts["t"].append((q, l)) or (True, None, None, 0))
        jl._correct_loop = lambda m, q, l, T, s: (m, False)
        tl._correct_loop = lambda m, q, l, T, s: (m, False)
        _, cj = jl.on_keyframe(None, kf)
        _, ct = tl.on_keyframe(None, kf)
        assert ct == cj
        sj = interop.loop_state_to_numpy(jl)
        st = interop.loop_state_to_numpy(tl)
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=f"{kf} {k}")
    assert attempts["t"] == attempts["j"] and attempts["t"]
    assert tl.n_loops_rejected == jl.n_loops_rejected >= 1
    assert tl.last_loop_kf == jl.last_loop_kf
    # the state round-trips through interop
    t2 = t_lc.LoopCloser(tcfg, tK, vocab=tl.vocab, device="cpu")
    interop.loop_state_from_numpy(t2, interop.loop_state_to_numpy(tl))
    assert t2.consistent_groups == tl.consistent_groups
