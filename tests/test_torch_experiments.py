"""scripts/run_experiments_torch.py against scripts/run_experiments.py on
the CPU: run_tum_variant (objects on and off) on a 4-frame directory of
scripts/make_synth_tum_torch.py and run_kitti (inline mapping) on a
3-frame one of make_synth_kitti_torch.py, against the reference's
functions on the reference generators' directories (the same files:
tests/test_torch_tools_data.py), recorded in
tests/torch_fixtures/experiments_tiny.npz (make_reference.py
experiments_tiny). Then the variant list and the result keys.

Tolerances: tracked flags, keyframe frames and counts, the object count
equal; map points and semantic constraints within 10% (the object
layer's counts; chip_smoke.py's band); KITTI's ATE and RPE within 1 mm +
1% (the street canyon's scale-8 local BA moves keyframes by millimetres
under one float32 ulp, tests/test_torch_kitti.py; the 3-frame drive's ATE
reads 284 mm)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures",
                       "experiments_tiny.npz")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import run_experiments_torch as rex  # noqa: E402


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    env = dict(os.environ, OMP_NUM_THREADS=str(share_cores()))
    for script, sub, n in (("make_synth_tum_torch", "tum", 4),
                           ("make_synth_kitti_torch", "kitti", 3)):
        subprocess.run([sys.executable, os.path.join(
            ROOT, "scripts", script + ".py"), "--out", str(root / sub),
            "--frames", str(n)], check=True, env=env, capture_output=True,
            timeout=600)
    return str(root / "tum"), str(root / "kitti")


def _held(name, res, systems):
    fx = np.load(FIXTURE)
    want = json.loads(str(fx[f"{name}.json"]))
    s = systems[-1]
    assert [r.tracked for r in s.trajectory] == fx[f"{name}.tracked"].tolist()
    kv = s.map.kf_valid.numpy()
    assert s.map.kf_frame_id.numpy()[kv].tolist() == \
        fx[f"{name}.kf_frames"].tolist()
    assert set(res) == set(want), (set(res) ^ set(want))
    for k in ("frames", "tracked", "keyframes", "objects"):
        if k in want:
            assert res[k] == want[k], (k, res[k], want[k])
    for k in ("points", "semantic_constraints"):
        if k in want:
            assert abs(res[k] - want[k]) <= 0.1 * want[k], (k, res[k],
                                                           want[k])
    return want


@pytest.mark.parametrize("name", ["t200_a", "t200_noobj_sync"])
def test_run_tum_variant_matches_reference(dirs, name):
    from object_slam_tpu_torch.config import SlamConfig
    cfg = SlamConfig.tum_rgbd()
    metas, frames = rex.load_tum_frames(dirs[0], cfg)
    assert len(frames) == 4 and frames[0][0].dtype == np.uint8
    assert frames[0][1].dtype == np.uint16
    variants = {n: (c, kw) for n, c, kw in rex.tum_variants(cfg)}
    vcfg, kw = variants[name]
    systems = []
    res = rex.run_tum_variant(dirs[0], vcfg, frames, metas, device="cpu",
                              systems=systems, **kw)
    _held(name, res, systems)


def test_run_kitti_matches_reference(dirs):
    systems = []
    res = rex.run_kitti(dirs[1], device="cpu", prewarm=0, systems=systems)
    want = _held("kitti", res, systems)
    for k, v in want.items():
        if k == "ate_rmse" or k.startswith("rpe_"):
            assert abs(res[k] - v) <= 1e-3 + 1e-2 * abs(v), (k, res[k], v)


def test_variant_list_is_the_reference_list():
    from object_slam_tpu_torch.config import SlamConfig
    cfg = SlamConfig.tum_rgbd()
    v = rex.tum_variants(cfg)
    assert [n for n, _, _ in v] == ["t200_a", "t200_b", "t200_noobj_sync",
                                    "t200_semopt_off", "t200_async",
                                    "t200_loop"]
    semoff = dict((n, c) for n, c, _ in v)["t200_semopt_off"]
    assert semoff.objects.semopt_enabled is False
    assert cfg.objects.semopt_enabled is True
    kws = dict((n, kw) for n, _, kw in v)
    assert kws["t200_async"]["async_mapping"] is True
    assert kws["t200_loop"]["enable_loop"] is True
    assert kws["t200_noobj_sync"]["enable_objects"] is False
