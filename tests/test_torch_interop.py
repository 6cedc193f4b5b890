"""The port's copies and the state carried across packages: interop round
trips, config equality field for field, the BRIEF pattern file, and the
rule that no module of object_slam_tpu_torch imports JAX or the JAX
package."""

import ast
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

import object_slam_tpu.config as j_config
import object_slam_tpu_torch
import object_slam_tpu_torch.config as t_config
from object_slam_tpu.slam.map_state import MapState as JMapState
from object_slam_tpu.slam.map_state import init_map as j_init_map
from object_slam_tpu_torch import interop
from object_slam_tpu_torch.slam.map_state import MapState, init_map
from torch_fixtures.threads import share_cores

share_cores()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(object_slam_tpu_torch.__file__)
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "slice1.npz")


def _sub(fx, prefix):
    n = len(prefix) + 1
    return {k[n:]: fx[k] for k in fx.files if k.startswith(prefix + ".")}


def test_map_state_roundtrip_is_identity():
    m_np = _sub(np.load(FIXTURE), "mapping.m_out")
    back = interop.map_state_to_numpy(
        interop.map_state_from_numpy(m_np, device="cpu"))
    assert set(back) == set(JMapState._fields) == set(MapState._fields)
    for f in JMapState._fields:
        assert back[f].dtype == m_np[f].dtype, f
        assert back[f].shape == m_np[f].shape, f
        assert np.array_equal(back[f], m_np[f]), f


def test_descriptor_bits_preserved():
    d = np.array([[0xFFFFFFFF, 0x80000000, 1, 0, 0x7FFFFFFF, 5, 6, 7]],
                 np.uint32)
    kp = interop.keypoints_from_numpy(dict(
        uv=np.zeros((1, 2), np.float32), response=np.zeros(1, np.float32),
        angle=np.zeros(1, np.float32), level=np.zeros(1, np.int32), desc=d,
        valid=np.ones(1, bool)), device="cpu")
    assert kp.desc.dtype == torch.int32
    assert np.array_equal(kp.desc.numpy().view(np.uint32), d)


def test_init_map_matches_reference_layout():
    caps = dict(n_kp=64, max_points=256, max_keyframes=8, max_objects=4)
    jm = j_init_map(j_config.CapacityConfig(**caps), 16)
    tm = interop.map_state_to_numpy(
        init_map(t_config.CapacityConfig(**caps), 16))
    for f in JMapState._fields:
        a = np.asarray(getattr(jm, f))
        assert tm[f].shape == a.shape, f
        assert tm[f].dtype == a.dtype, f
        assert np.array_equal(tm[f], a), f


@pytest.mark.parametrize("name", ["SlamConfig", "tum_rgbd", "euroc_stereo",
                                  "kitti_stereo"])
def test_config_equal_field_for_field(name):
    def build(mod):
        cls = mod.SlamConfig
        return cls() if name == "SlamConfig" else getattr(cls, name)()

    assert dataclasses.asdict(build(t_config)) == \
        dataclasses.asdict(build(j_config))


def test_config_classes_have_the_same_fields():
    for cls_name in ("CameraConfig", "OrbConfig", "MatcherConfig",
                     "SemanticConfig", "ObjectConfig", "TrackingConfig",
                     "SolverConfig", "LoopConfig", "MappingConfig",
                     "CapacityConfig", "SlamConfig"):
        jf = [(f.name, f.type) for f in
              dataclasses.fields(getattr(j_config, cls_name))]
        tf = [(f.name, f.type) for f in
              dataclasses.fields(getattr(t_config, cls_name))]
        assert tf == jf, cls_name


def test_brief_pattern_byte_identical():
    def digest(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert digest(os.path.join(PKG, "features", "brief_pattern.npy")) == \
        digest(os.path.join(ROOT, "object_slam_tpu", "features",
                            "brief_pattern.npy"))


@pytest.mark.parametrize("convert", ["map_state_from_numpy",
                                     "keypoints_from_numpy",
                                     "slab_from_numpy", "frame_from_numpy"])
def test_converters_default_to_the_card(convert):
    """Without a device they resolve to the card: with none, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    args = ({},) if convert != "frame_from_numpy" else ({}, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(interop, convert)(*args)


def test_slab_and_frame_roundtrip_is_identity():
    from object_slam_tpu.semantic.object2d import empty_slab as j_empty
    from object_slam_tpu.slam.frame import FrameData as JFrameData
    fx = np.load(FIXTURE)
    fr = {k[len("fused.frame."):]: fx[k] for k in fx.files
          if k.startswith("fused.frame.")}
    slab = {f: np.array(v) for f, v in
            j_empty(16, 120, 160, fr["uv"].shape[0])._asdict().items()}
    slab["valid"][1] = True
    slab["ftmap"][1, 2, 3] = (4.0, 5.0)
    frame = interop.frame_from_numpy(fr, t_config.SlamConfig(),
                                     device="cpu", obj=slab)
    back = interop.frame_to_numpy(frame)
    assert set(back) == set(JFrameData._fields)
    for f, v in fr.items():
        assert back[f].dtype == v.dtype and np.array_equal(back[f], v), f
    for f, v in slab.items():
        assert back["obj"][f].dtype == v.dtype, f
        assert np.array_equal(back["obj"][f], v), f


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    for d, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(d, fn)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_never_imports_jax_or_the_reference_package():
    bad = []
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "object_slam_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad
    assert sum(1 for _ in _sources()) > 20
