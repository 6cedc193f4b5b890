#!/usr/bin/env python
"""Where the port's stereo runs part from the JAX package's: one
local-mapping pass, stage by stage, on the same input in both packages,
and the JAX package's local BA against itself under a one-ulp change of
its input.

    python scripts/diag_stereo_ba_parity.py [--geometry small|kitti]
        [--frames 9] [--pass 3] [--trials 3]

Runs the JAX SlamSystem on the CPU (objects on, inline mapping, the
default fused pipelined path) over the street-canyon drive: ``small`` is
tests/torch_fixtures/street.py's 416x128 geometry on its 12-frame drive,
``kitti`` is SlamConfig.kitti_stereo() on chip_smoke.py's 24-frame drive.
It captures the input map of every mapping pass in the first --frames
frames. For pass --pass it runs the pass's stages (point culling,
triangulation, fusion, the windowed statistics refresh, local BA on the
abbreviated schedule) in both packages, each stage on the JAX stage's
output, and prints for each stage the fields that differ: the largest
absolute difference of a float field, the count of differing entries of
an integer one, and how far the port's local BA puts the keyframes from
the JAX BA's (largest translation). Then it runs the JAX local BA
--trials times with the
input points scaled by (1 + u), u uniform in +-6e-8 (at most one float32
ulp, seeded), and prints how far each trial moves the keyframe poses
(largest translation) and the points. Needs both packages; prints one
JSON line last.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def render(geometry, tc):
    """(frames [(gray_l u8, gray_r u8, sem_arrays)], port config)."""
    from object_slam_tpu_torch.datasets.synthetic import render_street
    if geometry == "kitti":
        cfg = tc.SlamConfig.kitti_stereo()
        return render_street(cfg, 24)[1], cfg
    from torch_fixtures import street
    cfg = street.stereo_cfg(tc)
    return render_street(cfg, 12)[1], cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=("small", "kitti"),
                    default="small")
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--pass", dest="pass_k", type=int, default=3)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import torch
    from object_slam_tpu import config as jc
    from object_slam_tpu.slam import local_mapping as jlm
    from object_slam_tpu.slam import map_ops as jmo
    from object_slam_tpu.slam.map_state import MapState as JMapState
    from object_slam_tpu.slam.system import SlamSystem as JSlamSystem
    from object_slam_tpu_torch import config as tc
    from object_slam_tpu_torch import interop
    from object_slam_tpu_torch.slam import local_mapping as tlm
    from object_slam_tpu_torch.slam import map_ops as tmo
    from object_slam_tpu_torch.slam.frame import FrameBuilder

    frames, tcfg = render(args.geometry, tc)
    if args.geometry == "kitti":
        jcfg = jc.SlamConfig.kitti_stereo()
    else:
        from torch_fixtures import street
        jcfg = street.stereo_cfg(jc)

    jsys = JSlamSystem(jcfg, enable_objects=True)
    captured = []
    for attr in ("_jit_mapping", "_jit_mapping_fast"):
        fn = getattr(jsys, attr)

        def wrap(m, kf, fn=fn):
            captured.append(({f: np.asarray(getattr(m, f))
                              for f in JMapState._fields}, int(kf)))
            return fn(m, kf)
        setattr(jsys, attr, wrap)
    for i, (gl, gr, sa) in enumerate(frames[:args.frames]):
        jsys.track_stereo(jnp.asarray(gl), jnp.asarray(gr), None, sa,
                          timestamp=i / 10.0)
    jsys.flush_mapping()
    m_in, kf = captured[args.pass_k]

    def J(d):
        return JMapState(**{f: jnp.asarray(v) for f, v in d.items()})

    def T(d):
        return interop.map_state_from_numpy(d, device="cpu")

    def npy(jm):
        return {f: np.asarray(getattr(jm, f)) for f in JMapState._fields}

    def diff(want, tm):
        got = interop.map_state_to_numpy(tm)
        out = {}
        for f, b in want.items():
            a = got[f]
            if a.dtype.kind == "f":
                e = float(np.max(np.abs(a - b))) if a.size else 0.0
                if e > 0:
                    out[f] = e
            elif not np.array_equal(a, b):
                out[f] = int(np.sum(a != b))
        return out

    tb = FrameBuilder(tcfg, device="cpu")
    jK, jsf, jis2 = jsys.K, jsys.scale_factors, jsys.inv_sigma2
    W_j = jlm.covisibility(J(m_in))[kf]
    W_t = tlm.covisibility(T(m_in))[kf]
    stages = {}
    j1 = npy(jmo.cull_points(J(m_in), jnp.int32(kf),
                             recency_scope=jcfg.mapping.cull_recency_scope))
    stages["cull_points"] = diff(j1, tmo.cull_points(
        T(m_in), kf, recency_scope=tcfg.mapping.cull_recency_scope))
    j2 = npy(jmo.triangulate_new_points(
        J(j1), jnp.int32(kf), n_neighbors=5, K=jK, inv_sigma2_lvl=jis2,
        scale_factors=jsf, W_row=W_j))
    stages["triangulate"] = diff(j2, tmo.triangulate_new_points(
        T(j1), kf, n_neighbors=5, K=tb.K, inv_sigma2_lvl=tb.inv_sigma2,
        scale_factors=tb.scale_factors, W_row=W_t))
    j3 = npy(jmo.fuse_into_neighbors(
        J(j2), jnp.int32(kf), n_neighbors=5, K=jK, scale_factors=jsf,
        inv_sigma2_lvl=jis2, W_row=W_j))
    stages["fuse"] = diff(j3, tmo.fuse_into_neighbors(
        T(j2), kf, n_neighbors=5, K=tb.K, scale_factors=tb.scale_factors,
        inv_sigma2_lvl=tb.inv_sigma2, W_row=W_t))
    Kcap = j3["kf_kp_pt"].shape[0]
    Wn = jnp.where(jnp.asarray(j3["kf_valid"]) & (jnp.arange(Kcap) != kf),
                   W_j, -1)
    nbrs = jax.lax.top_k(Wn, min(15, Kcap))[1]
    sel = jnp.concatenate([jnp.int32(kf)[None], nbrs])
    j4 = npy(jlm.recompute_point_stats_windowed(J(j3), sel,
                                                cap=jcfg.caps.local_pt_cap))
    stages["point_stats"] = diff(j4, tlm.recompute_point_stats_windowed(
        T(j3), torch.from_numpy(np.array(sel)).long(),
        cap=tcfg.caps.local_pt_cap))
    it1, it2 = jcfg.mapping.ba_abort_iters

    def j_ba(d):
        return npy(jlm.run_local_ba(
            m=J(d), K=jK, kf_id=jnp.int32(kf),
            window=jcfg.caps.local_window_kf, n_fixed=8,
            inv_sigma2_lvl=jis2, iters1=it1, iters2=it2,
            pt_cap=jcfg.caps.local_pt_cap, W_row=W_j,
            obs_cap=jcfg.caps.local_obs_per_kf))
    j5 = j_ba(j4)
    t5 = tlm.run_local_ba(
        m=T(j4), K=tb.K, kf_id=kf, window=tcfg.caps.local_window_kf,
        n_fixed=8, inv_sigma2_lvl=tb.inv_sigma2, iters1=it1, iters2=it2,
        pt_cap=tcfg.caps.local_pt_cap, W_row=W_t,
        obs_cap=tcfg.caps.local_obs_per_kf)
    stages["local_ba"] = diff(j5, t5)
    kv = j5["kf_valid"]
    port_move = float(np.max(np.linalg.norm(
        interop.map_state_to_numpy(t5)["kf_pose"][kv][:, :3, 3]
        - j5["kf_pose"][kv][:, :3, 3], axis=1)))
    for name, d in stages.items():
        print(f"pass {args.pass_k} (keyframe {kf}), {name}: the port against "
              f"the JAX package on the same input: {json.dumps(d)}",
              flush=True)

    rng = np.random.RandomState(0)
    trials = []
    for _ in range(args.trials):
        d = dict(j4)
        d["pt_xyz"] = (j4["pt_xyz"] * (1.0 + rng.uniform(
            -6e-8, 6e-8, j4["pt_xyz"].shape))).astype(np.float32)
        jt = j_ba(d)
        trials.append({
            "input_max_change": float(np.max(np.abs(d["pt_xyz"]
                                                    - j4["pt_xyz"]))),
            "kf_translation_max_move": float(np.max(np.abs(
                jt["kf_pose"][kv][:, :3, 3] - j5["kf_pose"][kv][:, :3, 3]))),
            "pt_xyz_max_move": float(np.max(np.abs(jt["pt_xyz"]
                                                   - j5["pt_xyz"])))})
        print(f"JAX local BA against itself, input points moved by at most "
              f"one ulp: {json.dumps(trials[-1])}", flush=True)
    print(json.dumps({"geometry": args.geometry, "pass": args.pass_k,
                      "keyframe": kf, "stages": stages,
                      "port_ba_kf_pose_max_diff": stages["local_ba"].get(
                          "kf_pose", 0.0),
                      "port_ba_kf_translation_max": port_move,
                      "jax_ulp_trials": trials}))


if __name__ == "__main__":
    main()
