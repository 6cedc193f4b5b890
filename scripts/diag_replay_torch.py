#!/usr/bin/env python
"""Replay a dumped frame's pose optimization offline with the PyTorch port
(the counterpart of scripts/diag_replay.py).

Reads a dump written by scripts/diag_retention_torch.py (or by the
reference's scripts/diag_retention.py: the same keys) and runs
pose_optimize on the frame's motion-model and local-map matches from
three initial poses (the prediction, the local result, the ground
truth): each run's match count, the share of matches more than 3 px from
their map point's ground-truth projection, the error before and after,
the inlier count, the matched keypoints' spread and their levels. Then
the recorded errors and the robust cost at the solutions found from the
prediction and from the ground truth, and at the ground truth itself.
Runs on the CUDA card unless given --device cpu.

Usage: python scripts/diag_replay_torch.py DUMP.npz [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

CHI2_MONO, CHI2_STEREO = 5.991, 7.815


def level_weights(cfg):
    """[n_levels] float32 inverse level variances (1 / scale^2l)."""
    sf = np.asarray([cfg.orb.scale_factor ** l
                     for l in range(cfg.orb.n_levels)])
    return (1.0 / (sf * sf)).astype(np.float32)


def load_dump(dump):
    """A dump path or a mapping of its arrays -> {key: numpy array}."""
    if isinstance(dump, (str, os.PathLike)):
        with np.load(dump) as f:
            return {k: f[k] for k in f.files}
    return {k: np.asarray(v) for k, v in dict(dump).items()}


def pose_obs(d, kp_pt, inv_sigma2_lvl, dev):
    """The pose problem of a dump's matches kp_pt, on dev."""
    import torch
    from object_slam_tpu_torch.solvers.pose_opt import PoseObs
    matched = (kp_pt >= 0) & d["valid"]
    P = d["pt_xyz"].shape[0]
    ptc = np.clip(kp_pt, 0, P - 1)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    obs = PoseObs(
        uv=t(d["uv"].astype(np.float32)),
        ur=t(np.where(matched, d["ur"], -1.0).astype(np.float32)),
        pw=t(d["pt_xyz"][ptc].astype(np.float32)),
        inv_sigma2=t(inv_sigma2_lvl[np.clip(d["level"], 0, 7)]),
        valid=t(matched))
    return obs, matched, ptc


def run(dump, cfg=None, device=None, log=print):
    """The replays, the recorded errors, the two basins and the costs of
    one dump, as a dict (the printed lines' numbers at full precision)."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.geometry.camera import Intrinsics
    from object_slam_tpu_torch.solvers import pose_opt as po

    dev = resolve_device(device)
    cfg = cfg or SlamConfig.tum_rgbd()
    K = Intrinsics.from_config(cfg.camera)
    inv_sigma2_lvl = level_weights(cfg)
    d = load_dump(dump)
    T_gt = d["T_gt"]

    def replay(kp_pt, T0, label):
        obs, matched, ptc = pose_obs(d, kp_pt, inv_sigma2_lvl, dev)
        Tcw, _, n_inl = po.pose_optimize(
            K, torch.from_numpy(np.asarray(T0, np.float32)).to(dev), obs)
        Tcw = Tcw.cpu().numpy()
        err0 = np.linalg.norm(T0[:3, 3] - T_gt[:3, 3]) * 1000
        err = np.linalg.norm(Tcw[:3, 3] - T_gt[:3, 3]) * 1000
        # match correctness + spatial spread
        pw = d["pt_xyz"][ptc[matched]]
        pc = (T_gt[:3, :3] @ pw.T).T + T_gt[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = float(K.fx) * pc[:, 0] / z + float(K.cx)
        v = float(K.fy) * pc[:, 1] / z + float(K.cy)
        kp = d["uv"][matched]
        dd = np.hypot(u - kp[:, 0], v - kp[:, 1])
        lv = d["level"][matched]
        r = {"n": int(matched.sum()), "wrong": float((dd > 3).mean() * 100),
             "err0_mm": float(err0), "err_mm": float(err),
             "n_inl": int(n_inl),
             "spread": [float(kp[:, 0].std()), float(kp[:, 1].std())],
             "levels": [float(np.median(lv)), float(np.percentile(lv, 90))]}
        log(f"{label}: n={r['n']:4d} wrong={r['wrong']:4.1f}% "
            f"err {err0:7.1f} -> {err:7.1f}mm  n_inl={r['n_inl']:4d}  "
            f"uv-spread=({r['spread'][0]:.0f},{r['spread'][1]:.0f})px "
            f"levels p50={r['levels'][0]:.0f} p90={r['levels'][1]:.0f}")
        return r, Tcw

    def cost(kp_pt, T):
        matched = (kp_pt >= 0) & d["valid"]
        P = d["pt_xyz"].shape[0]
        ptc = np.clip(kp_pt, 0, P - 1)
        pw = d["pt_xyz"][ptc]
        pc = (T[:3, :3] @ pw.T).T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = float(K.fx) * pc[:, 0] / z + float(K.cx)
        v = float(K.fy) * pc[:, 1] / z + float(K.cy)
        urp = u - float(K.bf) / z
        ru = d["uv"][:, 0] - u
        rv = d["uv"][:, 1] - v
        rr = np.where(d["ur"] >= 0, d["ur"] - urp, 0.0)
        isig = inv_sigma2_lvl[np.clip(d["level"], 0, 7)]
        chi2 = (ru * ru + rv * rv + rr * rr) * isig
        # Huber rho
        delta2 = np.where(d["ur"] >= 0, CHI2_STEREO, CHI2_MONO)
        rho = np.where(chi2 <= delta2, chi2,
                       2 * np.sqrt(delta2 * np.maximum(chi2, 1e-12))
                       - delta2)
        rho = np.where(matched, rho, 0.0)
        n = matched.sum()
        c = {"cost": float(rho.sum()), "mean": float(rho.sum() / n),
             "median_chi2": float(np.median(chi2[matched])), "n": int(n)}
        log(f"  cost={c['cost']:10.1f} mean={c['mean']:6.3f} "
            f"medianchi2={c['median_chi2']:6.3f} n={n}")
        return c

    out = {}
    for name, label, T0 in (("T_pred", "from T_pred", d["T_pred"]),
                            ("Tcw_local", "from Tcw_local", d["Tcw_local"]),
                            ("T_gt", "from T_gt  ",
                             T_gt.astype(np.float32))):
        log(f"--- init {label} ---")
        out[f"init_{name}"] = {
            "motion": replay(d["kp_pt_motion"], T0, "motion-matches")[0],
            "local": replay(d["kp_pt_local"], T0, "local-matches ")[0]}
    out["recorded"] = {
        "motion_err_mm": float(np.linalg.norm(
            d["Tcw_motion"][:3, 3] - T_gt[:3, 3]) * 1000),
        "local_err_mm": float(np.linalg.norm(
            d["Tcw_local"][:3, 3] - T_gt[:3, 3]) * 1000),
        "T_pred_err_mm": float(np.linalg.norm(
            d["T_pred"][:3, 3] - T_gt[:3, 3]) * 1000)}
    log("recorded: Tcw_motion err = {:.1f}mm, Tcw_local err = {:.1f}mm"
        .format(out["recorded"]["motion_err_mm"],
                out["recorded"]["local_err_mm"]))
    log("T_pred err = {:.1f}mm".format(out["recorded"]["T_pred_err_mm"]))
    out["wrong_basin"], T_wrong = replay(d["kp_pt_local"], d["T_pred"],
                                         "wrong-basin  ")
    out["right_basin"], T_right = replay(d["kp_pt_local"],
                                         T_gt.astype(np.float32),
                                         "right-basin  ")
    log("cost at wrong solution:")
    out["cost_wrong"] = cost(d["kp_pt_local"], T_wrong)
    log("cost at right solution:")
    out["cost_right"] = cost(d["kp_pt_local"], T_right)
    log("cost at exact GT      :")
    out["cost_gt"] = cost(d["kp_pt_local"], T_gt)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dump", help="a frame dump (OSLAM_DUMP's fNNN.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.dump, device=args.device,
               log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
