#!/usr/bin/env python
"""Learn a decorrelated BRIEF test pattern (the rBRIEF construction) with
the PyTorch port, on the card.

The port's counterpart of scripts/train_brief_pattern.py, with its names
and decisions (Rublee et al., ICCV 2011, section 4.3):
  1. harvest_patches: ~50k oriented keypoint patches from synthetic rooms
     (6 scenes x 8 orbit poses at TUM VGA): per render the port's ORB
     extractor (one orb_describe launch), the pyramid and its blur, then
     ops/patch.py::extract_patches_levels (csrc/patch_extract.cu, the
     counterpart of the reference's one Pallas kernel; one launch for the
     render's keypoints over every level) at the keypoints' 32x32
     windows, and rotate_patches to the canonical orientation;
  2. candidate_positions: the 529 positions of the radius-13 disk; 80,000
     position pairs drawn from RandomState(1), canonicalized and made
     unique on the host (candidate_tests);
  3. select_tests: the bit matrix of every test over the corpus, built in
     blocks on the card and kept centred in f32 (bits_c, with the means;
     no second f32 copy), then the reference's greedy selection: tests in
     order of |mean - 0.5|, each accepted if its |correlation| with every
     chosen test stays below the threshold, the threshold relaxed by 0.05
     until 256 fill. The order is scanned on the host against a host copy
     of each test's largest |correlation| so far; a candidate under the
     threshold gets the exact check (one product against the chosen tests
     on the card), an accepted test one product against all tests and one
     readback.

Output: [256, 4] float32 rows (y1, x1, y2, x2) to --out (default: the
port's object_slam_tpu_torch/features/brief_pattern.npy), and the
reference's quality line (|mean - 0.5| avg, |corr| avg / p95).

Usage:
  python scripts/train_brief_pattern_torch.py [--out PATH]
      [--patches 50000] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

PATCH = 32
HALF = 15
RADIUS = 13          # tests stay inside the steering disk
GRID_STEP = 1        # candidate position granularity
N_TESTS = 256
N_CANDIDATES = 80000
THRESH0 = 0.2
THRESH_STEP = 0.05
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "object_slam_tpu_torch", "features",
                           "brief_pattern.npy")


def harvest_patches(n_target=50000, device=None, levels_out=None):
    """Oriented, blurred keypoint patches from synthetic renders: [n, 32,
    32] float64 on the device (the reference's blend is float64).
    levels_out: a list that gets (blurred levels, ys, xs, level slots,
    windows) of every extract_patches_levels call (checks hold the kernel
    to its plain version on the same inputs)."""
    import torch
    from object_slam_tpu_torch.config import SlamConfig
    from object_slam_tpu_torch.datasets.synthetic import (SyntheticScene,
                                                          orbit_poses)
    from object_slam_tpu_torch.features import pyramid as pyr_mod
    from object_slam_tpu_torch.features.extractor import OrbExtractor
    from object_slam_tpu_torch.ops.describe import HALF as XHALF
    from object_slam_tpu_torch.ops.patch import extract_patches_levels

    cfg = SlamConfig.tum_rgbd()
    # the reference's pyramid order on any device (no tracking follows)
    ex = OrbExtractor(cfg, device=device, pyramid_order="xla")
    dev = ex.device
    o = cfg.orb
    patches, total = [], 0
    for seed in range(6):
        scene = SyntheticScene.make(cfg, seed=seed, n_objects=2,
                                    plane_z=3.0 + 0.6 * seed)
        for T in orbit_poses(8, radius=0.5, step=0.05):
            gray = scene.render_rgbd(T)[0]
            img = torch.from_numpy(np.asarray(gray, np.float32)).to(dev)
            kp = ex(img)
            valid = kp.valid.cpu().numpy()
            uv = kp.uv.cpu().numpy()
            lvl = kp.level.cpu().numpy()
            ang = kp.angle.cpu().numpy()
            # blurred windows of every level in one call (level by level,
            # each level's keypoints in slab order), then rotated to
            # canonical
            levels = pyr_mod.build_pyramid(img, o.n_levels, o.scale_factor,
                                           "xla")
            sel = np.concatenate([np.nonzero(valid & (lvl == l))[0]
                                  for l in range(o.n_levels)])
            if sel.size == 0:
                continue
            # float32 / float32, as a level's uv over its Python-float
            # scale divides
            scale = np.asarray([o.scale_factor ** l
                                for l in range(o.n_levels)],
                               np.float32)[lvl[sel]]
            xs = np.round(uv[sel, 0] / scale).astype(np.int32)
            ys = np.round(uv[sel, 1] / scale).astype(np.int32)
            blurred = [pyr_mod.gaussian_blur(x).contiguous() for x in levels]
            ys_t = torch.from_numpy(ys - XHALF).to(dev)
            xs_t = torch.from_numpy(xs - XHALF).to(dev)
            lv_t = torch.from_numpy(lvl[sel].astype(np.int32)).to(dev)
            p = extract_patches_levels(blurred, ys_t, xs_t, lv_t)
            if levels_out is not None:
                levels_out.append((blurred, ys_t, xs_t, lv_t, p))
            patches.append(rotate_patches(p, -ang[sel]))
            total += p.shape[0]
            if total >= n_target:
                break
        if total >= n_target:
            break
    out = torch.cat(patches, 0)[:n_target]
    print(f"corpus: {out.shape[0]} patches", flush=True)
    return out


def rotate_patches(p, angles):
    """Bilinear rotation of [N, 32, 32] f32 patches (a tensor) about
    (HALF, HALF) by angles [N] (f32 numpy, radians), in the reference's
    arithmetic: the sample grid in f32 (cos / sin on the host, as numpy
    takes them), the blend in float64. Returns [N, 32, 32] float64."""
    import torch
    dev = p.device
    d = np.arange(PATCH, dtype=np.float32) - HALF
    gy, gx = (torch.from_numpy(g).to(dev)[None]
              for g in np.meshgrid(d, d, indexing="ij"))
    angles = np.asarray(angles, np.float32)
    c = torch.from_numpy(np.cos(angles)).to(dev)[:, None, None]
    s = torch.from_numpy(np.sin(angles)).to(dev)[:, None, None]
    sy = c * gy - s * gx + HALF
    sx = s * gy + c * gx + HALF
    y0 = torch.clamp(torch.floor(sy).to(torch.int32), 0, PATCH - 2)
    x0 = torch.clamp(torch.floor(sx).to(torch.int32), 0, PATCH - 2)
    fy = torch.clamp(sy.double() - y0.double(), 0.0, 1.0)
    fx = torch.clamp(sx.double() - x0.double(), 0.0, 1.0)
    y0, x0 = y0.long(), x0.long()
    ii = torch.arange(p.shape[0], device=dev)[:, None, None]
    pd = p.double()
    return (pd[ii, y0, x0] * (1 - fy) * (1 - fx)
            + pd[ii, y0, x0 + 1] * (1 - fy) * fx
            + pd[ii, y0 + 1, x0] * fy * (1 - fx)
            + pd[ii, y0 + 1, x0 + 1] * fy * fx)


def candidate_positions():
    d = np.arange(-RADIUS, RADIUS + 1, GRID_STEP)
    gy, gx = np.meshgrid(d, d, indexing="ij")
    keep = gy * gy + gx * gx <= RADIUS * RADIUS
    return np.stack([gy[keep], gx[keep]], -1)     # [M, 2]


def candidate_tests(n_positions, n_cand=N_CANDIDATES, seed=1):
    """The reference's candidate tests: n_cand position pairs drawn from
    RandomState(seed), same-position pairs dropped, canonicalized (lower
    index first) and made unique. Returns (ia, ib) [T]."""
    rng = np.random.RandomState(seed)
    ia = rng.randint(0, n_positions, n_cand * 2)
    ib = rng.randint(0, n_positions, n_cand * 2)
    keep = ia != ib
    ia, ib = ia[keep][:n_cand], ib[keep][:n_cand]
    pairs = np.stack([np.minimum(ia, ib), np.maximum(ia, ib)], -1)
    pairs = np.unique(pairs, axis=0)
    return pairs[:, 0], pairs[:, 1]


class TestSelector:
    """The candidate tests' centred bits over a corpus, on the corpus's
    device, and the reference's greedy selection over them.

    bits_c [T, n] f32 (bit - mean), mean [T] f32, norm [T] f32; the
    means and norms also on the host."""

    def __init__(self, patches, block=2048):
        import torch
        self.dev = patches.device
        self.pos = candidate_positions()
        self.ia, self.ib = candidate_tests(self.pos.shape[0])
        n = patches.shape[0]
        T = self.ia.shape[0]
        self.flat = patches.reshape(n, -1)
        self.pa = torch.from_numpy(
            (self.pos[self.ia][:, 0] + HALF) * PATCH
            + (self.pos[self.ia][:, 1] + HALF)).to(self.dev)
        self.pb = torch.from_numpy(
            (self.pos[self.ib][:, 0] + HALF) * PATCH
            + (self.pos[self.ib][:, 1] + HALF)).to(self.dev)
        self.bits_c = torch.empty((T, n), dtype=torch.float32,
                                  device=self.dev)
        mean = torch.empty(T, dtype=torch.float32, device=self.dev)
        ss = torch.empty(T, dtype=torch.float64, device=self.dev)
        for s in range(0, T, block):
            e = min(s + block, T)
            b = self.bits(torch.arange(s, e, device=self.dev))
            # 0/1 counts are exact; mean = count / n rounded once, as
            # numpy's f32 mean of 0/1 values (a tensor divisor: a scalar
            # one may become a multiplication by its reciprocal)
            cnt = b.sum(1).to(torch.float32)
            mean[s:e] = cnt / torch.full_like(cnt, n)
            self.bits_c[s:e] = b.to(torch.float32) - mean[s:e, None]
            ss[s:e] = (self.bits_c[s:e].double() ** 2).sum(1)
        self.mean = mean
        self.norm = torch.sqrt(ss.to(torch.float32)) + 1e-9
        self.mean_np = mean.cpu().numpy()
        self.norm_np = self.norm.cpu().numpy()
        self.n, self.T = n, T

    def bits(self, tests):
        """[len(tests), n] bool: flat[:, pa] < flat[:, pb]."""
        return (self.flat[:, self.pa[tests]]
                < self.flat[:, self.pb[tests]]).T

    def corr(self, tests, against):
        """|correlation| [len(tests), len(against)] f32 as the reference's
        exact check computes it (dot / (norm_t * norm_c))."""
        import torch
        t = torch.as_tensor(np.asarray(tests), device=self.dev).long()
        c = torch.as_tensor(np.asarray(against), device=self.dev).long()
        dots = self.bits_c[t] @ self.bits_c[c].T
        return torch.abs(dots / (self.norm[t][:, None]
                                 * self.norm[c][None, :])).cpu().numpy()

    def order(self):
        """The reference's scan order: np.argsort of |mean - 0.5| (numpy's
        default sort, whose order among equal keys is numpy's own)."""
        return np.argsort(np.abs(self.mean_np - 0.5))

    def select(self, n_tests=N_TESTS, thresh=THRESH0, order=None,
               log=print):
        """The reference's greedy selection over ``order`` (default:
        self.order()); returns (chosen test ids, the threshold each was
        accepted at)."""
        import torch
        if order is None:
            order = self.order()
        chosen, at = [], []
        max_corr = np.zeros(self.T, np.float32)
        alive = np.ones(self.T, bool)
        while len(chosen) < n_tests:
            progressed = False
            for t in order:
                if not alive[t] or max_corr[t] >= thresh:
                    continue
                # exact check against the chosen tests, newest first
                ok = True
                if chosen:
                    for r in self.corr([t], chosen[::-1])[0]:
                        max_corr[t] = max(max_corr[t], r)
                        if r >= thresh:
                            ok = False
                            break
                if not ok:
                    continue
                chosen.append(int(t))
                at.append(thresh)
                alive[t] = False
                # the bound against the new member, for every test
                r_all = torch.abs(self.bits_c @ self.bits_c[t]
                                  / (self.norm * self.norm[t]))
                max_corr = np.maximum(max_corr, r_all.cpu().numpy())
                max_corr[t] = 0
                progressed = True
                if len(chosen) >= n_tests:
                    break
            if len(chosen) < n_tests:
                thresh += THRESH_STEP
                log(f"relaxing correlation threshold -> {thresh:.2f} "
                    f"({len(chosen)} chosen)")
                if not progressed and thresh > 1.0:
                    raise RuntimeError("could not fill 256 tests")
        return np.asarray(chosen), np.asarray(at)

    def pattern(self, chosen):
        """[len(chosen), 4] f32 rows (y1, x1, y2, x2)."""
        return np.concatenate([self.pos[self.ia[chosen]],
                               self.pos[self.ib[chosen]]],
                              -1).astype(np.float32)

    def quality(self, chosen):
        """The reference's quality line: (|mean - 0.5| avg, |corr| avg,
        |corr| p95) of the chosen tests over the corpus."""
        import torch
        mm = np.abs(self.mean_np[chosen] - 0.5)
        rows = self.bits(torch.as_tensor(chosen, device=self.dev).long())
        cc = np.abs(np.corrcoef(rows.to(torch.float32).cpu().numpy()))
        np.fill_diagonal(cc, 0)
        return float(mm.mean()), float(cc.mean()), float(
            np.percentile(cc, 95))

    def pattern_tests(self, pattern):
        """The candidate test ids of a pattern's rows (-1 where a row is
        not a candidate test)."""
        ids = {(a, b): i for i, (a, b) in enumerate(zip(self.ia, self.ib))}
        index = {tuple(p): i for i, p in enumerate(self.pos.tolist())}
        out = []
        for y1, x1, y2, x2 in np.asarray(pattern).astype(int).tolist():
            a, b = index.get((y1, x1), -1), index.get((y2, x2), -1)
            out.append(ids.get((min(a, b), max(a, b)), -1))
        return np.asarray(out)


def select_tests(patches, n_tests=N_TESTS, log=print):
    """patches [n, 32, 32] (a tensor on the device the work runs on) ->
    (pattern [n_tests, 4] f32, (|mean - 0.5| avg, corr avg, corr p95))."""
    sel = TestSelector(patches)
    log(f"{sel.pos.shape[0]} positions -> "
        f"{sel.pos.shape[0] * (sel.pos.shape[0] - 1) // 2} possible tests; "
        f"{sel.T} candidate tests")
    chosen, _ = sel.select(n_tests, log=log)
    return sel.pattern(chosen), sel.quality(chosen)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--patches", type=int, default=50000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    import torch
    from object_slam_tpu_torch.device import resolve_device
    from object_slam_tpu_torch.ops import build
    device = resolve_device(args.device)
    if device.type == "cuda":
        build.load_all(["orb_describe", "patch_extract"])
    t0 = time.perf_counter()
    patches = harvest_patches(args.patches, device=device)
    t1 = time.perf_counter()
    pat, (mm, cc, p95) = select_tests(patches)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"learned: |mean-0.5| avg {mm:.3f}, corr avg {cc:.3f} / p95 "
          f"{p95:.3f} (harvest {t1 - t0:.1f} s, selection "
          f"{time.perf_counter() - t1:.1f} s)")
    np.save(args.out, pat)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
