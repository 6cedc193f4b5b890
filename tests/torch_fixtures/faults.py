"""Faults planted in the port, each of which a check must catch: in the
sharded BA (tests/test_torch_parallel.py, chip_smoke.py; each a rank
setup function for parallel/sharded_ba.py::spawn_sharded_global_ba,
module level so that a spawned rank can import it), and in the accuracy
studies (tests/test_torch_studies*.py, chip_smoke.py)."""


def skip_point_reduce(rank: int, world: int):
    """Rank 1 keeps its own per-point partial sums: it still joins every
    all-reduce (so the collectives stay in step) but discards the reduced
    per-point part."""
    if rank != 1:
        return
    from object_slam_tpu_torch.parallel import sharded_ba
    reduce = sharded_ba.ObsShard.reduce

    def partial(self, kf=(), pt=(), cost=()):
        k, _, c = reduce(self, kf=kf, pt=pt, cost=cost)
        return k, [p.clone() for p in pt], c
    sharded_ba.ObsShard.reduce = partial


def ignore_reelect_flag(cfg):
    """The mapping ignores cfg.mapping.reelect_descriptors: the
    configuration a no_reelect run then runs under (the flag at its
    default, descriptors re-elected)."""
    import dataclasses
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, reelect_descriptors=True))


def disable_pre_gate(lc):
    """A LoopCloser whose pre-gate never refuses: every verified candidate
    runs the full speculative correction and meets the post-gates only."""
    pre_gate = lc.pre_gate

    def never(m, q, l, T12):
        return dict(pre_gate(m, q, l, T12), pre_gated=False)
    lc.pre_gate = never
    return lc


def skip_semantic_refinement():
    """The semantic refinement hands back the pose it was given, with its
    edges, inliers and constraint count as before (ObjectEngine.semopt_impl
    patched on the class, for the systems made after the call). Returns
    the function that undoes the patch."""
    from object_slam_tpu_torch.slam.objects import ObjectEngine
    semopt_impl = ObjectEngine.semopt_impl

    def unchanged(self, m, frame, res):
        _, kp_pt, inlier, n_sem = semopt_impl(self, m, frame, res)
        return res.Tcw, kp_pt, inlier, n_sem
    ObjectEngine.semopt_impl = unchanged
    return lambda: setattr(ObjectEngine, "semopt_impl", semopt_impl)
