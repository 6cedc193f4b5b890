"""Faults planted in the port, each of which a check must catch: in the
sharded BA (tests/test_torch_parallel.py, chip_smoke.py; each a rank
setup function for parallel/sharded_ba.py::spawn_sharded_global_ba,
module level so that a spawned rank can import it), in the accuracy
studies (tests/test_torch_studies*.py, chip_smoke.py) and in the
retention probes (tests/test_torch_probes*.py, chip_smoke.py), in the
stage timers (tests/test_torch_stages.py, chip_smoke.py) and in the
multi-device scripts (tests/test_torch_multidevice.py, chip_smoke.py)."""


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


def exchange_pose_gates():
    """The pose optimization's chi2 gates exchanged (5.991 for stereo
    edges, 7.815 for mono), in pose_optimize's defaults and in every LM
    step: the pose-solver probes' fault. Returns the function that undoes
    the patch."""
    from object_slam_tpu_torch.solvers import pose_opt
    optimize, step = pose_opt.pose_optimize, pose_opt._lm_step

    def swapped(K, Tcw0, obs, rounds=4, iters_per_round=10,
                chi2_mono=5.991, chi2_stereo=7.815, damping=1e-3):
        return optimize(K, Tcw0, obs, rounds, iters_per_round,
                        chi2_stereo, chi2_mono, damping)

    def step_swapped(K, Tcw, lam, obs, active, chi2_mono, chi2_stereo):
        return step(K, Tcw, lam, obs, active, chi2_stereo, chi2_mono)
    pose_opt.pose_optimize, pose_opt._lm_step = swapped, step_swapped

    def undo():
        pose_opt.pose_optimize, pose_opt._lm_step = optimize, step
    return undo


def motion_snapshot_is_local(sys_):
    """SlamSystem.debug_last["tr_motion"] handed the local-map result (an
    on_system hook of the retention probe): the TUM retention probes'
    fault, visible wherever the two results differ (the staged and
    localization paths)."""
    staged = sys_._track_staged

    def wrapped(frame):
        out = staged(frame)
        dbg = sys_.debug_last
        if dbg is not None:
            sys_.debug_last = dict(dbg, tr_motion=dbg["tr_local"])
        return out
    sys_._track_staged = wrapped
    return sys_


def symmetric_motion_level_window():
    """The motion search's level window made +-1 under forward motion too
    (slam/tracking.py::_motion_level_bounds; the reference searches
    levels >= last - 1 one-sidedly going forward): the KITTI retention
    probes' fault. Returns the function that undoes the patch."""
    import torch
    from object_slam_tpu_torch.slam import tracking
    bounds = tracking._motion_level_bounds

    def symmetric(K, T_pred, T_last, last_level, n_levels):
        if T_last is None:
            return None, None
        return ((last_level - 1).to(torch.int32),
                (last_level + 1).to(torch.int32))
    tracking._motion_level_bounds = symmetric
    return lambda: setattr(tracking, "_motion_level_bounds", bounds)


def scatter_points_over_keyframes():
    """ba_iterate's scatter form sums the per-point terms over obs_kf
    instead of obs_pt (solvers/ba.py::_scatter_rows): the BA profile's
    fault. Returns the function that undoes the patch."""
    from object_slam_tpu_torch.solvers import ba
    rows = ba._scatter_rows

    def over_keyframes(prob):
        kf, _ = rows(prob)
        return kf, kf
    ba._scatter_rows = over_keyframes
    return lambda: setattr(ba, "_scatter_rows", rows)


def stage_map_before_last_frame(n_frames: int):
    """The KITTI stage timer's fault: its stages run on the map from before
    the n_frames-th track_stereo call. Returns (hook, swap): hook, an
    on_system hook for diag_kitti_stages_torch.drive that keeps a copy of
    the map before that call (the drive itself unchanged); swap(state),
    the drive's state with its map replaced by that copy."""
    kept = {}

    def hook(sys_):
        track = sys_.track_stereo
        calls = []

        def wrapped(*a, **kw):
            calls.append(None)
            if len(calls) == n_frames:
                kept["map"] = type(sys_.map)(*[t.clone() for t in sys_.map])
            return track(*a, **kw)
        sys_.track_stereo = wrapped

    def swap(state):
        return dict(state, map=kept["map"])
    return hook, swap


def inverted_keyframe_decision():
    """The tracking step's keyframe decision negated (slam/tracking.py::
    kf_decision), so that a tracked frame's need_kf and need_kf_hard
    flip: the KITTI stage timer's fault on its fused stage. Returns the
    function that undoes the patch."""
    from object_slam_tpu_torch.slam import tracking
    decide = tracking.kf_decision
    tracking.kf_decision = lambda *a, **kw: ~decide(*a, **kw)
    return lambda: setattr(tracking, "kf_decision", decide)


def packed_semantic_bytes(fullpipe):
    """diag_fullpipe_torch.frame_bytes counts the semantic arrays after
    bit-packing the masks (the form they travel in), not as the reference
    counts them: the full-pipeline timer's fault. Returns the function
    that undoes the patch."""
    import numpy as np
    from object_slam_tpu_torch.semantic.object2d import pack_mask_bits
    frame_bytes = fullpipe.frame_bytes

    def packed(d16, rgb8, sem_arrays):
        sem = (pack_mask_bits(sem_arrays[0]),) + tuple(sem_arrays[1:])
        _, depth_b, rgb_b = frame_bytes(d16, rgb8, sem_arrays)
        return sum(np.asarray(a).nbytes for a in sem), depth_b, rgb_b
    fullpipe.frame_bytes = packed
    return lambda: setattr(fullpipe, "frame_bytes", frame_bytes)


def drop_async_result(sys_):
    """An on_system hook: the async mapper's merge throws the pass's result
    away and keeps the tracker's map (ab_async_device_torch.py's fault)."""
    if sys_._async is not None:
        sys_._async._merge_impl = lambda res, m_now, *a: m_now
