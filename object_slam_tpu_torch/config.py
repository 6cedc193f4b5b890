"""Typed configuration for the whole engine.

A field-for-field copy of object_slam_tpu/config.py: the port keeps its own
copy because importing any object_slam_tpu module imports JAX.

The reference scatters its knobs between per-sequence YAML files
(`Examples/RGB-D/TUM2.yaml`, parsed at
`src/Tracking.cc:61-172`) and hard-coded constants
(semantic label whitelists `Semantic.cc:10-11`, cluster tolerance
`ObjectTypes.cc:716`, association thresholds `ObjectMatcher.cc:430,783,789`,
merge overlap `Map.cc:64`). Here every knob is a field of one frozen
dataclass tree so runs are reproducible and sweepable.

Static-shape capacities (N_KP, MAX_POINTS, ...) size the fixed slabs with
validity masks that hold all device state (the reference package's design,
kept so both packages hold the same state).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics + stereo baseline.

    Mirrors the `Camera.*` block of the reference YAMLs (`Tracking.cc:68-130`).
    Defaults are TUM freiburg2 (`Examples/RGB-D/TUM2.yaml` values).
    """

    fx: float = 520.908620
    fy: float = 521.007327
    cx: float = 325.141442
    cy: float = 249.701764
    # radial/tangential distortion k1 k2 p1 p2 k3
    dist: Tuple[float, float, float, float, float] = (
        0.231222, -0.784899, -0.003257, -0.000105, 0.917205)
    width: int = 640
    height: int = 480
    fps: float = 30.0
    # stereo baseline times fx (reference `Camera.bf`)
    bf: float = 40.0
    # depth threshold multiplier: close/far point split (`ThDepth`)
    th_depth: float = 40.0
    # RGB-D depth map scaling (`DepthMapFactor`)
    depth_map_factor: float = 5208.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (`ORBextractor.*` YAML block, `Tracking.cc:132-170`)."""

    n_features: int = 1000          # total keypoint budget across levels
    scale_factor: float = 1.2       # pyramid scale (ORBextractor.cc:1107)
    n_levels: int = 8
    ini_th_fast: int = 20           # FAST threshold, primary
    min_th_fast: int = 7            # FAST threshold, fallback
    cell_size: int = 32             # spatial-suppression cell (ref uses 30px
                                    # cells + quadtree; we use per-cell top-k)
    patch_size: int = 31            # BRIEF/orientation patch
    half_patch: int = 15
    edge_threshold: int = 19        # border margin for keypoints
    fast_ring_radius: int = 3       # FAST-9/16 circle radius
    fast_arc_len: int = 9           # contiguous arc length for FAST-9


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (ORBmatcher.h TH_LOW/TH_HIGH/HISTO_LENGTH)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30          # rotation-consistency histogram bins
    nn_ratio: float = 0.9           # Lowe ratio used in BoW/epipolar searches
    search_radius_th: float = 7.0   # projection-window radius multiplier (tracking)
    reloc_radius_th: float = 10.0


@dataclass(frozen=True)
class SemanticConfig:
    """Instance-mask ingestion (`Semantic.cc`, `Frame.cc:240-414`)."""

    min_confidence: float = 0.7     # `MinSemanticConfidence` yaml key
    # per-dataset whitelists (Semantic.cc:10-11). TUM: bottle(39), cup(41),
    # chair(56), potted plant(58), tv(62), laptop(63->62), mouse(64),
    # remote(65), keyboard(66), book(73), teddy bear(77), person(0).
    valid_labels_tum: Tuple[int, ...] = (0, 39, 41, 56, 58, 62, 63, 64, 65, 66, 73, 77)
    valid_labels_kitti: Tuple[int, ...] = (2,)   # car
    max_instances: int = 16         # static per-frame instance slab
    min_kps_rgbd: int = 5           # min member keypoints (Frame.cc:240-384)
    min_kps_stereo: int = 10
    mask_margin: int = 10           # 20x20 interior window half-size (Frame.cc:266)
    hsv_bins: Tuple[int, int, int] = (30, 32, 32)   # H,S,V bins (Frame.cc:388-414)


@dataclass(frozen=True)
class ObjectConfig:
    """Object landmark lifecycle + association (ObjectTypes.cc / ObjectMatcher.cc / Map.cc)."""

    # association gates (ObjectMatcher.cc:430-435, :782-794)
    hsv_sim_min: float = 0.8
    iou2d_min: float = 0.5
    mean_dist_max_indoor: float = 0.3
    mean_dist_max_outdoor: float = 5.0
    min_dist_max: float = 0.1
    # map regularization (Map.cc:47-65)
    merge_overlap_min: float = 0.4
    # outlier rejection (ObjectTypes.cc:117-138, :661-764)
    cluster_tolerance_indoor: float = 0.1
    cluster_tolerance_outdoor: float = 1.0
    big_object_points: int = 3000   # >N → plain 3-sigma (TEST5), else TEST7
    small_cluster_frac: float = 0.1
    small_cluster_min_n: int = 15
    sigma_gate: float = 3.0
    min_points_valid: int = 5       # Object3D invalid if <5 pts after 5 updates
    min_updates_for_validity: int = 5
    label_prob_min: float = 0.5     # MapPoint label vote gate (ObjectTypes.cc:143-148)
    # static capacities
    max_points_per_object: int = 4096
    history_capacity: int = 64      # observation history ring (centers/poses/hists)
    # ablation switch: False runs the full object pipeline (association,
    # landmarks, census) WITHOUT the semantically-constrained pose
    # refinement (ObjectOptimizer.cc:624's M_joint/M_semantic swap-in) —
    # isolates the paper's second contribution from the pipeline's KF-
    # policy/retention side effects (VERDICT r4 item 5)
    semopt_enabled: bool = True


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end policy (Tracking.cc)."""

    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30      # = fps by default (Tracking.cc:1242)
    min_inliers_ok: int = 30             # pose considered good (Tracking.cc:~)
    min_inliers_reloc: int = 50
    kf_ref_ratio_stereo: float = 0.75    # NeedNewKeyFrame tracked/ref ratios
    kf_ref_ratio_many_kf: float = 0.90
    close_point_depth_n: int = 100       # stereo: need new KF if <100 close pts
    motion_model_radius: float = 15.0    # projection search window th (stereo 7)
    min_init_matches: int = 100          # mono two-view bootstrap gate
    min_init_inliers: int = 50           # triangulated-inlier gate
    # Local-map search (SearchLocalPoints) window widening — 1.0/1 is
    # reference parity (RadiusByViewingCos * sf[pred], pred±1). The KITTI
    # profile widens both: the gate-attribution probe
    # (scripts/diag_local_recovery.py, r5) measured 37.9% of visible
    # unmatched close points blocked by the radius (half recoverable at
    # 2x) and 18.9% by the level gate (38% recoverable at ±2) under
    # 0.8 m/frame looming, where corner localization and detection level
    # jitter exceed the indoor-tuned windows.
    local_radius_mult: float = 1.0
    local_level_window: int = 1
    # Rotation-histogram consistency on the frame-to-frame motion search
    # (mbCheckOrientation, ORBmatcher.cc:1437-1457). True is reference
    # parity. The KITTI profile disables it: the r5 motion-chain probe
    # (scripts/diag_motion_chain.py) measured the top-3-bin filter
    # killing 19.5% of close bound rows of which 40% were GT-correct
    # matches, while the chi^2 pose regate absorbed the re-admitted
    # aliases — net close-point inliers 39.2% -> 47.3% of bound with the
    # check off. IC angles on looming road texture jitter across bins;
    # indoor scenes keep the reference behavior.
    motion_rot_check: bool = True
    # one-frame-lagged fused readback (slam/system._track_fused): hides
    # the per-frame device->host round trip. False = strict
    # one-sync-per-frame state machine.
    pipelined_readback: bool = True
    # False routes tracking through the staged host path (one jitted
    # program per stage, host-visible intermediates) instead of the fused
    # one-sync program — for stage-level diagnostics (diag_semopt) only
    fused: bool = True


@dataclass(frozen=True)
class SolverConfig:
    """Optimization schedules (Optimizer.cc / ObjectOptimizer.cc)."""

    pose_rounds: int = 4                 # 4 x 10 LM iterations with chi2 regating
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991             # Huber delta^2 mono (2 dof)
    chi2_stereo: float = 7.815           # stereo (3 dof)
    local_ba_iters1: int = 5
    local_ba_iters2: int = 10
    global_ba_iters: int = 10
    pose_graph_iters: int = 20
    lm_lambda_init: float = 1e-4
    lm_lambda_factor: float = 10.0
    # semantic optimizer (ObjectOptimizer.cc:624-1240).
    # The reference gates M_semantic on `distance[0] < 10` from a PCL
    # nearestKSearch — PCL returns SQUARED distances, so the effective
    # reach is sqrt(10) ~= 3.16 px, not 10 (ObjectOptimizer.cc:1005,
    # :960/:1071 use the same squared value for outlier removal). Round 1-4
    # read it as 10 Euclidean px: 3x the reach and ~10x the typical pull
    # of the reference's constraint — measured r5 as the semantic
    # refinement DAMAGING the exact-mask circuit (boundary members pulled
    # inward; ATE 29 -> 180 mm; results/experiments_r5.json before this
    # fix). sem_min_shift_px: the `< 1.0` creation gate is 1 px under
    # either reading.
    sem_reproj_gate_px: float = 3.1623   # M_semantic gate: sqrt(10) px
    sem_min_shift_px: float = 1.0        # skip M_joint edge if <1px from mask
    # RANSAC
    ransac_trials: int = 256             # batched hypotheses (vmap)
    epnp_min_inliers: int = 10
    sim3_min_inliers: int = 20


@dataclass(frozen=True)
class LoopConfig:
    """Place recognition + loop closing (KeyFrameDatabase.cc / LoopClosing.cc)."""

    vocab_branching: int = 10
    vocab_depth: int = 4                 # 10^4 = 10k words (retrained, not DBoW2)
    covis_consistency_th: int = 3        # consecutive consistent groups
    min_common_words_ratio: float = 0.8
    min_score_ratio: float = 0.75
    covis_weight_min: int = 15           # covisibility edge threshold (KeyFrame.cc:289)
    sim3_inliers: int = 20
    total_matches_accept: int = 40
    # closure-benefit gate: roll the speculative correction back when the
    # post-GBA mean robust reprojection cost grows by more than this
    # fraction AND more than the absolute floor (loop_closing._correct_loop;
    # the floor keeps near-zero-residual maps from tripping the relative
    # test on numerical noise)
    benefit_gate_tolerance: float = 0.05
    benefit_gate_abs_floor: float = 0.01
    # drift-budget gate: a genuine closure distributes its correction as
    # a SMALL bend of each odometry edge; a wrong (aliased) Sim3 bends
    # the whole trajectory hard — and reprojection metrics cannot see
    # that (BA gauge freedom: points move with poses). Reject when the
    # MEDIAN per-edge deformation exceeds these budgets (deg per edge /
    # fraction of edge length). The effective budget scales up with the
    # claimed correction magnitude over the edge count (loop_closing.
    # _correct_loop), so large genuine corrections on short loops pass.
    max_edge_bend_deg: float = 0.3
    max_edge_bend_frac: float = 0.05
    # ABSOLUTE pre-gate caps on the PREDICTED per-edge bend (correction
    # spread over the q..l chain). The relative pre-gate (4x the scaled
    # budget) only catches short-chain candidates; an aliased-corridor
    # candidate claiming a ~6-unit correction over the whole chain slips
    # it, and its speculative GBA then runs the full non-converging
    # schedule (scripts/diag_loop_alias.py r5). A true closure's per-edge
    # correction is bounded by plausible per-edge odometry drift; a
    # prediction that bends the MEDIAN edge by half its length (or 5
    # deg) per edge claims 50%-per-step odometry error — reject before
    # paying the correction. (The r5 positive-circuit closure predicts
    # <0.1% per edge; the four corridor aliases predict 70-610%.)
    pregate_bend_frac_abs: float = 0.5
    pregate_bend_deg_abs: float = 5.0


@dataclass(frozen=True)
class MappingConfig:
    """Back-end mapping policy (LocalMapping.cc) — including the three
    documented behavior deviations from the reference, promoted to flags
    so they can be A/B-measured on a sequence (PARITY.md records the
    measured verdicts; defaults are the winners)."""

    # MapPointCulling scope: True = both tests apply only during a point's
    # first ~3 keyframes (the reference's mlpRecentAddedMapPoints window,
    # LocalMapping.cc:171-206); False = round-1 behavior, every point
    # tested at every keyframe forever.
    cull_recency_scope: bool = True
    # Distinctive-descriptor re-election after fusion (min-median Hamming,
    # MapPoint::ComputeDistinctiveDescriptors); False = keep the creation
    # descriptor (round-1 behavior).
    reelect_descriptors: bool = True
    # KeyFrameCulling redundancy counting: True = an observation is only
    # redundant when >=3 OTHER keyframes see the point at the same or
    # finer scale (scaleLevel <= scaleLevel+1, LocalMapping.cc:672-683);
    # False = scale-free counting (strictly more aggressive culling).
    kf_cull_scale_condition: bool = False
    # mbAbortBA analogue (LocalMapping.cc:119, Optimizer.cc:660-707):
    # when keyframes arrive faster than `ba_abort_pressure_gap` frames
    # apart, the reference's tracker interrupts the in-flight local BA —
    # on KITTI-rate forward motion its local BA rarely completes the full
    # optimize(5)+prune+optimize(10) schedule. Here the same contract is
    # a second compiled mapping program with the abbreviated schedule
    # `ba_abort_iters`; 0 disables (full schedule always — VGA default).
    ba_abort_pressure_gap: int = 0
    ba_abort_iters: tuple = (5, 0)


@dataclass(frozen=True)
class CapacityConfig:
    """Static slab sizes for the functional map (static shapes)."""

    n_kp: int = 1024                 # per-frame keypoint slab (>= OrbConfig.n_features)
    max_points: int = 32768          # MapPoint slab
    max_keyframes: int = 512
    max_obs_per_kf: int = 1024       # == n_kp (each kp maps to <=1 point)
    max_objects: int = 64            # Object3D slab
    max_frames: int = 8192           # trajectory record
    grid_rows: int = 48              # feature grid (Frame.h:43-44)
    grid_cols: int = 64
    local_window_kf: int = 32        # local-BA covisible window
    # local-BA compacted point slab: the window's free points are packed
    # into this many rows so every per-point reduction is a gather, not a
    # scatter over the full max_points slab (solvers/ba.py ba_iterate)
    local_pt_cap: int = 8192
    # local-BA per-KF observation slab: each window KF's live observations
    # compact into this many slots (~1/4 of n_kp slots are live; every
    # O-sized sweep inside the LM loop shrinks proportionally)
    local_obs_per_kf: int = 512
    # per-frame local-map search point cap (select_local_points; the
    # reference searches ALL local points — recency-first compaction
    # keeps fresh spawns searchable inside the static shape)
    local_search_pts: int = 4096


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    objects: ObjectConfig = field(default_factory=ObjectConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    caps: CapacityConfig = field(default_factory=CapacityConfig)
    sensor: str = "rgbd"             # rgbd | stereo | mono
    indoor: bool = True              # selects indoor/outdoor tolerances

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def tum_rgbd() -> "SlamConfig":
        return SlamConfig()

    @staticmethod
    def euroc_stereo() -> "SlamConfig":
        """Rectified EuRoC MAV pair (Examples/Stereo/EuRoC.yaml Camera.*).
        Use datasets.euroc.euroc_camera_config to derive the camera block
        from a calibration YAML instead of these constants."""
        cam = CameraConfig(
            fx=435.2046959714599, fy=435.2046959714599,
            cx=367.4517211914062, cy=252.2008514404297,
            dist=(0.0, 0.0, 0.0, 0.0, 0.0), width=752, height=480,
            fps=20.0, bf=47.90639384423901, th_depth=35.0,
            depth_map_factor=1.0)
        orb = OrbConfig(n_features=1200)
        caps = CapacityConfig(n_kp=1280, max_points=49152, max_keyframes=768)
        return SlamConfig(camera=cam, orb=orb, caps=caps,
                          sensor="stereo", indoor=True)

    @staticmethod
    def kitti_stereo() -> "SlamConfig":
        cam = CameraConfig(
            fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
            dist=(0.0, 0.0, 0.0, 0.0, 0.0), width=1241, height=376,
            fps=10.0, bf=386.1448, th_depth=35.0, depth_map_factor=1.0)
        orb = OrbConfig(n_features=2000)
        caps = CapacityConfig(n_kp=2048, max_points=65536,
                              max_keyframes=1024, local_pt_cap=8192,
                              local_obs_per_kf=1024,
                              local_search_pts=8192)
        # KITTI-rate forward motion inserts keyframes every 3-4 frames
        # (r5 cadence), faster than the full local-BA schedule completes
        # in the reference package — the regime where the reference's
        # tracker interrupts local BA (mbAbortBA) nearly every pass, so
        # gap<5 routes to the abbreviated schedule;
        # see MappingConfig.ba_abort_*.
        mapping = MappingConfig(ba_abort_pressure_gap=5)
        # max gap = fps (Tracking.cc:266 mMaxFrames = fps; KITTI is 10 Hz);
        # min gap 2 suppresses the dispatch-lag duplicate KFs (see
        # tracking.kf_decision min_gap rationale — measured: 42 KFs/80
        # frames without it, every close-budget KF followed by a
        # near-duplicate at t+1)
        trk = TrackingConfig(max_frames_between_kf=10,
                             min_frames_between_kf=2,
                             local_radius_mult=2.0,
                             local_level_window=2,
                             motion_rot_check=False)
        return SlamConfig(camera=cam, orb=orb, caps=caps, mapping=mapping,
                          tracking=trk, sensor="stereo", indoor=False)
