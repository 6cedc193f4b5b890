"""The small stereo geometry of the stereo fixture (make_reference.py
``stereo``), built from either package's config module, so that the JAX
run, its recording and the port's tests share one definition."""


def stereo_cfg(config):
    """config: ``object_slam_tpu.config`` or ``object_slam_tpu_torch.config``.
    KITTI's tracking and mapping settings (``SlamConfig.kitti_stereo()``) at
    416x128 with KITTI's aspect, baseline (0.54 units) and vertical field
    of view (fx 240), 4 levels, 800 features, a small map, and the object
    gates eased to the small image (3 px mask margin, 4 member
    keypoints)."""
    return config.SlamConfig.kitti_stereo().replace(
        camera=config.CameraConfig(
            width=416, height=128, fx=240.0, fy=240.0, cx=208.0, cy=64.0,
            dist=(0, 0, 0, 0, 0), fps=10.0, bf=129.6, th_depth=35.0,
            depth_map_factor=1.0),
        orb=config.OrbConfig(n_features=800, n_levels=4),
        caps=config.CapacityConfig(n_kp=1024, max_points=8192,
                                   max_keyframes=64),
        semantic=config.SemanticConfig(mask_margin=3, min_kps_stereo=4))
