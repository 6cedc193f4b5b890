"""loop (PyTorch port; see object_slam_tpu_torch/__init__.py)."""
