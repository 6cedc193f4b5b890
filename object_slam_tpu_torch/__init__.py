"""object_slam_tpu_torch — the PyTorch / CUDA port of object_slam_tpu.

The JAX package ``object_slam_tpu`` is the reference; this package mirrors
its sub-packages and module names so each module's counterpart sits at the
same path. It imports ``torch`` and ``numpy`` and never JAX or anything of
the reference package. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise.

It covers the RGB-D main path: ORB extraction (its describe step is one
CUDA kernel launch per frame, ops/describe.py), tracking, keyframe
insertion, local mapping with local BA, the object layer, the single-blob
ingestion, the one-frame-lagged readback, the staged path with
relocalization, the TUM tail (loaders, PNG codec, trajectory writers,
ATE / RPE), the stereo sensor with async mapping, and loop closing with
the BoW relocalization. ROADMAP.md lists what later slices port.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 matmul precision, as the reference package forces "highest"
# (object_slam_tpu/__init__.py): every geometry transform, pose solve and
# BA product here is an f32 matmul, and TF32's 10-bit mantissa at
# outdoor-trajectory coordinates is multi-pixel reprojection noise.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from object_slam_tpu_torch.config import SlamConfig  # noqa: E402,F401
