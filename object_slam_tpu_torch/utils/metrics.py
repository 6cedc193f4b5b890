"""Structured per-frame metrics stream.

A copy of object_slam_tpu/utils/metrics.py: the reference's per-frame
``cout`` banners (Tracking.cc:229-275) and status-bar counts
(FrameDrawer.cc:156-182) as one JSON line per frame. Every field is host
state the tracking loop already holds, so the stream adds no device read.

Usage:
    stream = MetricsStream("run_metrics.jsonl")
    sys_ = SlamSystem(cfg, metrics=stream)
    ... track ...
    stream.close()

Each record:
    {"frame": int, "ts": float, "state": "OK|LOST|NOT_INITIALIZED",
     "track_ms": float, "n_inliers": int, "kf_inserted": bool,
     "ref_kf": int, "frames_since_kf": int}
"""

from __future__ import annotations

import io
import json
from typing import Optional, Union


class MetricsStream:
    """Append-only JSONL metrics writer with optional buffering."""

    def __init__(self, sink: Union[str, io.TextIOBase],
                 flush_every: int = 1):
        if isinstance(sink, str):
            self._fh = open(sink, "a")
            self._owns = True
        else:
            self._fh = sink
            self._owns = False
        self.flush_every = max(1, flush_every)
        self._n = 0
        self.last: Optional[dict] = None

    def emit(self, **fields):
        self.last = fields
        self._fh.write(json.dumps(fields, separators=(",", ":")) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._fh.flush()

    def close(self):
        self._fh.flush()
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
