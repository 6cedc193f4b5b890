"""Offline HTML trajectory scrubber: the step-by-step viewer analogue.

Counterpart of object_slam_tpu/viz/scrubber.py. The reference's Pangolin
viewer has a "Step By Step" mode that gates Track() frame by frame
(Viewer.cc:77-78,139-155, Tracking.cc:312-318) and a status bar
(FrameDrawer.cc:156-192). Here the driver writes per-frame overlay PNGs
(viz/renderer.draw_frame) with a metadata record, and this module writes
one self-contained HTML page that scrubs through them: the arrow keys step
one frame, space plays/pauses at capture rate, and the status line shows
the tracking state, inlier count and keyframe census.

Usage (scripts/run_tum_torch.py --viz-dir):
    sc = Scrubber(out_dir)
    sc.add_frame(rgb, frame, state="OK", n_inliers=..., kfs=...)
    sc.write()    # -> <out_dir>/index.html + frame_%05d.png
"""

from __future__ import annotations

import json
import os
from typing import List

from object_slam_tpu_torch.viz.renderer import save_frame_png

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>object_slam_tpu scrubber</title>
<style>
 body { background:#111; color:#ddd; font:14px monospace; margin:16px; }
 #frame { max-width:100%%; image-rendering:pixelated; border:1px solid #333; }
 #bar { margin:8px 0; }
 #slider { width:60%%; vertical-align:middle; }
 #status { color:#8c8; }
 .lost { color:#e66 !important; }
 kbd { background:#222; border:1px solid #444; padding:1px 4px; }
</style></head><body>
<h3>object_slam_tpu — offline scrubber (%(n)d frames)</h3>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="slider" min="0" max="%(last)d" value="0">
 <span id="idx">0</span>/%(last)d
 &nbsp; <kbd>&larr;</kbd><kbd>&rarr;</kbd> step &nbsp;
 <kbd>space</kbd> play/pause
</div>
<div id="status"></div>
<img id="frame" src="frame_00000.png">
<script>
const META = %(meta)s;
const N = META.length;
let i = 0, playing = false, timer = null;
const img = document.getElementById('frame');
const slider = document.getElementById('slider');
const idx = document.getElementById('idx');
const status = document.getElementById('status');
function show(k) {
  i = Math.max(0, Math.min(N - 1, k));
  img.src = 'frame_' + String(i).padStart(5, '0') + '.png';
  slider.value = i; idx.textContent = i;
  const m = META[i];
  status.textContent = JSON.stringify(m);
  status.className = (m.state === 'OK') ? '' : 'lost';
}
slider.oninput = () => show(+slider.value);
function toggle() {
  playing = !playing;
  document.getElementById('play').textContent = playing ? '\\u275A\\u275A' : '\\u25B6';
  if (playing) timer = setInterval(() => {
    if (i >= N - 1) toggle(); else show(i + 1);
  }, %(dt_ms)d);
  else clearInterval(timer);
}
document.getElementById('play').onclick = toggle;
document.addEventListener('keydown', e => {
  if (e.key === 'ArrowRight') show(i + 1);
  else if (e.key === 'ArrowLeft') show(i - 1);
  else if (e.key === ' ') { toggle(); e.preventDefault(); }
});
show(0);
</script></body></html>
"""


class Scrubber:
    def __init__(self, out_dir: str, fps: float = 30.0,
                 draw_objects: bool = True):
        self.out_dir = out_dir
        self.fps = fps
        self.draw_objects = draw_objects
        self.meta: List[dict] = []
        os.makedirs(out_dir, exist_ok=True)

    def add_frame(self, rgb, frame, **info):
        """Write one overlay PNG and its metadata record. ``info`` carries
        the status-bar fields (state, n_inliers, kfs, ...)."""
        i = len(self.meta)
        save_frame_png(os.path.join(self.out_dir, f"frame_{i:05d}.png"),
                       rgb, frame, draw_objects=self.draw_objects)
        self.meta.append({"frame": i, **info})

    def write(self) -> str:
        path = os.path.join(self.out_dir, "index.html")
        with open(path, "w") as f:
            f.write(_PAGE % {
                "n": len(self.meta),
                "last": max(len(self.meta) - 1, 0),
                "meta": json.dumps(self.meta),
                "dt_ms": int(1000.0 / max(self.fps, 1e-3)),
            })
        return path
