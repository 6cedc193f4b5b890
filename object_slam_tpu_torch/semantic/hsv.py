"""HSV appearance-histogram layout (constants only in this slice).

The histograms themselves (object_slam_tpu/semantic/hsv.py) belong to the
object layer, which ROADMAP.md queues as the next slice. The map and the
Object2D slab need the layout now: H (30 bins), S (32) and V (32),
concatenated into one 94-vector.
"""

H_BINS, S_BINS, V_BINS = 30, 32, 32
HIST_DIM = H_BINS + S_BINS + V_BINS     # 94
