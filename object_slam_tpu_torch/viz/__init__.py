"""Offline visualization: frame overlays, the map viewer page and the
frame scrubber."""
