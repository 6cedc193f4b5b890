"""The native host runtime: threaded PNG decode and frame prefetch."""
