"""Rendering the frame as horizontal strips (parallel/sharded.py)."""
