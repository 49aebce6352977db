"""The traffic generator: a closed loop of camera poses.

A mix file (``benchmark/traffic/<name>.json``) lists the loop's poses as
``[x, y, z, yaw, pitch]`` rows and how many of them warm up.  The seed
picks only where on the loop a run starts, so every seed renders the same
set of views in another order; frame ``i`` of a run renders pose
``(start + i) mod len(poses)``.
"""

from __future__ import annotations

import random


def start(traffic: dict, seed: int) -> int:
    return seed % len(traffic["poses"])


def pose(traffic: dict, seed: int, i: int) -> list[float]:
    loop = traffic["poses"]
    return loop[(start(traffic, seed) + i) % len(loop)]


def warmup(traffic: dict, seed: int) -> list[list[float]]:
    """Warm-up poses spread evenly over the loop from the run's start."""
    loop = traffic["poses"]
    n = traffic["warmup_poses"]
    return [pose(traffic, seed, (k * len(loop)) // n) for k in range(n)]


def sample(seed: int, n_frames: int, k: int) -> list[int]:
    """``k`` distinct frame ordinals below ``n_frames``, drawn from the
    seed: the frames of the window that are compared with the
    reference."""
    rng = random.Random(seed ^ 0x5EED)
    return sorted(rng.sample(range(n_frames), min(k, n_frames)))
