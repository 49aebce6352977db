"""The arithmetic that several metric readers share (a metric's own file
in ``benchmark/metrics`` names which one it reads)."""

from __future__ import annotations

import math


def mean_ms(run):
    """The window's seconds x 1000 over the frames it completed."""
    return 1e3 * run.window_s / run.frames if run.frames else None


def p90_ms(run):
    """The 90th percentile (nearest rank) of every window frame's
    latency, in ms."""
    if not run.latencies:
        return None
    lat = sorted(run.latencies)
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]


def idle_pct(run):
    """1 - (union of the device's activity intervals / traced window),
    in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def span_ms(run, name: str):
    """Host milliseconds inside the ``bench.<name>`` span over the traced
    window, per window frame."""
    if run.trace is None or not run.frames:
        return None
    s = run.trace["span_s"].get("bench." + name)
    return None if s is None else 1e3 * s / run.frames


def per_frame(run, key: str):
    """A count of the traced window, per frame."""
    if run.trace is None or not run.frames:
        return None
    return run.trace[key] / run.frames
