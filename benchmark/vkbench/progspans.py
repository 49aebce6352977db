"""The program's own spans and counters in a traced window.

The program marks its stages as ``vkr.*`` spans and counts work in
``vk_renderer_tpu_torch/utils/tracing.py`` while a profiler records.
``summarize`` reduces the same profiler events as ``trace.summarize``:
the same window (``bench.window``), the same device intervals (the
program's, work launched inside ``bench.own`` left out) and the same idle
gaps (from the window's start to the first activity, between activities,
from the last activity to the window's end).  For the ``vkr.*`` spans it
keeps:

- ``idle_s``: device idle seconds by span name; a gap counts under every
  ``vkr.*`` span open on the host when it began, its ancestors included,
  unless it began inside ``bench.own`` (the benchmark's capture);
- ``syncs``: runtime calls that wait for the device (``trace.
  SYNC_CALLS``) by their innermost ``vkr.*`` span, named by its path
  (``frame/view/masked/masked.tail/masked.accept``);
- ``instances``: for each cascade and each masked continuation round
  (``INSTANCES``, numbered in the order they run inside their parent
  span, ``shadow.cascade#2``), its host seconds, device idle seconds and
  syncs, counted as above;
- ``frame_idle_s``: the idle that ``trace.summarize`` puts under
  ``bench.frame`` and the stage spans inside it (``hooks.SPANS``), and
  ``covered_idle_s``: the part of it that began inside some ``vkr.*``
  span.

A program without the spans (an older commit) leaves ``idle_s`` and
``syncs`` empty, and the readers below then return None.

The readers take the window's profiler from the run that is reporting:
``cell.run_cell`` still holds it (its local ``prof``) while it calls the
readers, so the first reader of a traced run finds it in its calling
frames, reduces it once, keeps the reduction and the program's counters
on the ``Run`` and prints the stderr lines.  The program counts only
while a profiler records, and only the window is profiled, so its
counters are the window's.
"""

from __future__ import annotations

import sys

from . import hooks, trace

PREFIX = "vkr."
OUTSIDE = "outside any program span"
FRAME_SPANS = {"bench.frame"} | {"bench." + s for s in hooks.SPANS}
TOP = 10
INSTANCES = ("vkr.shadow.cascade", "vkr.masked.tail")


def _tracing():
    """The program's tracing module, or None where it has none."""
    try:
        from vk_renderer_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def counters() -> dict | None:
    tracing = _tracing()
    return None if tracing is None else tracing.counters()


def _gaps(device, w0, w1):
    """(length, start) of each idle gap, as ``trace.summarize`` finds
    them."""
    gaps, cur1 = [], None
    for start, end, *_ in device:
        end = min(end, w1)
        if cur1 is None or start > cur1:
            if cur1 is not None:
                gaps.append((start - cur1, cur1))
            cur1 = end
        else:
            cur1 = max(cur1, end)
    if cur1 is not None:
        gaps.append((w1 - cur1, cur1))
    if device:
        gaps.append((device[0][0] - w0, w0))
    return gaps


class _Chains:
    """For the time ``t``: the names of the program spans open, innermost
    first, each name once, and the ``INSTANCES`` among them, numbered
    (cached by innermost span: a window holds millions of gaps and some
    ten thousand spans)."""

    def __init__(self, spans: trace.Spans):
        self.spans, self.cache = spans, {}
        seen, self.key = {}, []
        for i, (name, _, _) in enumerate(spans.spans):
            k = (spans.parent[i], name)
            seen[k] = seen.get(k, -1) + 1
            self.key.append(f"{name[len(PREFIX):]}#{seen[k]}"
                            if name in INSTANCES else None)

    def at(self, t):
        i = self.spans.at(t)
        if i not in self.cache:
            names, keys, j = [], [], i
            while j >= 0:
                names.append(self.spans.spans[j][0])
                if self.key[j]:
                    keys.append(self.key[j])
                j = self.spans.parent[j]
            self.cache[i] = tuple(dict.fromkeys(names)), keys
        return self.cache[i]


def summarize(prof) -> dict:
    bench, program, device, runtime, syncs_at = [], [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = trace._kind(e)
        if kind in ("user_annotation", "cpu_op"):
            name = e.name()
            if name.startswith("bench."):
                bench.append((name, *trace._span_ns(e)))
            elif name.startswith(PREFIX):
                program.append((name, *trace._span_ns(e)))
        elif kind in trace.DEVICE_KINDS:
            device.append((*trace._span_ns(e), e.name(), kind,
                           (e.correlation_id(), e.linked_correlation_id())))
        elif kind in ("cuda_runtime", "cuda_driver"):
            start, _ = trace._span_ns(e)
            runtime[e.correlation_id()] = start
            if e.name() in trace.SYNC_CALLS:
                syncs_at.append(start)
    window = [s for s in bench if s[0] == trace.WINDOW]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window[0][1], window[0][2]
    bspans = trace.Spans([s for s in bench if s[0] != trace.WINDOW])
    chains = _Chains(trace.Spans(program))
    inst = {}     # instance -> [host s, idle s, syncs]
    for key, (_, s0, s1) in zip(chains.key, chains.spans.spans):
        if key and w0 <= s0 < w1:
            inst.setdefault(key, [0, 0, 0])[0] += s1 - s0
    device = sorted(d for d in device if w0 <= d[0] < w1
                    and not trace._own(d[4], runtime, bspans))
    idle, frame_idle, covered = {}, 0, 0
    for length, at in _gaps(device, w0, w1):
        if bspans.inside(at, trace.OWN):
            continue     # the benchmark's own capture, not the program's
        chain, keys = chains.at(at)
        for name in chain:
            idle[name] = idle.get(name, 0) + length
        for key in keys:
            inst.setdefault(key, [0, 0, 0])[1] += length
        if bspans.name_at(at) in FRAME_SPANS:
            frame_idle += length
            covered += length if chain else 0
    syncs = {}
    for t in syncs_at:
        if w0 <= t < w1 and not bspans.inside(t, trace.OWN):
            chain, keys = chains.at(t)
            path = "/".join(n[len(PREFIX):] for n in reversed(chain))
            syncs[path or OUTSIDE] = syncs.get(path or OUTSIDE, 0) + 1
            for key in keys:
                inst.setdefault(key, [0, 0, 0])[2] += 1
    return {"idle_s": {k: v * 1e-9 for k, v in idle.items()},
            "syncs": syncs,
            "instances": {k: (h * 1e-9, i * 1e-9, n)
                          for k, (h, i, n) in inst.items()},
            "frame_idle_s": frame_idle * 1e-9,
            "covered_idle_s": covered * 1e-9}


# -- readers of the per-layer metrics (benchmark/metrics) -----------------
def _window_profile():
    """The torch profiler held by a calling frame (``cell.run_cell``'s
    ``prof``), or None."""
    import torch
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile):
                return value
        frame = frame.f_back
    return None


def _reduced(run):
    """``run`` with ``progspans`` and ``counters`` set, the first call of
    a run reducing the window's profiler and printing ``lines``."""
    if not hasattr(run, "progspans"):
        prof = _window_profile()
        run.progspans = None if prof is None else summarize(prof)
        run.counters = counters()
        for line in lines(run):
            print(line, file=sys.stderr)
    return run


def idle_ms(run, span: str):
    """Device idle ms a window frame under the program span ``span``."""
    spans = _reduced(run).progspans
    if not spans or not run.frames or span not in spans["idle_s"]:
        return None
    return 1e3 * spans["idle_s"][span] / run.frames


def syncs_per_frame(run, stage: str):
    """Synchronising calls a window frame whose innermost program span
    lies inside (or is) the span ``vkr.<stage>``."""
    spans = _reduced(run).progspans
    if not spans or not run.frames:
        return None
    inside = [n for path, n in spans["syncs"].items()
              if stage in path.split("/")]
    return sum(inside) / run.frames if inside else None


def counter_per_frame(run, name: str):
    """The program's counter ``name`` over the window, a window frame."""
    counts = _reduced(run).counters
    if not counts or not run.frames or name not in counts:
        return None
    return counts[name] / run.frames


def lines(run) -> list[str]:
    """The stderr lines: idle and syncs by program span, the ten largest
    each, the cascades and continuation rounds one by one (where the
    program has spans), and the counters beside the window's frames."""
    spans, counts = getattr(run, "progspans", None), getattr(run, "counters",
                                                             None)
    n, out = run.frames, []
    if not n:
        return out
    if spans and spans["idle_s"]:
        idle = sorted(spans["idle_s"].items(), key=lambda kv: -kv[1])[:TOP]
        syncs = sorted(spans["syncs"].items(), key=lambda kv: -kv[1])[:TOP]
        share = (100.0 * spans["covered_idle_s"] / spans["frame_idle_s"]
                 if spans["frame_idle_s"] > 0 else float("nan"))
        out += [
            "device idle ms/frame by program span: "
            + ", ".join(f"{k[len(PREFIX):]} {1e3 * v / n:.2f}"
                        for k, v in idle)
            + f" ({share:.2f}% of the idle under bench.frame and its "
            f"stages began inside a program span)",
            "host syncs/frame by program span: "
            + ", ".join(f"{k} {v / n:.2f}" for k, v in syncs),
            "host ms / device idle ms / host syncs a frame by instance: "
            + ", ".join(f"{k} {1e3 * h / n:.2f} / {1e3 * i / n:.2f} / "
                        f"{c / n:.2f}" for k, (h, i, c)
                        in sorted(spans["instances"].items()))]
    if counts is not None:
        out.append(f"program counters over the window ({n} frames): "
                   + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    return out
