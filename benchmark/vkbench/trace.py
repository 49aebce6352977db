"""The profiler's trace of a window, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activities, CUPTI underneath) records
the host's ops and the benchmark's spans, the CUDA runtime calls and the
device's kernels, copies and fills on one time base.  ``summarize`` keeps,
for the events inside the ``bench.window`` span:

- ``busy_s``: the union of the program's device activity intervals
  (kernels, copies, fills), and ``window_s``: device work whose runtime
  call lies inside a ``bench.own`` span is the benchmark's, not the
  program's, and is left out here and below;
- ``launches``: the kernels the program launched;
- ``syncs``: runtime calls that wait for the device (stream, device and
  event synchronisation, blocking copies);
- ``kernel_s``: device seconds by kernel name; ``span_s``: host seconds
  inside each ``bench.*`` span;
- ``device_ops``: the ten kernels that took most device time;
  ``idle_gaps``: the device's idle time between activity, summed by the
  innermost ``bench.*`` span open on the host when each gap began, the
  ten largest sums.
"""

from __future__ import annotations

import bisect
import re

SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize",
              "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpy"}
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_NAME = re.compile(r"^cu(da)?[A-Z]")   # cudaLaunchKernel, cuMemcpy...
WINDOW = "bench.window"
NAME_CHARS = 160      # a kernel's name in the breakdown, cut
OWN = "bench.own"


def profiler():
    """Kineto over the window: CPU ops and spans, CUDA runtime calls and
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _kind(e) -> str:
    """The event's activity kind, from the event where it says (newer
    torch), else from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("bench."):       # a span's device-side copy
            return "gpu_user_annotation"
        low = name.lower()
        if low.startswith("memcpy"):
            return "gpu_memcpy"
        if low.startswith("memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("bench."):
        return "user_annotation"
    if RUNTIME_NAME.match(name):
        return "cuda_runtime"
    return "cpu_op"


def _span_ns(e) -> tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


class Spans:
    """Properly nested host spans (name, start, end): the innermost one
    open at a time ``t``."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in spans]
        self.spans = spans
        parent, stack = [], []
        for i, (_, s0, s1) in enumerate(spans):
            while stack and spans[stack[-1]][2] <= s0:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.parent = parent

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][2] < t:
            i = self.parent[i]
        return i

    def name_at(self, t) -> str:
        i = self.at(t)
        return self.spans[i][0] if i >= 0 else "outside any span"

    def inside(self, t, name: str) -> bool:
        i = self.at(t)
        while i >= 0:
            if self.spans[i][0] == name:
                return True
            i = self.parent[i]
        return False


def _own(corr, runtime: dict, spans: Spans) -> bool:
    """Whether the runtime call behind a device activity lies inside a
    ``bench.own`` span."""
    launched = runtime.get(corr[0], runtime.get(corr[1]))
    return launched is not None and spans.inside(launched, OWN)


def summarize(prof) -> dict:
    events = prof.profiler.kineto_results.events()
    host_spans, device, runtime = [], [], {}
    syncs_at = []
    for e in events:
        kind = _kind(e)
        if kind in ("user_annotation", "cpu_op") and \
                e.name().startswith("bench."):
            host_spans.append((e.name(), *_span_ns(e)))
        elif kind in DEVICE_KINDS:
            device.append((*_span_ns(e), e.name(), kind,
                           (e.correlation_id(), e.linked_correlation_id())))
        elif kind in ("cuda_runtime", "cuda_driver"):
            start, _ = _span_ns(e)
            runtime[e.correlation_id()] = start
            if e.name() in SYNC_CALLS:
                syncs_at.append(start)
    window = [s for s in host_spans if s[0] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window[0][1], window[0][2]
    spans = Spans([s for s in host_spans if s[0] != WINDOW])
    device = sorted(d for d in device if w0 <= d[0] < w1
                    and not _own(d[4], runtime, spans))
    launches = 0
    kernel_s = {}
    for start, end, name, kind, corr in device:
        if kind != "kernel":
            continue
        launches += 1
        kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) * 1e-9
    busy_ns, gaps = 0, []
    cur0 = cur1 = None
    for start, end, *_ in device:
        end = min(end, w1)
        if cur1 is None or start > cur1:
            if cur1 is not None:
                busy_ns += cur1 - cur0
                gaps.append((start - cur1, cur1))
            cur0, cur1 = start, end
        else:
            cur1 = max(cur1, end)
    if cur1 is not None:
        busy_ns += cur1 - cur0
        gaps.append((w1 - cur1, cur1))
    if device:
        gaps.append((device[0][0] - w0, w0))
    syncs = sum(1 for t in syncs_at
                if w0 <= t < w1 and not spans.inside(t, OWN))
    span_s = {}
    for name, s0, s1 in spans.spans:
        if w0 <= s0 < w1:
            span_s[name] = span_s.get(name, 0.0) + (s1 - s0) * 1e-9
    gap_names = {}
    for length, at in gaps:
        key = spans.name_at(at)
        gap_names.setdefault(key, []).append(length * 1e-9)
    idle_by_span = sorted(((k, sum(v)) for k, v in gap_names.items()),
                          key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "launches": launches,
        "syncs": syncs,
        "kernel_s": kernel_s,
        "span_s": span_s,
        "device_ops": [[name[:NAME_CHARS], s] for name, s in sorted(
            kernel_s.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [list(kv) for kv in idle_by_span[:10]],
    }
