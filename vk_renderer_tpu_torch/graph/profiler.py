"""Per-pass timing breakdown of whole frames, read from the frame's own
spans.

Port of vk_renderer_tpu/graph/profiler.py (``profile_passes``,
``format_table``).  ``profile_passes`` renders ``iters`` whole frames
(``render_frame``) under a torch profiler and reduces the frame's
``vkr.*`` spans (utils/tracing.py) to the JAX profiler's stage names, in
the order the frame runs them: shadow, setup, bin, records,
raster_opaque, masked (with masked_kraster0 inside it), gbuffer, shade,
compose, transparent, tonemap, then the whole frame as ``full_frame``.
A stage the scene or config does not run (no masked or transparent
triangles, shadows compiled out) is left out.

A stage's host ms is the wall time inside its spans, a frame; its device
ms the time of the kernels, copies and fills launched inside them.  A
stage counts only the spans that no other stage holds (masked_kraster0
only those inside the masked pass): the shadow cascades' own binning and
records count in ``shadow``, the transparent peels' G-buffers in
``transparent``.  So the stages partition the frame, and the part of the
frame outside every stage (the classifier tables, the u8 conversion, the
host code between stages) is ``full_frame`` less their sum.  On a CUDA
scene one unprofiled frame comes first (the kernels' first build, the
allocator), and each frame ends in ``torch.cuda.synchronize()``.

The host ms are taken while the profiler records, which slows the
eager frame (1.3-2.2x on the bench frame on an H100): ``iters``
unprofiled frames run first, and their mean wall time stands beside the
profiled one.
"""

from __future__ import annotations

import bisect
import re
import time

import torch

from ..utils import tracing
from . import frame as F

# stage -> the stage whose spans hold the ones it counts (None: the
# frame's own)
STAGES = {"shadow": None, "setup": None, "bin": None, "records": None,
          "raster_opaque": None, "masked": None, "masked_kraster0": "masked",
          "gbuffer": None, "shade": None, "compose": None,
          "transparent": None, "tonemap": None}
FRAME = "full_frame"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")   # cudaLaunchKernel, cuMemcpy...


class PassTimes(dict):
    """{stage: host ms a frame, profiled}, in the frame's order;
    ``device_ms`` holds the device ms a frame of the same stages,
    ``unprofiled_ms`` the wall ms of a frame with no profiler on."""

    def __init__(self, host_ms: dict, device_ms: dict, frames: int,
                 unprofiled_ms: float):
        super().__init__(host_ms)
        self.device_ms = device_ms
        self.frames = frames
        self.unprofiled_ms = unprofiled_ms


def _stage_of(name: str):
    """The stage a ``vkr.*`` span name stands for, else None."""
    if not name.startswith(tracing.PREFIX):
        return None
    name = name[len(tracing.PREFIX):]
    if name == "frame":
        return FRAME
    return name if name in STAGES else None


def _counted(events):
    """The host spans of the profile that count for a stage, as
    (start ns, end ns, stage), and the device events as (launch ns,
    duration ns)."""
    spans, launched, device = [], {}, []
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append(((e.correlation_id(),
                                e.linked_correlation_id()), e.duration_ns()))
            continue
        name = e.name()
        stage = _stage_of(name)
        if stage is not None:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          stage))
        elif _RUNTIME.match(name):
            launched[e.correlation_id()] = e.start_ns()
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    counted, stack = [], []     # stack: (end, the stage holding inside)
    for s0, s1, stage in spans:
        while stack and stack[-1][0] <= s0:
            stack.pop()
        holder = stack[-1][1] if stack else None
        if stage == FRAME or holder == STAGES[stage]:
            counted.append((s0, s1, stage))
        stack.append((s1, holder if stage == FRAME else stage))
    at = [(launched.get(c0, launched.get(c1)), ns)
          for (c0, c1), ns in device]
    return counted, [(t, ns) for t, ns in at if t is not None]


def profile_passes(scene, scene_data: dict, settings: dict,
                   cfg: F.FrameConfig, iters: int = 5) -> PassTimes:
    """Host and device ms a frame of each stage, over ``iters`` profiled
    frames, plus ``full_frame``, and the unprofiled frame's ms over
    ``iters`` frames before them.  ``scene_data`` and ``settings`` are
    render_frame's tensors (driver.frame_inputs)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = scene.positions[0].device.type == "cuda"
    activities = [ProfilerActivity.CPU]

    def frames():
        for _ in range(iters):
            F.render_frame(scene, scene_data, settings, cfg)
            if cuda:
                torch.cuda.synchronize()

    if cuda:
        activities.append(ProfilerActivity.CUDA)
        F.render_frame(scene, scene_data, settings, cfg)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames()
    unprofiled = (time.perf_counter() - t0) * 1e3 / iters
    with profile(activities=activities) as prof:
        frames()
    counted, device = _counted(prof.profiler.kineto_results.events())
    host, dev = {}, {}
    for s0, s1, stage in counted:
        host[stage] = host.get(stage, 0) + s1 - s0
        dev[stage] = dev.get(stage, 0)
    starts = [s0 for s0, _, _ in counted]
    for t, ns in device:
        for _, s1, stage in counted[:bisect.bisect_right(starts, t)]:
            if s1 >= t:     # the launch lies inside this stage's span
                dev[stage] += ns
    order = list(dict.fromkeys(st for _, _, st in counted if st != FRAME))
    order.append(FRAME)
    return PassTimes({s: host.get(s, 0) / 1e6 / iters for s in order},
                     {s: dev.get(s, 0) / 1e6 / iters for s in order}, iters,
                     unprofiled)


def format_table(timings: PassTimes) -> str:
    """The timings as a text table, with the sum of the stages the frame
    holds directly beside the whole frame."""
    dev = timings.device_ms
    lines = [f"per-pass ms a frame over {timings.frames} "
             f"frames (host: wall time inside the stage's spans while the "
             f"profiler records; device: the kernels launched inside them):",
             f"  {'stage':<16} {'host':>9} {'device':>9}"]

    def row(name, host, device, note=""):
        lines.append(f"  {name:<16} {host:9.2f} {device:9.2f}{note}")

    top = [s for s in timings if s != FRAME and STAGES[s] is None]
    for s, v in timings.items():
        if s != FRAME:
            row(s, v, dev[s],
                f"  (inside {STAGES[s]})" if STAGES[s] else "")
    row("stage sum", sum(timings[s] for s in top),
        sum(dev[s] for s in top))
    row(FRAME, timings[FRAME], dev[FRAME])
    lines.append(f"  {'unprofiled':<16} {timings.unprofiled_ms:9.2f}"
                 f"  (the frame with no profiler on: profiled / unprofiled "
                 f"{timings[FRAME] / timings.unprofiled_ms:.2f}x)")
    return "\n".join(lines)
