"""Wrappers around the program's functions, installed at their module
attributes for the length of a run (the Recorder pattern: the program is
called through the attribute, so rebinding it reaches every caller).

- Spans: with tracing on, the stages of ``graph/frame`` (``SPANS``: the
  shadow pass, the masked pass, shading and the rest) each run inside a
  ``torch.profiler.record_function`` named ``bench.<span>``; the trace
  (``trace.summarize``) sums the host seconds inside each over the
  window.
- Capture: on a frame picked for the comparison, the masked pass's
  visibility (depth, triangle id) and the shadow pass's maps are copied
  on the device into buffers allocated in set-up.
- Kernel work (tracing only): each call of the four hand kernels'
  dispatchers adds its launch's bound (``roofline``) to a device
  accumulator (zeroed where the window starts), inside the ``bench.own``
  span whose device work the trace leaves out of the program's.
"""

from __future__ import annotations

import contextlib

from . import roofline

# span name -> the graph/frame function it wraps
SPANS = {"shadow": "shadow_pass", "masked": "_masked_pass",
         "shade": "shade_view", "classifier": "_build_classifier_tables",
         "view_setup": "view_setup", "plan_view": "plan_view",
         "gbuffer": "_build_gbuffer", "compose": "compose",
         "post": "post_chain"}


class Rebind:
    """Rebinds ``owner.name`` (an attribute, or a dict entry) to
    ``make(real)`` while entered."""

    def __init__(self, owner, name, make):
        self.owner, self.name, self.make = owner, name, make

    def _get(self):
        if isinstance(self.owner, dict):
            return self.owner[self.name]
        return getattr(self.owner, self.name)

    def _set(self, fn):
        if isinstance(self.owner, dict):
            self.owner[self.name] = fn
        else:
            setattr(self.owner, self.name, fn)

    def __enter__(self):
        self.real = self._get()
        self._set(self.make(self.real))
        return self

    def __exit__(self, *exc):
        self._set(self.real)


class Hooks:
    """Spans, capture and kernel work for one run; ``install`` enters the
    wrappers on an ExitStack."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.slot = None          # the capture buffers of this frame
        self.sizing = True        # keep the last outputs (warm-up only)
        self.seen = {}            # last outputs, for sizing the buffers
        self.bound = None         # f64[4] device accumulator (tracing)

    # -- spans and capture ------------------------------------------------
    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("bench." + name)

    def _wrap_pass(self, name: str, real):
        def run(*args, **kw):
            with self.span(name):
                out = real(*args, **kw)
                self._capture(name, out)
            return out
        return run

    def _capture(self, name: str, out) -> None:
        if name == "masked":
            parts = {"depth": out[0], "tid": out[1]}
        elif name == "shadow":
            parts = {"shadow_maps": out[0]}
        else:
            return
        if self.sizing:
            self.seen.update(parts)
        if self.slot is not None:
            with self.span("own"):
                for key, t in parts.items():
                    self.slot[key].copy_(t)

    # -- kernel work --------------------------------------------------------
    def _wrap_kernel(self, name: str, real):
        def run(*args, **kw):
            with self.span("own"):
                self._account(name, args, kw)
            return real(*args, **kw)
        return run

    def _account(self, name: str, args, kw) -> None:
        i = KERNELS.index(name)
        if name == "tonemap":
            self.bound[i] += roofline.bound_s(
                *roofline.tonemap_work(args[0].numel()))
            return
        if name == "gradient":
            self.bound[i] += roofline.bound_s(
                *roofline.gradient_work(args[0], args[1]))
            return
        records, rec_start, counts = args[:3]
        if name == "raster_depth":
            floor_t = args[5] if len(args) > 5 else kw.get("floor_t")
            planes, outputs = [args[3], args[4], floor_t], 8
        else:
            floor_t = args[4] if len(args) > 4 else kw.get("floor_t")
            k_layers = args[6] if len(args) > 6 else kw["k_layers"]
            planes, outputs = [args[3], floor_t], 8 * k_layers
        self.bound[i] += roofline.raster_bound_s(
            records, rec_start, counts, planes, outputs,
            kw.get("tile_h", 32), kw.get("tile_w", 128))

    def install(self, stack: contextlib.ExitStack, device) -> None:
        from vk_renderer_tpu_torch.graph import frame
        from vk_renderer_tpu_torch.ops import post
        from vk_renderer_tpu_torch.ops import raster_kernels as rk
        for name, attr in SPANS.items():
            stack.enter_context(Rebind(
                frame, attr, lambda real, n=name: self._wrap_pass(n, real)))
        if not self.trace:
            return
        import torch
        self.bound = torch.zeros(len(KERNELS), dtype=torch.float64,
                                 device=device)
        for name, (owner, attr) in (
                ("raster_depth", (rk, "rasterize_depth_grid")),
                ("raster_layers", (rk, "rasterize_layers_grid")),
                ("tonemap", (frame.POSTPROCESS_REGISTRY, "tonemap")),
                ("gradient", (post, "gradient"))):
            stack.enter_context(Rebind(
                owner, attr, lambda real, n=name: self._wrap_kernel(n, real)))


# the four hand kernels, in the accumulator's order
KERNELS = ["raster_depth", "raster_layers", "tonemap", "gradient"]
