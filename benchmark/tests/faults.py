"""Faults planted under the timed path, for the harness's CPU tests:
each breaks the program where it produces its answer, and the run has
to come out not correct.  Each is a context manager around a run."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def stale_frame():
    """The frame returns its state unchanged: every frame after the first
    hands back the first frame's output."""
    from vk_renderer_tpu_torch.graph import driver
    first = {}

    def make(real):
        def render(*args, **kw):
            if "out" not in first:
                first["out"] = real(*args, **kw)
            return first["out"]
        return render
    return patched(driver, "render", make)


def altered_pixel():
    """One answer altered where it is produced: one pixel of the frame's
    color_u8 moved by 40."""
    from vk_renderer_tpu_torch.graph import frame

    def make(real):
        def to_u8(color):
            out = real(color).clone()
            out[0, 0] = (out[0, 0].int() + 40).clamp(0, 255).to(out.dtype)
            return out
        return to_u8
    return patched(frame, "_to_u8_device", make)


def half_the_cascades():
    """Half of the work left out: the shadow pass renders two of the four
    cascades."""
    from dataclasses import replace

    from vk_renderer_tpu_torch.graph import frame

    def make(real):
        def render_shadow_maps(scene, world_pos, tri_visible, lvp, cfg,
                               out_h=None):
            return real(scene, world_pos, tri_visible, lvp,
                        replace(cfg, shadow_cascades=2), out_h=out_h)
        return render_shadow_maps
    return patched(frame, "render_shadow_maps", make)

