"""The control: the reference with its stages rounded to bfloat16.

The configurations state float32 throughout.  The nearest precision below
is bfloat16, the step a faster program would be tempted to take: inside
``bf16_stages()`` the reference's vertex stage (world and clip
coordinates, which feed the raster setup and the shadow maps) and its
shaded colour leave their stage rounded to bfloat16.  The benchmark's
comparison must call a frame rendered so not correct.
"""

from __future__ import annotations

import contextlib

import torch

from .ops import setup as rsetup
from .ops import shade


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def bf16_stages():
    transform, shade_pbr = rsetup.transform_vertices, shade.shade_pbr

    def transform_bf16(*args, **kw):
        world, clip = transform(*args, **kw)
        return (tuple(_bf16(c) for c in world), tuple(_bf16(c) for c in clip))

    def shade_bf16(*args, **kw):
        out = shade_pbr(*args, **kw)
        return (tuple(_bf16(c) for c in out[0]),) + tuple(out[1:])

    rsetup.transform_vertices, shade.shade_pbr = transform_bf16, shade_bf16
    try:
        yield
    finally:
        rsetup.transform_vertices, shade.shade_pbr = transform, shade_pbr
