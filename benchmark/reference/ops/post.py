"""Post/background: gradient clear and Reinhard tonemap, plain PyTorch.

A frozen copy of the plain versions in the port's ops/post.py, kept by
the benchmark as its reference:
- shaders/gradient_color.comp:16-31 — vertical ``mix(top, bottom, y/H)``,
- shaders/tonemap.comp:9-22 — Reinhard ``c/(c+1)`` then ``x^(1/2.2)``.
Images are planar ``f32[3, H, W]``.
"""

from __future__ import annotations


import torch

INV_GAMMA = 1.0 / 2.2  # tonemap.comp:18


def gradient_xla(h: int, w: int, top: torch.Tensor, bottom: torch.Tensor,
                 extent_h: int | None = None) -> torch.Tensor:
    """Vertical gradient image, f32[3, h, w]; ``blend = y / extent_h``
    (gradient_color.comp:27 divides by the full image height, not
    height-1).  ``extent_h`` defaults to ``h`` — pass the unpadded height
    when the framebuffer is padded."""
    extent_h = h if extent_h is None else extent_h
    blend = (torch.arange(h, dtype=torch.float32, device=top.device)
             / extent_h)[None, :, None]
    top = top[:3].to(torch.float32).reshape(3, 1, 1)
    bottom = bottom[:3].to(torch.float32).reshape(3, 1, 1)
    return (top * (1.0 - blend) + bottom * blend).expand(3, h, w)


def tonemap_xla(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma 2.2 (tonemap.comp:16-19), the pow form."""
    mapped = color / (color + 1.0)
    return torch.pow(mapped, INV_GAMMA)


def gradient_plain(h: int, w: int, top: torch.Tensor, bottom: torch.Tensor,
                   extent_h: int | None = None,
                   row0: int = 0) -> torch.Tensor:
    """Plain version of ``gradient``: the kernel's own form
    ``top * (1 - y * inv_h) + bottom * (y * inv_h)`` with
    ``inv_h = f32(1 / extent_h)`` (post.py:53-58 multiplies by the
    reciprocal where gradient_xla divides) and ``y`` the frame row,
    ``row0`` plus the image row.  Returns a contiguous f32[3, h, w]."""
    extent_h = h if extent_h is None else extent_h
    inv_h = torch.tensor(1.0 / extent_h, dtype=torch.float32)
    blend = (torch.arange(row0, row0 + h, dtype=torch.float32,
                          device=top.device) * inv_h)[None, :, None]
    top = top[:3].to(torch.float32).reshape(3, 1, 1)
    bottom = bottom[:3].to(torch.float32).reshape(3, 1, 1)
    return (top * (1.0 - blend) + bottom * blend).expand(3, h, w) \
        .contiguous()


def tonemap_plain(color: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tonemap``: the kernel's own form
    ``exp(log(c / (c + 1)) * INV_GAMMA)`` (post.py:102-104), which differs
    from tonemap_xla's pow by up to ~4e-5.  Zero maps to 0."""
    mapped = color / (color + 1.0)
    return torch.exp(torch.log(mapped) * INV_GAMMA)


tonemap = tonemap_plain
gradient = gradient_plain
