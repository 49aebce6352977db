"""Post/background: gradient clear and Reinhard tonemap (plain torch).

Port of the XLA forms in vk_renderer_tpu/ops/post.py, which replace the
reference's two compute shaders:
- shaders/gradient_color.comp:16-31 — vertical ``mix(top, bottom, y/H)``,
- shaders/tonemap.comp:9-22 — Reinhard ``c/(c+1)`` then ``x^(1/2.2)``.

The JAX package's Pallas kernels for these two (``_gradient_kernel``,
``_tonemap_kernel``) are off the frame's path (the frame registers
``tonemap_xla`` and inlines the gradient) and are not ported yet.
Images are planar ``f32[3, H, W]``.
"""

from __future__ import annotations

import torch

INV_GAMMA = 1.0 / 2.2  # tonemap.comp:18


def gradient_xla(h: int, w: int, top: torch.Tensor,
                 bottom: torch.Tensor) -> torch.Tensor:
    """Vertical gradient image, f32[3, h, w]; ``blend = y / h``
    (gradient_color.comp:27)."""
    blend = (torch.arange(h, dtype=torch.float32, device=top.device)
             / h)[None, :, None]
    top = top[:3].to(torch.float32).reshape(3, 1, 1)
    bottom = bottom[:3].to(torch.float32).reshape(3, 1, 1)
    return (top * (1.0 - blend) + bottom * blend).expand(3, h, w)


def tonemap_xla(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma 2.2 (tonemap.comp:16-19), the pow form the JAX
    frame registers."""
    mapped = color / (color + 1.0)
    return torch.pow(mapped, INV_GAMMA)
