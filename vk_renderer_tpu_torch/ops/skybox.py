"""Skybox pass — per-pixel ray-direction cubemap sampling (planar).

Port of vk_renderer_tpu/ops/skybox.py.  The reference rasterizes the
2x2x2 cube with the view's rotation only and ``gl_Position = pos.xyww``
so depth==1 everywhere (shaders/skybox.vert:8-17), drawn after opaque
geometry with LESS_OR_EQUAL so it fills exactly the pixels whose depth is
still at the clear value (vk_engine_run.cpp:313-332).  The sampled
direction equals the per-pixel eye ray in rotation-only world space, so no
geometry is needed: unproject each pixel, rotate by view^T, flip y
(skybox.vert:11), sample the cubemap.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from . import texture as tex
from .interp import pixel_centers


def skybox_colors_at(cubemap: torch.Tensor, view: torch.Tensor,
                     proj: torch.Tensor, px, py, width: int, height: int,
                     y_offset=0.0):
    """(r, g, b) cubemap colors at explicit pixel centers ``px``/``py``
    (any shape) of a ``width`` x ``height`` frame; ``y_offset`` places
    the pixels of a horizontal strip whose row 0 is frame row
    ``y_offset`` (the sharded path)."""
    ndc_x = px * (2.0 / width) - 1.0
    ndc_y = (py + y_offset) * (2.0 / height) - 1.0
    # view-space ray: clip.x = P00*xv, clip.y = P11*yv, w = -zv
    rx = ndc_x / proj[0, 0]
    ry = ndc_y / proj[1, 1]
    # world dir = R @ d_view = view[:3,:3]^T @ d_view (orthonormal camera)
    rot = view[:3, :3]
    dx = rot[0, 0] * rx + rot[1, 0] * ry - rot[2, 0]
    dy = rot[0, 1] * rx + rot[1, 1] * ry - rot[2, 1]
    dz = rot[0, 2] * rx + rot[1, 2] * ry - rot[2, 2]
    return tex.sample_cubemap(cubemap, dx, -dy, dz)   # UVW y flip


def skybox_colors(cubemap: torch.Tensor, view: torch.Tensor,
                  proj: torch.Tensor, height: int, width: int,
                  y_offset=0.0, full_height: int | None = None):
    """(r, g, b) planar [H, W] cubemap colors for every pixel of a
    ``height``-row strip at row ``y_offset`` of a ``full_height`` frame
    (the whole frame by default)."""
    full_height = height if full_height is None else full_height
    px, py = pixel_centers(height, width, cubemap.device)
    return skybox_colors_at(cubemap, view, proj, px, py, width, full_height,
                            y_offset)


@tracing.spanned("sky")
def composite_skybox(color, depth: torch.Tensor, cubemap: torch.Tensor,
                     view: torch.Tensor, proj: torch.Tensor,
                     sparse_cap: int | None = None, y_offset=0.0,
                     full_height: int | None = None):
    """Overwrite pixels still at clear depth (>= 1.0) with the skybox
    (depth LESS_OR_EQUAL at z=1, write off).  color: (r, g, b) planar;
    ``y_offset`` / ``full_height`` locate a horizontal strip within the
    full frame (the sharded path).  Returns (color, overflow).

    Only the sky pixels are sampled and written, whatever the cap (the
    JAX package's tier ladder of compacted lists, skybox.py:96-114, is
    its TPU form of the same selection, with a dense fallback beyond the
    cap).  ``overflow`` counts the sky pixels beyond ``sparse_cap`` as
    the JAX function does — a cap-sizing signal (the frame's
    ``fallback_px``); the image never depends on it."""
    h, w = depth.shape
    full_height = h if full_height is None else full_height
    mask = depth >= 1.0
    sel = torch.nonzero(mask.reshape(-1)).squeeze(1)
    n_sky = sel.numel()
    overflow = torch.tensor(
        0 if sparse_cap is None else max(n_sky - sparse_cap, 0),
        dtype=torch.int32, device=depth.device)
    if n_sky == 0:
        return tuple(color), overflow
    px = (sel % w).to(torch.float32) + 0.5
    py = (sel // w).to(torch.float32) + 0.5
    sky = skybox_colors_at(cubemap, view, proj, px, py, w, full_height,
                           y_offset)
    out = []
    for c, s in zip(color, sky):
        c = c.reshape(-1).clone()
        c[sel] = s
        out.append(c.reshape(h, w))
    return tuple(out), overflow
