"""Tiled depth rasterizer -> visibility buffer (the plan API).

Port of the records path of vk_renderer_tpu/ops/raster.py: bin once per
view (``plan_view_buckets``), build the tile-folded records once
(``prepare_records``), raster many times — the opaque z-buffer
(``rasterize_plan``, the CUDA kernel replacing raster_pallas._kernel) and
the k-buffer layers (``rasterize_plan_k_stacked``, the kernel
replacing raster_pallas._kernel_k).  The outputs are a visibility buffer:
depth plus the winning triangle id (-1 where uncovered); shading runs
deferred afterwards.

The JAX package's dense-bins XLA reference path is not ported: the port's
CPU path runs the kernels' plain PyTorch versions over the same records
(ops/raster_kernels.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import binning
from . import raster_kernels as rk
from .common import cdiv


@tracing.spanned("bin")
def plan_view_buckets(st: dict, bounds, width: int, height: int,
                      tile_w: int, tile_h: int, caps, rec_caps,
                      max_span: int = 16, big_cap: int = 512):
    """Bin every bucket of a view with one pair sort; returns a tuple of
    per-bucket plan dicts (occupancy-packed records).  ``rec_caps`` are
    record-count safety caps, shrunk to the scene's worst-case pair
    count (raster.py:79-86)."""
    n_tris = st["valid"].shape[-1]
    n_tiles = cdiv(width, tile_w) * cdiv(height, tile_h)
    # worst case: every pair lands in a distinct partial chunk (bbox
    # pairs + exact big pairs)
    worst = (cdiv(n_tris * max_span + big_cap * n_tiles, rk.CHUNK)
             + n_tiles + 1)
    rec_caps = tuple(min(rc, worst) for rc in rec_caps)
    return binning.bin_buckets_packed(
        st["bbox"], st["valid"], bounds, width, height, tile_w=tile_w,
        tile_h=tile_h, caps=caps, rec_caps=rec_caps, chunk=rk.CHUNK,
        max_span=max_span, big_cap=big_cap, edge=st["edge"],
        anchor=st["anchor"])


@tracing.spanned("records")
def prepare_records(plan: dict, setup_padded: dict, bbox, width: int,
                    tile_w: int, tile_h: int) -> dict:
    """Materialize the packed raster records for a plan.  Call once,
    raster many."""
    plan = dict(plan)
    plan["records"] = rk.build_records(setup_padded, bbox, plan["rec_tri"],
                                       plan["rec_tile"], cdiv(width, tile_w),
                                       tile_w, tile_h)
    return plan


def rasterize_plan(plan: dict, width: int, height: int, sentinel: int,
                   tile_w: int = 128, tile_h: int = 32):
    """Depth raster over a prepared plan from a cleared z-buffer: the
    CUDA kernel on the card, the plain version with the kernel's
    footprint cull on the CPU (rk.rasterize_depth_grid_culled, the same
    bits).  Returns (depth f32[H, W], tri_id i32[H, W], -1 = empty)."""
    return rk.rasterize_depth_packed(
        plan["records"], plan["rec_start"], plan["counts"], width, height,
        sentinel, tile_w=tile_w, tile_h=tile_h)


def rasterize_plan_k_stacked(plan: dict, sentinel: int, k_layers: int,
                             bound_t: torch.Tensor, tile_w: int = 128,
                             tile_h: int = 32,
                             floor_t: torch.Tensor | None = None,
                             counts: torch.Tensor | None = None):
    """The first ``k_layers`` strict depth-peel layers in TILE space:
    ``bound_t``/``floor_t`` are [n_tiles, th, tw] (row-major tile order)
    and the layers come back stacked, (depth f32, id i32)
    [k_layers, n_tiles, th, tw].  Layer k is the LESS_OR_EQUAL later-wins
    winner among fragments with z strictly behind layer k-1 and
    z <= bound (the opaque depth); with ``floor_t``, layer 0 also needs
    z > floor (the masked pass's continuation rounds).  ``counts``
    overrides the plan's per-tile counts (zeroed tiles stream nothing).
    Nearest first; (2.0, -1) where a layer is empty."""
    cnt = plan["counts"] if counts is None else counts
    d, i = rk.rasterize_layers_grid(
        plan["records"], plan["rec_start"], cnt.reshape(-1).contiguous(),
        bound_t.contiguous(),
        floor_t.contiguous() if floor_t is not None else None,
        sentinel, k_layers, tile_w=tile_w, tile_h=tile_h)
    return d, torch.where(i == sentinel, -1, i)


def pad_setup(setup: dict) -> dict:
    """Append the all-zero sentinel entry to each view's planes ([T] or
    [L, T] -> [..., T + 1]) so slot gathers at id==T are harmless (zero
    edges fail coverage everywhere).  Planar in/out."""
    def pad(p):
        return F.pad(p, (0, 1))

    return {
        "edge": [pad(p) for p in setup["edge"]],
        "zlin": [pad(p) for p in setup["zlin"]],
        "anchor": [pad(p) for p in setup["anchor"]],
    }
