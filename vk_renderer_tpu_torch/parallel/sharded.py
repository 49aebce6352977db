"""Sharded strips: the frame rendered as n horizontal strips.

Port of vk_renderer_tpu/parallel/sharded.py, which shards the frame's
rows over a device mesh with ``shard_map``.  The key fact carries over:
rendering rows [y0, y0 + h') of an H-row viewport is rendering a whole
h'-row viewport through a row-remapped projection

    y'_clip = (H / h') * y_clip + ((H - 2 * y0) / h' - 1) * w_clip

(``_row_slice_matrix``), so each strip runs the unmodified single-frame
pipeline.  Per strip:

- culling and the vertex stage take the whole camera frustum;
- the strip rasters its rows of every shadow cascade through
  row-remapped light matrices, and ``gather`` joins all strips' rows
  into the full pair-packed maps (shading samples them anywhere); the
  classifier tables are built after the gather;
- camera raster, shading, background, skybox and post run on the strip,
  which knows its place in the frame (``y_offset``, ``full_height``);
- stats are summed over the strips.

Two entry points, in PyTorch's own idiom:

- ``render_strip`` is one strip of an n-strip frame, ``gather`` the
  caller's;
- ``render_frame_sharded`` renders every strip.  With a
  ``torch.distributed`` process group, rank r renders strip r: the
  shadow strips and the frame's colour, depth and u8 strips are
  ``all_gather``-ed along rows and ``stats_vec`` is ``all_reduce``-d, so
  every rank returns the assembled frame (as the JAX out-sharding lays
  the strips out).  Without a group the strips render in turn on the
  scene's device and concatenation takes the all-gather's place.

Everything renders on the scene's device (CUDA unless the caller built
the scene on the CPU), and the collectives run on the tensors where they
lie.  The group's backend is the caller's: ``nccl`` takes one card per
rank; ``gloo`` serves CPU worlds and takes CUDA tensors too, so a world
of several processes can share one card.  A backend that refuses the
tensors raises, naming itself.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from ..graph import frame as framelib
from ..graph.frame import STATS_KEYS, FrameConfig


def _row_slice_matrix(mat: torch.Tensor, y0: int, full_h: int,
                      slice_h: int) -> torch.Tensor:
    """Fold the strip viewport [y0, y0 + slice_h) of a full_h-row target
    into the projection (module docstring); row 1 only, in the JAX
    function's f32 order (``y0`` enters as an f32 value)."""
    scale = full_h / slice_h
    y0 = torch.tensor(float(y0), dtype=torch.float32, device=mat.device)
    shift = (full_h - 2.0 * y0) / slice_h - 1.0
    out = mat.clone()
    out[1] = mat[1] * scale + mat[3] * shift
    return out


def _strip_shape(cfg: FrameConfig, n: int):
    assert cfg.height % n == 0, "frame height must divide across the strips"
    assert cfg.shadow_size % n == 0, \
        "shadow size must divide across the strips"
    return cfg.height // n, cfg.shadow_size // n


def shadow_strip(scene, scene_data: dict, cfg: FrameConfig, index: int,
                 n: int):
    """Strip ``index`` of every rastered shadow cascade: (pair-packed
    i32[L, S/n, S] rows, bin overflow), or the 1x1 placeholder maps and
    None with shadows compiled out (nothing to gather then)."""
    _, shadow_h = _strip_shape(cfg, n)
    if not cfg.enable_shadows:
        return framelib.shadow_pass(scene, scene_data, cfg)
    lvp = torch.stack([
        _row_slice_matrix(m, index * shadow_h, cfg.shadow_size, shadow_h)
        for m in scene_data["light_viewproj"]])
    return framelib.shadow_pass(scene, scene_data, cfg, light_viewproj=lvp,
                                out_h=shadow_h)


def view_strip(scene, scene_data: dict, settings: dict, cfg: FrameConfig,
               index: int, n: int, shadow_maps, shadow_ovf=None):
    """Strip ``index`` of the camera view over the full shadow maps: the
    render_view output dict of a cfg.height/n-row frame."""
    strip_h, _ = _strip_shape(cfg, n)
    y0 = index * strip_h
    sd = dict(scene_data)
    sd["viewproj"] = _row_slice_matrix(scene_data["viewproj"], y0,
                                       cfg.height, strip_h)
    coarse = framelib._build_classifier_tables(shadow_maps, cfg)
    return framelib.render_view(scene, sd, settings,
                                replace(cfg, height=strip_h), shadow_maps,
                                y_offset=y0, full_height=cfg.height,
                                shadow_coarse=coarse,
                                extra_bin_overflow=shadow_ovf)


def render_strip(scene, scene_data: dict, settings: dict, cfg: FrameConfig,
                 index: int, n: int, gather):
    """One strip of an ``n``-strip frame (the body of the JAX ``step``):
    its shadow strips, ``gather(strips)`` -> the full pair-packed maps
    (all strips' rows in strip order), then the view strip.  Returns the
    strip's render_view dict; its stats are the strip's own."""
    strips, ovf = shadow_strip(scene, scene_data, cfg, index, n)
    maps = gather(strips) if cfg.enable_shadows else strips
    return view_strip(scene, scene_data, settings, cfg, index, n, maps, ovf)


def _assemble(parts: list) -> dict:
    vec = torch.stack([p["stats_vec"] for p in parts]).sum(0,
                                                           dtype=torch.int32)
    return _frame(torch.cat([p["color"] for p in parts], 1),
                  torch.cat([p["depth"] for p in parts], 0),
                  torch.cat([p["color_u8"] for p in parts], 0), vec)


def _frame(color, depth, color_u8, stats_vec) -> dict:
    return {"color": color, "depth": depth, "color_u8": color_u8,
            "stats": {k: stats_vec[i] for i, k in enumerate(STATS_KEYS)},
            "stats_vec": stats_vec}


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t``, in rank order, joined along ``dim``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _collective(dist.all_gather, parts, t, group=group)
    return torch.cat(parts, dim)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``."""
    t = t.clone()
    _collective(dist.all_reduce, t, op=dist.ReduceOp.SUM, group=group)
    return t


def _collective(fn, *args, group, **kw):
    try:
        fn(*args, group=group, **kw)
    except RuntimeError as err:
        raise RuntimeError(f"backend {dist.get_backend(group)!r}: "
                           f"{fn.__name__} failed: {err}") from err


def render_frame_sharded(scene, scene_data: dict, settings: dict,
                         cfg: FrameConfig, group=None, n: int | None = None):
    """The sharded equivalent of frame.render_frame; ``cfg`` describes the
    FULL frame, whose height and shadow size must divide by the strip
    count.  With ``group`` (a torch.distributed process group; pass
    ``dist.group.WORLD`` for the default one) the strips are the group's
    ranks and ``n`` must be None or its size; without, ``n`` strips
    render in turn.  Returns render_frame's dict (color,
    depth, stats, stats_vec, color_u8) for the whole frame."""
    if group is None:
        if n is None:
            raise ValueError("render_frame_sharded needs n strips or a "
                             "process group")
        strips = [shadow_strip(scene, scene_data, cfg, i, n)
                  for i in range(n)]
        maps = (torch.cat([s for s, _ in strips], 1) if cfg.enable_shadows
                else strips[0][0])
        return _assemble([view_strip(scene, scene_data, settings, cfg, i,
                                     n, maps, ovf)
                          for i, (_, ovf) in enumerate(strips)])
    ranks = dist.get_world_size(group)
    if n is not None and n != ranks:
        raise ValueError(f"n={n} but the group has {ranks} ranks")
    part = render_strip(scene, scene_data, settings, cfg,
                        dist.get_rank(group), ranks,
                        lambda strips: _all_gather(strips, 1, group))
    return _frame(_all_gather(part["color"], 1, group),
                  _all_gather(part["depth"], 0, group),
                  _all_gather(part["color_u8"], 0, group),
                  _all_reduce(part["stats_vec"], group))
