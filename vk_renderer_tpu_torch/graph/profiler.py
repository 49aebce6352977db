"""Per-pass timing breakdown of one frame.

Port of vk_renderer_tpu/graph/profiler.py (``profile_passes``,
``format_table``).  Each render stage runs on its own over the previous
stage's outputs — the same entry points graph/frame.py chains — and is
timed as the median wall time of ``iters`` runs.  On a CUDA scene one
warm-up run comes first (the kernels' first build, the allocator) and
each run is closed by ``torch.cuda.synchronize()``, so the time covers
the stage's device work.  Stage names and order are the JAX
profiler's: setup, bin, records, raster_opaque, masked_kraster0, masked,
gbuffer, shadow, shade (the classifier tables and the classified filter
included), compose, transparent, tonemap, then the whole frame as
``full_frame``.  A stage the scene or config does not run (no masked or
transparent triangles, shadows compiled out) is left out.
"""

from __future__ import annotations

import time

import torch

from ..ops import raster
from ..ops.common import cdiv, to_tiles
from . import frame as F


def _timed(fn, iters: int, sync: bool):
    """(median ms over ``iters`` runs, last output); ``sync``: CUDA, warm
    up once and synchronise after each run."""
    if sync:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1000.0 * times[len(times) // 2], out


def profile_passes(scene, scene_data: dict, settings: dict,
                   cfg: F.FrameConfig, iters: int = 5) -> dict:
    """Return {stage_name: ms} for one frame's stages, in pass order, plus
    ``full_frame`` (render_frame end to end).  ``scene_data`` and
    ``settings`` are render_frame's tensors (driver.frame_inputs)."""
    w, h = cfg.width, cfg.height
    n_tris = scene.num_triangles
    sync = scene.positions[0].device.type == "cuda"
    timings: dict[str, float] = {}

    def stage(name, fn):
        timings[name], out = _timed(fn, iters, sync)
        return out

    view = stage("setup", lambda: F.view_setup(scene, scene_data, cfg))
    st, padded = view["st"], view["padded"]
    rows, vattr, vpos = view["rows"], view["vattr"], view["vpos"]
    plans = stage("bin", lambda: F.plan_view(scene, st, cfg))
    plans = stage("records", lambda: [
        raster.prepare_records(p, padded, st["bbox"], w, cfg.tile_w,
                               cfg.tile_h) for p in plans])
    plan_o = plans.pop(0)
    depth, tid = stage("raster_opaque", lambda: raster.rasterize_plan(
        plan_o, w, h, n_tris, tile_w=cfg.tile_w, tile_h=cfg.tile_h))

    if scene.n_masked_vis > 0:
        plan_m = plans.pop(0)
        bound_t = to_tiles(depth, cdiv(h, cfg.tile_h), cdiv(w, cfg.tile_w),
                           cfg.tile_h, cfg.tile_w, 2.0)
        stage("masked_kraster0", lambda: raster.rasterize_plan_k_tiled(
            plan_m, n_tris, cfg.masked_peels, bound_t, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h))
        depth_o, tid_o = depth, tid
        depth, tid, _ = stage("masked", lambda: F._masked_pass(
            scene, cfg, plan_m, rows, vattr, depth_o, tid_o))

    gbuf = stage("gbuffer", lambda: F._build_gbuffer(
        scene, scene_data, tid, rows, vattr, vpos))

    if cfg.enable_shadows:
        shadow_maps = stage("shadow", lambda: F.shadow_pass(
            scene, scene_data, cfg)[0])
    else:
        shadow_maps = F.shadow_pass(scene, scene_data, cfg)[0]

    def shade_stage():
        coarse = F._build_classifier_tables(shadow_maps, cfg)
        return F.shade_view(gbuf, scene, scene_data, cfg, shadow_maps,
                            coarse)[0], coarse

    rgb, coarse = stage("shade", shade_stage)
    color, _ = stage("compose", lambda: F.compose(
        rgb, tid, depth, scene, scene_data, settings, cfg))

    if scene.n_transparent > 0:
        plan_t = plans.pop(0)
        color_o = color
        color = stage("transparent", lambda: F._transparent_pass(
            scene, scene_data, cfg, plan_t, rows, vattr, vpos, depth,
            shadow_maps, color_o, shadow_coarse=coarse)[0])

    stage("tonemap", lambda: F.post_chain(color, settings, cfg))
    stage("full_frame", lambda: F.render_frame(scene, scene_data, settings,
                                               cfg))
    return timings


def format_table(timings: dict) -> str:
    """The timings as a text table, with the stage sum beside the whole
    frame (stages run on their own, so the two differ)."""
    total = sum(v for k, v in timings.items() if k != "full_frame")
    lines = ["per-pass ms (stages run on their own; the frame differs):"]
    for k, v in timings.items():
        if k == "full_frame":
            continue
        lines.append(f"  {k:<16} {v:9.2f} ms")
    lines.append(f"  {'stage sum':<16} {total:9.2f} ms")
    lines.append(f"  {'full_frame':<16} {timings['full_frame']:9.2f} ms")
    return "\n".join(lines)
