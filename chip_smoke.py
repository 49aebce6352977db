#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vk_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:
  1. card: the GPU's name and power limit (nvidia-smi),
  2. build: compile csrc/raster.cu and csrc/post.cu for sm_90a from this
     checkout, one nvcc per source, both started together,
  3. scene: load the committed Sponza replica (assets/sponza_replica);
     the procedural 260k-triangle sponza_like scene is built after phase 5
     (its own scene line),
  4. frame: the bench frame — driver.render at 1920x1080, CSM mode 3,
     skybox, tonemap, at the bench camera — one warm-up frame, then the
     mean of the timed frames, with every kernel's launch count over that
     run; bin/peel/sparse overflow must be 0,
  5. kernels: each CUDA kernel on the bench frame's own inputs (camera
     opaque records at 1080p and all four 2048^2 cascades for the depth
     raster, masked rounds 0 and 1 for the k-buffer, the frame's HDR
     colour for the tonemap, the frame's background colours at 1920x1080
     for the gradient) and both raster kernels on a heavy synthetic
     stream (one 128x32 tile of 3,100 records, tests/raster_streams.py)
     against its plain PyTorch version — the raster kernels bit for bit,
     the post kernels within 2 ulp — with both times, the bound (the
     least time the card could take for the same work), and for the
     raster kernels the largest record count of one tile and of one
     8-row band and the spread of their blocks' times (%globaltimer),
  6. classifier: the shadow classifier's call of the bench frame
     (shade.classified_shadow_factor's arguments, recorded in phase 4)
     run again beside the dense filter on the same inputs: the factors
     must be equal bit for bit on the active pixels (the classified
     factor is 0 elsewhere); the lit, blocked, uncertain and inactive
     pixel counts, the cap and both times,
  7. exactness: the 1080p bench frame with the default classified shadows
     against the same frame with the dense filter (shadow_classify_cap
     = 0), frames alternated dense, classified, classified, dense: equal
     u8 images (PSNR inf), equal stats but fallback_px, overflow counters
     0, and both frame times,
  8. passes: graph/profiler.profile_passes on the bench frame, classified
     and dense, each printed as one line of stage -> ms,
  9. parity: 480x272 frames rendered with the kernels against the same
     frames rendered with all four plain versions (PSNR >= 40 dB): the
     bench frame, and a transparent + flat-shaded sponza_like frame,
 10. reference: the glTF test fixture (MASK material, CSM shadows, skybox)
     at 256x128 on the GPU against the port's CPU path, which the CPU
     tests hold against the JAX package's goldens (PSNR >= 40 dB, equal
     stats),
 11. transparent: sponza_like at 1920x1080, CSM mode 3, background and
     tonemap, from a camera facing a transparent pane — transparent layer
     0 must cover pixels, every overflow counter must be 0; then the
     k-buffer kernel against its plain version on that pass's K=3 call,
 12. headless: the CLI's main() on sponza_like at 1080p (3 frames) and on
     the flat-shaded cube; each must return 0 with overflow counters 0.
Phases 4, 7, 8, 11 and 12 each set every kernel's launch count to 0 just
before they run and read the counts just after; a kernel of that path
that never launched fails the run.  Then one {"kernels": [...]} line, the
card line as nvidia-smi prints it, and last {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when there is no CUDA device or the package
is missing, and non-zero after any failed phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

WIDTH, HEIGHT, SHADOW_SIZE = 1920, 1080, 2048
PARITY_W, PARITY_H, PARITY_SHADOW = 480, 272, 1024
TIMED_FRAMES = 5
EXACT_FRAMES = 2          # per shadow path, in each half of the alternation
PROFILE_ITERS = 5
TRANSPARENT_FRAMES = 3
KERNEL_REPS = 10
POST_ULP = 2
HEAVY_RECORDS = 3100
RASTER_SRC = "vk_renderer_tpu_torch/csrc/raster.cu"
POST_SRC = "vk_renderer_tpu_torch/csrc/post.cu"
FIXTURE = "tests/fixtures/textured_box/scene.gltf"
# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit):
# HBM3 bandwidth and the f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations of one record at one pixel: three edge planes and the
# depth plane (2 multiplies + 2 adds each) and the edge sum (2 adds)
RASTER_OPS = 4 * 4 + 2
# per tonemap element: add, divide, log, multiply, exp
TONEMAP_OPS = 5
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "raster_depth": (RASTER_SRC, "vk_renderer_tpu/ops/raster_pallas.py:50"),
    "raster_layers": (RASTER_SRC,
                      "vk_renderer_tpu/ops/raster_pallas.py:147"),
    "tonemap": (POST_SRC, "vk_renderer_tpu/ops/post.py:101"),
    "gradient": (POST_SRC, "vk_renderer_tpu/ops/post.py:47"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


def ptxas_report(log: str) -> dict:
    """Registers and spilled bytes (stores + loads) of every kernel in an
    ``nvcc -Xptxas -v`` log, by kernel name and template arguments."""
    kernels = ("raster_depth_kernel", "raster_layers_kernel",
               "plan_segments", "tonemap_kernel", "gradient_kernel")
    pattern = re.compile(r"(%s)(I(?:Li\d+E)+E)?" % "|".join(kernels))
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = pattern.search(ln)
            args = re.findall(r"Li(\d+)E", m.group(2) or "") if m else []
            name = (m.group(1) + (f"<{','.join(args)}>" if args else "")
                    if m else ln.split("'")[1])
            spill = 0
        elif "spill stores" in ln:
            spill = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill", ln))
        elif "registers" in ln and name is not None:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            out[name] = {"registers": regs, "spill_bytes": spill}
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` launches captured
    in one CUDA graph and replayed (after a warm-up replay), so the time
    is the kernels' back to back on the device, without the host's
    per-call launch cost that cuda_ms includes."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


class Recorder:
    """Wraps a kernel wrapper held in a module attribute or a dict entry
    to keep the arguments of its calls (the frame's own kernel inputs)."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.real = self._get()
        self.calls = []

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
        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.real(*args, **kw)
        self._set(record)
        return self

    def __exit__(self, *exc):
        self._set(self.real)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = n_ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


def _live_records(args):
    """(tile of each live record slot, its f32 row-range field) of one
    raster kernel call's record stream."""
    import torch
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    records, rec_start, counts = args[0], args[1], args[2]
    n_tiles = counts.shape[0]
    chunks = (counts.long() + rk.CHUNK - 1) // rk.CHUNK
    slot_tile = torch.repeat_interleave(torch.arange(n_tiles,
                                                     device=counts.device),
                                        chunks * rk.CHUNK)
    first = (rec_start.long() * rk.CHUNK)[slot_tile]
    local = torch.arange(slot_tile.numel(), device=counts.device) - \
        torch.repeat_interleave(torch.cumsum(chunks * rk.CHUNK, 0)
                                - chunks * rk.CHUNK, chunks * rk.CHUNK)
    live = local < counts.long()[slot_tile]
    rr = records.reshape(-1, rk.F_FIELDS)[first + local, 13].to(torch.int64)
    return slot_tile[live], rr[live], chunks


def raster_work(args, outputs_per_px: int):
    """(bytes, operations) one raster kernel call needs on these inputs:
    each tile's records read once, the per-tile and per-pixel inputs read
    once, the outputs written once; per record, the pixels of the tile
    rows its triangle spans (the record's row range) times RASTER_OPS.
    That count is conservative for the culling kernels, which evaluate a
    record only on the 8x4 footprints it may cover."""
    import torch
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    planes = [a for a in args[3:5] if isinstance(a, torch.Tensor)]
    n_tiles, th, tw = planes[0].shape
    _, rr, chunks = _live_records(args)
    rows = torch.clamp((rr & 255) - (rr >> 8), min=0)
    ops = float(rows.sum()) * tw * RASTER_OPS
    px = n_tiles * th * tw
    n_bytes = (float(chunks.sum()) * rk.CHUNK * rk.F_FIELDS * 4
               + 8 * n_tiles + 4 * px * len(planes) + outputs_per_px * px)
    return n_bytes, ops


def band_records_max(args) -> int:
    """The most records one 8-row band of one tile must walk (records
    whose row range meets the band): the work of the heaviest blocks."""
    import torch
    tile, rr, _ = _live_records(args)
    th = args[3].shape[1]
    r0, r1 = rr >> 8, rr & 255
    best = 0
    for lo in range(0, th, 8):
        hit = (r1 > lo) & (r0 < lo + 8)
        if bool(hit.any()):
            best = max(best, int(torch.bincount(tile[hit]).max()))
    return best


def block_spread(kernel_fn, args, kw) -> dict:
    """Per-block times of one launch (%globaltimer, microseconds): the
    median, the 99th percentile and the largest, and the launch's span
    from the first block's start to the last block's end."""
    import torch
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    ns = rk.kernel_block_ns(kernel_fn, *args, **kw)
    torch.cuda.synchronize()
    took = (ns[:, 1] - ns[:, 0]).double() / 1e3
    q = torch.quantile(took, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                          device=took.device))
    return {"blocks": int(ns.shape[0]), "block_us_p50": float(q[0]),
            "block_us_p99": float(q[1]), "block_us_max": float(took.max()),
            "span_us": float(ns[:, 1].max() - ns[:, 0].min()) / 1e3}


def compare_raster(name, shape_tag, kernel_fn, plain_fn, args, kw,
                   outputs_per_px):
    """Kernel vs plain version on the same inputs: bit-for-bit check of
    depth (as int32 bits, so -0.0 and +0.0 differ) and ids, max |depth
    difference|, both times, the bound, the heaviest tile's and band's
    record counts and the spread of the kernel's block times."""
    import torch
    kd, ki = kernel_fn(*args, **kw)
    pd, pi = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(kd.view(torch.int32), pd.view(torch.int32))
                and torch.equal(ki, pi))
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    id_mismatch = int((ki != pi).sum())
    ms = graph_ms(lambda: kernel_fn(*args, **kw), KERNEL_REPS)
    ms_eager = cuda_ms(lambda: kernel_fn(*args, **kw), KERNEL_REPS)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 1)
    out = {"phase": "kernel_check", "kernel": name, "input": shape_tag,
           "tiles": int(args[2].shape[0]),
           "records": int(args[0].shape[0]),
           "max_count": int(args[2].max()) if args[2].numel() else 0,
           "max_band_records": band_records_max(args),
           "bit_exact": same, "max_abs_err": err, "max_ulp": None,
           "id_mismatches": id_mismatch, "ms": ms, "ms_eager": ms_eager,
           "plain_ms": plain_ms,
           **bound(*raster_work(args, outputs_per_px)), "library_ms": None,
           **block_spread(kernel_fn, args, kw)}
    emit(out)
    return out


def compare_post(name, shape_tag, kernel_fn, plain_fn, args, n_bytes,
                 n_ops):
    """Kernel vs plain version on the same inputs: max ulp and max
    |difference| (NaN where both are NaN counts as equal), both times and
    the bound."""
    import torch
    from vk_renderer_tpu_torch.ops.common import max_ulp
    k = kernel_fn(*args)
    p = plain_fn(*args)
    torch.cuda.synchronize()
    finite = torch.isfinite(k) & torch.isfinite(p)
    err = float((k - p)[finite].abs().max()) if bool(finite.any()) else 0.0
    out = {"phase": "kernel_check", "kernel": name, "input": shape_tag,
           "bit_exact": bool(torch.equal(k, p)), "max_ulp": max_ulp(k, p),
           "max_abs_err": err,
           "ms": graph_ms(lambda: kernel_fn(*args), KERNEL_REPS),
           "ms_eager": cuda_ms(lambda: kernel_fn(*args), KERNEL_REPS),
           "plain_ms": cuda_ms(lambda: plain_fn(*args), 1),
           **bound(n_bytes, n_ops), "library_ms": None}
    emit(out)
    return out


def check_classifier(args, kw) -> dict:
    """One classified_shadow_factor call (its recorded arguments) against
    the dense filter on the same inputs: bit-exact on the active pixels
    (covered and sun-facing; the classified factor is 0 elsewhere), the
    classifier's pixel counts, the cap and both times."""
    import torch
    from vk_renderer_tpu_torch.ops import shade
    maps, coarse, gbuf, sd, mode, enable, ndl, cap = args
    fine = kw.get("shadow_fine")
    got, ovf = shade.classified_shadow_factor(*args, **kw)

    def dense():
        return shade.compute_shadow_factor(maps, gbuf["wx"], gbuf["wy"],
                                           gbuf["wz"], gbuf["view_z"], sd,
                                           mode, enable)

    want = dense()
    active = gbuf["covered"] & (ndl > 0.0)
    same = torch.equal(got.view(torch.int32),
                       torch.where(active, want, 0.0).view(torch.int32))
    su, sv, sz, layer = shade.shadow_coords(gbuf["wx"], gbuf["wy"],
                                            gbuf["wz"], gbuf["view_z"], sd,
                                            mode)
    lit, blk = shade._classify_shadow(
        coarse, su, sv, sz, layer, maps.shape[-1], mode,
        shadow_rows=maps if kw.get("quad_lit", True) else None,
        shadow_fine=fine)
    n_active = int(active.sum())
    n_lit, n_blk = int((active & lit).sum()), int((active & blk).sum())
    return {"phase": "classifier", "shadow_mode": mode,
            "pixels": ndl.numel(), "inactive_px": ndl.numel() - n_active,
            "lit_px": n_lit, "blocked_px": n_blk,
            "uncertain_px": n_active - n_lit - n_blk,
            "uncertain_share": (n_active - n_lit - n_blk) / ndl.numel(),
            "cap": cap, "overflow": int(ovf),
            "coarse_cells": list(coarse.shape),
            "fine_cells": list(fine.shape) if fine is not None else None,
            "bit_exact": same,
            "max_abs_err": float(torch.where(active, (got - want).abs(),
                                             0.0).max()),
            "classified_ms": cuda_ms(
                lambda: shade.classified_shadow_factor(*args, **kw), 5),
            "dense_ms": cuda_ms(dense, 5)}


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the GPU port "
                    "and has no CPU fallback")
    try:
        import numpy as np
        from vk_renderer_tpu_torch.app import headless
        from vk_renderer_tpu_torch.graph import driver, frame, profiler
        from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
        from vk_renderer_tpu_torch.ops import post, shade
        from vk_renderer_tpu_torch.ops import raster_kernels as rk
        from vk_renderer_tpu_torch.ops.common import cdiv, from_tiles
        from vk_renderer_tpu_torch.scene import ktx, procedural
        from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
        from vk_renderer_tpu_torch.scene.camera import Camera
        from vk_renderer_tpu_torch.scene.types import scene_to_torch
        from vk_renderer_tpu_torch.utils.image import psnr
        sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
        from raster_streams import heavy_stream
    except ImportError as e:
        return fail(f"the port's package is missing ({e}); run from the "
                    "root of a checkout")
    if "jax" in sys.modules:
        return fail("the port imported jax")

    failures = []
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    wrappers = {"raster_depth": rk.rasterize_depth_grid,
                "raster_layers": rk.rasterize_layers_grid,
                "tonemap": post.tonemap, "gradient": post.gradient}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def gate_launches(path, counts, names):
        for name in names:
            if counts[name] == 0:
                failures.append(f"{name} never launched on the {path} path")

    def gate_stats(path, stats):
        for key in ("bin_overflow", "peel_overflow", "sparse_overflow"):
            if stats[key] != 0:
                failures.append(f"{path} {key} = {stats[key]}")

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    emit({"phase": "card", "nvidia_smi": card_line, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = {src: pool.submit(mod.build_kernels)
                       for src, mod in ((RASTER_SRC, rk), (POST_SRC, post))}
            libs = {src: f.result() for src, f in futures.items()}
        ptxas = {}
        for src, lib_path in libs.items():
            log = os.path.splitext(lib_path)[0] + ".log"
            if os.path.exists(log):
                with open(log) as f:
                    ptxas[src] = ptxas_report(f.read())
        emit({"phase": "build", "ok": True, "sources": list(libs),
              "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    except Exception as e:   # a build failure ends the run
        emit({"phase": "build", "ok": False, "error": str(e)[-2000:]})
        return fail("kernel build failed")

    # ---- 3. scenes
    t0 = time.perf_counter()
    b = SceneBuilder()
    b.load_gltf("assets/sponza_replica/Sponza.glb", "sponza")
    b.cubemap = ktx.load_cubemap("assets/sponza_replica/pisa_cube.ktx")
    host = b.build()
    scene = scene_to_torch(host, dev)
    torch.cuda.synchronize()
    emit({"phase": "scene", "scene": "sponza_replica",
          "triangles": int(host.num_triangles),
          "opaque": host.n_opaque, "masked": host.n_masked,
          "masked_raster": host.n_masked_raster,
          "transparent": host.n_transparent,
          "textures": int(host.textures.n_mips.shape[0]),
          "seconds": time.perf_counter() - t0})

    # ---- 4. the bench frame
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = driver.config_from_settings(settings, WIDTH, HEIGHT,
                                      shadow_size=SHADOW_SIZE)
    cam = Camera(position=np.array([9.0, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2
    reset_counts()
    with Recorder(rk, "rasterize_depth_grid") as rec_d, \
            Recorder(rk, "rasterize_layers_grid") as rec_k, \
            Recorder(frame.POSTPROCESS_REGISTRY, "tonemap") as rec_t, \
            Recorder(shade, "classified_shadow_factor") as rec_c:
        t0 = time.perf_counter()
        out = driver.render(scene, cam, settings, cfg)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        out = driver.render(scene, cam, settings, cfg)
    torch.cuda.synchronize()
    frame_ms = 1000.0 * (time.perf_counter() - t0) / TIMED_FRAMES
    launches = read_counts()
    stats = frame.stats_from_vec(out["stats_vec"])
    color = out["color"]
    finite = bool(torch.isfinite(color).all())
    shape_ok = (tuple(color.shape) == (3, HEIGHT, WIDTH)
                and tuple(out["color_u8"].shape) == (HEIGHT, WIDTH, 3))
    emit({"phase": "frame", "width": WIDTH, "height": HEIGHT,
          "warmup_s": warm_s, "frames": TIMED_FRAMES, "frame_ms": frame_ms,
          "stats": stats, "launches": launches, "finite": finite,
          "shape_ok": shape_ok,
          "mean_u8": float(out["color_u8"].float().mean())})
    gate_stats("frame", stats)
    if not (finite and shape_ok):
        failures.append("frame output not finite or misshapen")
    gate_launches("bench frame", launches, KERNELS)
    del out, color

    # ---- 5. kernels vs plain versions on the frame's own inputs
    cam_tiles = math.ceil(WIDTH / cfg.tile_w) * math.ceil(HEIGHT / cfg.tile_h)
    cam_calls = [c for c in rec_d.calls if c[0][2].shape[0] == cam_tiles]
    sh_calls = [c for c in rec_d.calls if c[0][2].shape[0] ==
                math.ceil(cfg.shadow_size / cfg.tile_w)
                * math.ceil(cfg.shadow_size / cfg.tile_h)]
    checks = {name: [] for name in KERNELS}
    try:
        checks["raster_depth"].append(compare_raster(
            "raster_depth", f"camera_opaque_{WIDTH}x{HEIGHT}",
            rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
            *cam_calls[-1], outputs_per_px=8))
        for c, call in enumerate(sh_calls):
            checks["raster_depth"].append(compare_raster(
                "raster_depth", f"shadow_cascade{c}_{SHADOW_SIZE}",
                rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
                *call, outputs_per_px=8))
        for r, call in enumerate(rec_k.calls[:2]):
            k_r = call[0][6]
            floor_tag = "_floor" if call[0][4] is not None else ""
            checks["raster_layers"].append(compare_raster(
                "raster_layers",
                f"masked_round{r}_{WIDTH}x{HEIGHT}_k{k_r}{floor_tag}",
                rk.rasterize_layers_grid, rk.rasterize_layers_grid_plain,
                *call, outputs_per_px=8 * k_r))
        # the heavy synthetic stream: one 128x32 tile of HEAVY_RECORDS
        # records (ties on chunk boundaries), two light tiles, one empty
        hrec, hstart, hcounts = (torch.from_numpy(x).to(dev) for x in
                                 heavy_stream(13, cfg.tile_h,
                                              n=HEAVY_RECORDS))
        hshape = (hcounts.shape[0], cfg.tile_h, cfg.tile_w)
        hkw = {"tile_w": cfg.tile_w, "tile_h": cfg.tile_h}
        checks["raster_depth"].append(compare_raster(
            "raster_depth", f"heavy_synthetic_{HEAVY_RECORDS}",
            rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
            (hrec, hstart, hcounts, torch.ones(hshape, device=dev),
             torch.full(hshape, -1, dtype=torch.int32, device=dev)), hkw,
            outputs_per_px=8))
        checks["raster_layers"].append(compare_raster(
            "raster_layers", f"heavy_synthetic_{HEAVY_RECORDS}_k16",
            rk.rasterize_layers_grid, rk.rasterize_layers_grid_plain,
            (hrec, hstart, hcounts, torch.full(hshape, 2.0, device=dev),
             None, -1, 16), hkw, outputs_per_px=8 * 16))
        hdr = rec_t.calls[0][0][0]
        n = hdr.numel()
        checks["tonemap"].append(compare_post(
            "tonemap", f"frame_hdr_3x{HEIGHT}x{WIDTH}", post.tonemap,
            post.tonemap_plain, (hdr,), 8 * n, TONEMAP_OPS * n))
        st = driver.settings_to_torch(settings, dev)
        checks["gradient"].append(compare_post(
            "gradient", f"background_3x{HEIGHT}x{WIDTH}",
            lambda *a: post.gradient(*a, extent_h=HEIGHT),
            lambda *a: post.gradient_plain(*a, extent_h=HEIGHT),
            (HEIGHT, WIDTH, st["bg_top"], st["bg_bottom"]),
            4 * 3 * HEIGHT * WIDTH + 32, 5 * 3 * HEIGHT))
    except Exception:
        traceback.print_exc()
        failures.append("kernel check raised")
    expected = {"raster_depth": 1 + len(sh_calls) + 1, "raster_layers": 3}
    for name in ("raster_depth", "raster_layers"):
        cs = checks[name]
        if len(cs) != expected[name] or not all(c["bit_exact"] for c in cs):
            failures.append(f"{name} disagrees with its plain version "
                            f"(or a check is missing)")
    if len(sh_calls) != 4:
        failures.append(f"{len(sh_calls)} cascade calls recorded, not 4")
    for name in ("tonemap", "gradient"):
        cs = checks[name]
        if not cs or not all(c["max_ulp"] <= POST_ULP for c in cs):
            failures.append(f"{name} is more than {POST_ULP} ulp from its "
                            f"plain version")
    del rec_d, rec_k, rec_t, cam_calls, sh_calls

    # ---- 6. the classifier's bench-frame call against the dense filter
    try:
        if len(rec_c.calls) != 1:
            raise RuntimeError(f"{len(rec_c.calls)} classifier calls in the "
                               "bench frame, not 1")
        c_out = check_classifier(*rec_c.calls[0])
        emit(c_out)
        if not c_out["bit_exact"]:
            failures.append("classified shadow factor differs from the "
                            "dense filter")
    except Exception:
        traceback.print_exc()
        failures.append("classifier phase raised")
    del rec_c

    # ---- 7. the 1080p frame: classified against dense shadows,
    # alternated dense, classified, classified, dense
    dense_cfg = dataclasses.replace(cfg, shadow_classify_cap=0)
    try:
        driver.render(scene, cam, settings, dense_cfg)      # warm-up
        reset_counts()
        runs = {"dense": [], "classified": []}
        outs = {}
        for tag in ("dense", "classified", "classified", "dense"):
            c = cfg if tag == "classified" else dense_cfg
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EXACT_FRAMES):
                outs[tag] = driver.render(scene, cam, settings, c)
            torch.cuda.synchronize()
            runs[tag].append(1000.0 * (time.perf_counter() - t0)
                             / EXACT_FRAMES)
        e_launches = read_counts()
        cs, ds = (frame.stats_from_vec(outs[t]["stats_vec"])
                  for t in ("classified", "dense"))
        cu8, du8 = (outs[t]["color_u8"].cpu().numpy()
                    for t in ("classified", "dense"))
        same = bool(np.array_equal(cu8, du8))
        p = psnr(cu8.astype(np.float32) / 255.0,
                 du8.astype(np.float32) / 255.0)
        stats_equal = all(cs[k] == ds[k] for k in frame.STATS_KEYS
                          if k != "fallback_px")
        emit({"phase": "exactness", "width": WIDTH, "height": HEIGHT,
              "frames_per_run": EXACT_FRAMES,
              "frame_ms_classified": runs["classified"],
              "frame_ms_dense": runs["dense"], "u8_equal": same,
              "psnr_db": p, "stats_classified": cs, "stats_dense": ds,
              "stats_equal_but_fallback": stats_equal,
              "fallback_px": cs["fallback_px"], "launches": e_launches})
        del outs
        gate_stats("classified frame", cs)
        gate_stats("dense frame", ds)
        if not (same and stats_equal):
            failures.append(f"classified frame differs from dense: PSNR "
                            f"{p} dB, stats {cs} vs {ds}")
        gate_launches("exactness frames", e_launches, KERNELS)
    except Exception:
        traceback.print_exc()
        failures.append("exactness phase raised")

    # ---- 8. per-pass times of the bench frame (committed profiler)
    for tag, pcfg in (("classified", cfg), ("dense", dense_cfg)):
        try:
            reset_counts()
            sd, st = driver.frame_inputs(scene, cam, settings, pcfg)
            timings = profiler.profile_passes(scene, sd, st, pcfg,
                                              iters=PROFILE_ITERS)
            p_launches = read_counts()
            emit({"phase": "passes", "shadows": tag, "iters": PROFILE_ITERS,
                  "ms": timings, "launches": p_launches})
            print(profiler.format_table(timings), file=sys.stderr,
                  flush=True)
            if not all(math.isfinite(v) and v > 0 for v in timings.values()):
                failures.append(f"passes {tag}: a stage time is not "
                                f"positive")
            gate_launches(f"passes {tag}", p_launches, KERNELS)
        except Exception:
            traceback.print_exc()
            failures.append(f"passes phase {tag} raised")

    # ---- the procedural scene of phases 9 and 11, built after the bench
    # frame so that phase 4 runs as it did before this scene existed
    t0 = time.perf_counter()
    like_host = procedural.build_sponza_like().build()
    like = scene_to_torch(like_host, dev)
    torch.cuda.synchronize()
    emit({"phase": "scene", "scene": "sponza_like",
          "triangles": int(like_host.num_triangles),
          "opaque": like_host.n_opaque, "masked": like_host.n_masked,
          "transparent": like_host.n_transparent,
          "seconds": time.perf_counter() - t0})

    # ---- 9. frame parity: kernels vs plain versions at 480x272
    # faces the pane at x = 3 from its front (+z) side, far enough that
    # the pane's triangles stay under the binner's big-triangle capacity
    # (from (3, 2.5, 3.5) they overflow it at 1080p)
    pane_cam = Camera(position=np.array([0.0, 3.0, 3.8], np.float32))
    pane_cam.yaw = -0.9
    t_settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                                enable_background=True,
                                enable_postprocess=True)
    parity_cases = [
        ("bench", scene, cam, settings, driver.config_from_settings(
            settings, PARITY_W, PARITY_H, shadow_size=PARITY_SHADOW)),
        ("sponza_like_transparent_flat", like, pane_cam, t_settings,
         driver.config_from_settings(t_settings, PARITY_W, PARITY_H,
                                     shading="flat",
                                     shadow_size=PARITY_SHADOW)),
    ]
    for tag, p_scene, p_cam, p_set, pcfg in parity_cases:
        try:
            t0 = time.perf_counter()
            fast = driver.render(p_scene, p_cam, p_set, pcfg)
            real = (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
                    frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient)
            rk.rasterize_depth_grid = rk.rasterize_depth_grid_plain
            rk.rasterize_layers_grid = rk.rasterize_layers_grid_plain
            frame.POSTPROCESS_REGISTRY["tonemap"] = post.tonemap_plain
            post.gradient = post.gradient_plain
            try:
                ref = driver.render(p_scene, p_cam, p_set, pcfg)
            finally:
                (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
                 frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient) = real
            p = psnr(fast["color_u8"].cpu().numpy().astype(np.float32)
                     / 255.0,
                     ref["color_u8"].cpu().numpy().astype(np.float32) / 255.0)
            fs, rs = (frame.stats_from_vec(fast["stats_vec"]),
                      frame.stats_from_vec(ref["stats_vec"]))
            emit({"phase": "parity", "frame": tag, "width": PARITY_W,
                  "height": PARITY_H, "shading": pcfg.shading,
                  "shadow_size": PARITY_SHADOW, "psnr_db": p, "stats": fs,
                  "stats_equal": fs == rs,
                  "seconds": time.perf_counter() - t0})
            if not (p >= 40.0 and fs == rs):
                failures.append(f"parity {tag}: PSNR {p:.2f} dB, stats "
                                f"{fs} vs {rs}")
        except Exception:
            traceback.print_exc()
            failures.append(f"parity phase {tag} raised")

    # ---- 10. small-input reference: GPU frame vs the port's CPU path
    try:
        fb = SceneBuilder()
        fb.load_gltf(FIXTURE, "fixture")
        fb.cubemap = b.cubemap
        fhost = fb.build()
        fset = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True,
                              enable_background=True)
        fcfg = driver.config_from_settings(
            fset, 256, 128, shadow_size=256, shadow_cap=40960,
            masked_peels=8, masked_tail_rounds=1, masked_tail_peels=2)
        fcam = Camera()
        gpu = driver.render(scene_to_torch(fhost, dev), fcam, fset, fcfg)
        cpu = driver.render(scene_to_torch(fhost, "cpu"), fcam, fset, fcfg)
        p = psnr(gpu["color_u8"].cpu().numpy().astype(np.float32) / 255.0,
                 cpu["color_u8"].numpy().astype(np.float32) / 255.0)
        gs, cs = (frame.stats_from_vec(gpu["stats_vec"]),
                  frame.stats_from_vec(cpu["stats_vec"]))
        emit({"phase": "reference", "scene": FIXTURE, "width": 256,
              "height": 128, "psnr_db_gpu_vs_cpu": p, "stats": gs,
              "stats_equal": gs == cs})
        if not (p >= 40.0 and gs == cs):
            failures.append(f"fixture GPU vs CPU: PSNR {p:.2f} dB, stats "
                            f"{gs} vs {cs}")
    except Exception:
        traceback.print_exc()
        failures.append("reference phase raised")

    # ---- 11. the transparent pass at full width
    try:
        tcfg = driver.config_from_settings(t_settings, WIDTH, HEIGHT,
                                           shadow_size=SHADOW_SIZE)
        reset_counts()
        with Recorder(rk, "rasterize_layers_grid") as rec_l:
            t0 = time.perf_counter()
            tout = driver.render(like, pane_cam, t_settings, tcfg)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(TRANSPARENT_FRAMES):
            tout = driver.render(like, pane_cam, t_settings, tcfg)
        torch.cuda.synchronize()
        t_ms = 1000.0 * (time.perf_counter() - t0) / TRANSPARENT_FRAMES
        t_launches = read_counts()
        tstats = frame.stats_from_vec(tout["stats_vec"])
        tfinite = bool(torch.isfinite(tout["color"]).all())
        # the transparent pass is the frame's last k-buffer call; its
        # layer 0, cropped to the frame, counted after the main path's
        # launches were read
        targs, tkw = rec_l.calls[-1]
        k_t = targs[6]
        _, ids = rk.rasterize_layers_grid(*targs, **tkw)
        layer0 = from_tiles(ids[0], cdiv(HEIGHT, tcfg.tile_h),
                            cdiv(WIDTH, tcfg.tile_w))[:HEIGHT, :WIDTH]
        cover0 = int((layer0 != targs[5]).sum())          # 5: sentinel
        t_check = compare_raster(
            "raster_layers", f"transparent_{WIDTH}x{HEIGHT}_k{k_t}",
            rk.rasterize_layers_grid, rk.rasterize_layers_grid_plain, targs,
            tkw, outputs_per_px=8 * k_t)
        checks["raster_layers"].append(t_check)
        if not t_check["bit_exact"]:
            failures.append("raster_layers disagrees with its plain version "
                            "on the transparent pass")
        del rec_l, targs, tkw, ids, layer0
        emit({"phase": "transparent", "scene": "sponza_like",
              "triangles": int(like_host.num_triangles),
              "width": WIDTH, "height": HEIGHT, "warmup_s": warm_s,
              "frames": TRANSPARENT_FRAMES, "frame_ms": t_ms,
              "k_layers": k_t, "layer0_covered_px": cover0,
              "stats": tstats, "launches": t_launches, "finite": tfinite,
              "mean_u8": float(tout["color_u8"].float().mean())})
        del tout
        gate_stats("transparent frame", tstats)
        if k_t != tcfg.transparent_peels + 1:
            failures.append(f"last k-buffer call has k={k_t}, not the "
                            f"transparent pass's {tcfg.transparent_peels + 1}")
        if cover0 <= 0:
            failures.append("transparent layer 0 covers no pixel")
        if not tfinite:
            failures.append("transparent frame not finite")
        gate_launches("transparent frame", t_launches, KERNELS)
    except Exception:
        traceback.print_exc()
        failures.append("transparent phase raised")

    # ---- 12. the headless CLI, in-process
    del like
    runs = [("sponza_like", ["--scene", "sponza_like", "--frames", "3",
                             "--width", str(WIDTH), "--height", str(HEIGHT),
                             "--shadows", "--mode", "3", "--background",
                             "--tonemap"], KERNELS),
            ("cube_flat", ["--scene", "cube", "--flat", "--background"],
             ("raster_depth", "tonemap", "gradient"))]
    for tag, argv, path_kernels in runs:
        try:
            reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = headless.main(argv)
            seconds = time.perf_counter() - t0
            h_launches = read_counts()
            lines = [json.loads(ln) for ln in buf.getvalue().splitlines()
                     if ln.startswith("{")]
            per_frame = [ln for ln in lines if "frame" in ln]
            avg = [ln for ln in lines if "avg_frametime_ms" in ln]
            emit({"phase": "headless", "run": tag, "argv": argv, "rc": rc,
                  "seconds": seconds, "frames": per_frame,
                  "average": avg[0] if avg else None,
                  "launches": h_launches})
            if rc != 0 or not per_frame:
                failures.append(f"headless {tag} returned {rc} with "
                                f"{len(per_frame)} frame lines")
            for ln in per_frame:
                gate_stats(f"headless {tag} frame {ln['frame']}", ln)
            gate_launches(f"headless {tag}", h_launches, path_kernels)
        except Exception:
            traceback.print_exc()
            failures.append(f"headless {tag} raised")

    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    def entry(name):
        cs = checks[name]
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "max_ulp": max((c["max_ulp"] for c in cs
                                if c["max_ulp"] is not None), default=None),
                "ms": cs[0]["ms"], "ms_eager": cs[0]["ms_eager"],
                "plain_ms": cs[0]["plain_ms"],
                "bound_ms": cs[0]["bound_ms"], "bound_by": cs[0]["bound_by"],
                "library_ms": None}

    emit({"kernels": [entry(name) for name in KERNELS]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
