#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vk_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:
  1. card: the GPU's name and power limit (nvidia-smi),
  2. build: compile csrc/raster.cu, csrc/post.cu and csrc/masked.cu for
     sm_90a from this checkout, one nvcc per source, all started together,
  3. scene: load the committed Sponza replica (assets/sponza_replica)
     with the NumPy texture heap (the frame's), and again through the
     native bridge (native/texops.cpp) where g++ builds it: both load
     times and how many heap texels differ; the procedural 260k-triangle
     sponza_like scene is built after phase 9 (its own scene line),
  4. frame: the bench frame — driver.render at 1920x1080, CSM mode 3,
     skybox, tonemap, at the bench camera — one warm-up frame, then the
     mean of the timed frames, with every kernel's launch count over that
     run; bin/peel/sparse overflow must be 0,
  5. kernels: each CUDA kernel on the bench frame's own inputs (camera
     opaque records at 1080p and the one call of all four 2048^2
     cascades for the depth raster, masked rounds 0, 1 and 2 for the
     k-buffer, the frame's HDR colour for the tonemap, the frame's
     background colours at 1920x1080 for the gradient) and both raster
     kernels on a heavy synthetic stream (one 128x32 tile of 3,100
     records, tests/raster_streams.py) against its plain PyTorch
     version — the raster kernels bit for bit, the post kernels within
     2 ulp (and the gradient's strip form, rows
     270-539 of the 1080-row background, equal to those rows of the whole
     one), and the masked pass's resolve kernel on each of the frame's
     rounds bit for bit (state, probe and tested-pixel counts) — with
     both times, the bound (the
     least time the card could take for the same work), and for the
     raster kernels the largest record count of one tile and of one
     8-row band and the spread of their blocks' times (%globaltimer),
  6. classifier: the shadow classifier's call of the bench frame
     (shade.classified_shadow_factor's arguments, recorded in phase 4)
     run again beside the dense filter on the same inputs: the factors
     must be equal bit for bit on the active pixels (the classified
     factor is 0 elsewhere); the lit, blocked, uncertain and inactive
     pixel counts under the frame's windows (the JAX frame's traced-mode
     windows) and under the static-mode ones, the cap and both times,
  7. exactness: the 1080p bench frame with the default classified shadows
     against the same frame with the dense filter (shadow_classify_cap
     = 0), frames alternated dense, classified, classified, dense: equal
     u8 images (PSNR inf), equal stats but fallback_px, overflow counters
     0, and both frame times; then one frame with the static-mode
     classifier windows: the same u8 image,
  8. passes: graph/profiler.profile_passes on the bench frame, classified
     and dense, each printed as one line of stage -> ms,
  9. sharded: the bench frame as n = 2 and n = 4 horizontal strips in
     turn on the card (parallel/sharded.render_frame_sharded, no group),
     each held against phase 4's frame: colour mismatch fraction (> 1e-3)
     under 0.5%, depth within 2e-3 on every pixel whose visible triangle
     is the same in both frames, at most 0.05% of the pixels with another
     visible triangle, each of them explained from the scene (an edge
     through the pixel centre, the alpha test passing in one frame only,
     two surfaces closer in depth than the frames' rounding there, or two
     alpha-tested fragments whose depths tie in one frame's k-buffer
     only: flip_kinds), overflow counters 0, triangles in
     [ref, n * ref], uncovered pixels bit-equal; whole-frame and
     per-strip times and the four kernels' launches; every kernel launch
     of one run of the strips (the 270- and 540-row camera strips with
     their padded last tile row, the 512- and 1024-row cascade strips,
     the masked rounds, tonemap and gradient per strip) run again beside
     its plain version: raster kernels bit for bit, post kernels within
     2 ulp; then a world of two processes on the one card (gloo, a
     FileStore in a temporary directory) through
     render_frame_sharded(group=...), whose assembled frame, gathered on
     the card, must equal the n = 2 frame bit for bit,
 10. parity: 480x272 frames rendered with the kernels against the same
     frames rendered with all four plain versions (app.bench.plain_kernels,
     PSNR >= 40 dB): the bench frame, and a transparent + flat-shaded
     sponza_like frame,
 11. reference: the glTF test fixture (MASK material, CSM shadows, skybox)
     at 256x128 on the GPU against the port's CPU path, which the CPU
     tests hold against the JAX package's goldens (PSNR >= 40 dB, equal
     stats),
 12. transparent: sponza_like at 1920x1080, CSM mode 3, background and
     tonemap, from a camera facing a transparent pane — transparent layer
     0 must cover pixels, every overflow counter must be 0; then the
     k-buffer kernel against its plain version on that pass's K=3 call,
 13. headless: the CLI's main() on sponza_like at 1080p (3 frames) and on
     the flat-shaded cube; each must return 0 with overflow counters 0,
 14. viewer: app/viewer.py's window-free core (ViewerSession) on the
     replica at the viewer's default window, 1280x720, from the bench
     camera, driven with the real clock by a script that presses every
     key binding, moves the six trackbars, drags the mouse, holds w/a/d,
     steps the render-scale ladder down to 640x360 and back, and quits on
     q (VIEWER_SCRIPT, 34 frames): each frame's window-size image equal
     bit for bit to a fresh driver.render of copies of its camera,
     settings and config through the same upscale, the frame sizes
     following the ladder (1280x720, 960x540, 640x360), no CUDA library
     built or loaded after the first frame (utils.build wrapped),
     overflow counters 0 on every frame, and every kernel launch of one
     frame at each ladder size against its plain version (raster bit for
     bit, post within 2 ulp; the 540- and 360-row frames have a padded
     last tile row); printed: per-step synchronised ms, the HUD lines,
     launches per frame, the mean frame ms at each size, and the last
     frame's state rendered at every size (3 frames after a warm-up),
 15. bench: app.bench.main(["--passes"]) in-process at its defaults (the
     replica at 1920x1080, 30 timed frames, parity at 480x272, the
     sponza_like continuity frames), its stdout and stderr captured and
     printed on one phase line with the card's name and power limit:
     exit 0, exactly one stdout line with bench.py's four keys and metric
     sponza_replica_1080p_fps, the nine-key stats line with overflow
     counters 0 and backend cuda, parity_pass true, a continuity line,
     each kernel launched at least 30 times, the replica's three files
     byte-equal before and after,
 16. entries: entry.entry()'s one render_frame step on the card (every
     kernel launched, every launch recorded and held against its plain
     version: raster bit for bit, post within POST_ULP) against
     entry("cpu")'s frame (PSNR >= 40 dB, equal stats, bin_overflow
     41,424 in both), then entry.dryrun_multichip(4): a 4-process gloo
     world that renders on the CPU though a card is present, and its
     seconds on the CPU (no card time).
Phases 4, 7, 8, 9 (each n), 12, 13, 14, 15 and 16 each set every kernel's
launch count to 0 just before they run and read the counts just after; a
kernel of that path that never launched fails the run.  The kernels
line's launches are the sum of phases 4, 9, 14, 15 and 16.  Then one
{"kernels": [...]} line, the card line as nvidia-smi prints it, and last
{"ok": true, "device": {...}}.  Exits
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
STRIPS = (2, 4)
SHARDED_FRAMES = 3
WORLD_FRAMES = 3
STRIP_ROW0 = 270          # the gradient's strip check: rows 270-539
KERNEL_REPS = 10
MASKED_ROUNDS = 3         # the bench frame's k-buffer calls (phase 5)
BENCH_FRAMES = 30         # app/bench.py's timed frames (phase 15)
REPLICA_FILES = ("assets/sponza_replica/Sponza.glb",
                 "assets/sponza_replica/pisa_cube.ktx",
                 "assets/sponza_replica/.v5_t512_a256_s2.8")
BENCH_LINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_STATS_KEYS = ["frametime_ms", "triangles", "drawcalls", "bin_overflow",
                    "peel_overflow", "sparse_overflow", "fallback_px",
                    "backend", "scene_triangles"]
DRYRUN_WORKERS = 4
POST_ULP = 2
HEAVY_RECORDS = 3100
RASTER_SRC = "vk_renderer_tpu_torch/csrc/raster.cu"
POST_SRC = "vk_renderer_tpu_torch/csrc/post.cu"
MASKED_SRC = "vk_renderer_tpu_torch/csrc/masked.cu"
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
# phase 14: the viewer's default window on the replica, its three ladder
# sizes, and one poll per frame as its window loop polls: (key or None,
# [actions fired during the poll]); ("slider", i, v) moves the i-th
# trackbar (ViewerSession.trackbars() order), ("mouse", event, x, y)
VIEWER_W, VIEWER_H = 1280, 720
VIEWER_LADDER = ((640, 360), (960, 540), (1280, 720))
VIEWER_RUNG_FRAMES = 3
VIEWER_SCRIPT = (
    [("h", [("slider", 0, 200), ("slider", 1, 30)]),
     ("1", [("slider", 2, 180), ("slider", 3, 40)]),
     ("2", [("slider", 4, 220), ("slider", 5, 50)])]
    + [(k, []) for k in "34bpjlik-=[]"]
    + [("w", []), ("a", []), ("w", []), ("d", []),
       (None, [("mouse", "down", 600, 300), ("mouse", "move", 640, 310)]),
       (None, [("mouse", "move", 680, 305), ("mouse", "up", 680, 305)]),
       ("s", []),
       (",", []), (None, []), (None, []),
       (",", []), (None, []), (None, []),
       (".", []), (None, []),
       (".", []), (None, []), (None, []),
       ("q", [])])
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
               "plan_segments", "tonemap_kernel", "gradient_kernel",
               "masked_resolve_kernel")
    pattern = re.compile(r"(%s)(I(?:L[ib]\d+E)+E)?" % "|".join(kernels))
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = pattern.search(ln)
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else []
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


def resolve_bytes(args) -> int:
    """Bytes one resolve call needs on these inputs, each read or written
    once: the state in and out, each tested pixel's layer depth and id,
    the probe layer's id of each pixel pending at the end, the two
    32-byte rows of each distinct tested triangle and one 32-byte sector
    of each distinct vertex of theirs.  The texel reads are left out
    (their addresses are the sampler's), so the bound is low."""
    import torch
    from vk_renderer_tpu_torch.ops import masked
    d, i, n_walk, probe, state, scene, rows = args[:7]
    with Recorder(masked, "winner_alpha") as rec:
        out, _ = masked.masked_resolve_plain(*args)
    tris = [c[0][1] for c in rec.calls]
    tris = torch.unique(torch.cat(tris)) if tris else torch.zeros(
        0, dtype=torch.int32, device=d.device)
    verts = torch.unique(rows[1][tris.long(), 4:7])
    n_px = state[0].numel()
    n_tested = sum(int(c[0][1].numel()) for c in rec.calls)
    n_bytes = (n_px * (8 + (5 if state[2] is not None else 0)) + n_px * 13
               + 8 * n_tested + (4 * int(out[2].sum()) if probe else 0)
               + 64 * tris.numel() + 32 * verts.numel())
    return n_bytes, n_tested


def compare_resolve(tag, args) -> dict:
    """The resolve kernel against its plain version on one round's
    recorded inputs: the state (depths as bits), the probe count and the
    tested-pixel count equal; both times and the bound."""
    import torch
    from vk_renderer_tpu_torch.ops import masked
    args = args[:11]              # the frame's call, without its counter
    dev = args[0].device
    t_k = torch.zeros((), dtype=torch.int64, device=dev)
    t_p = torch.zeros((), dtype=torch.int64, device=dev)
    k, kp = masked.masked_resolve(*args, t_k)
    p, pp = masked.masked_resolve_plain(*args, t_p)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               if a.dtype == torch.float32 else torch.equal(a, b)
               for a, b in zip(k, p))
    same = same and int(t_k) == int(t_p) and (
        (kp is None and pp is None) or int(kp) == int(pp))
    n_bytes, n_tested = resolve_bytes(args)
    out = {"phase": "kernel_check", "kernel": "masked_resolve",
           "input": tag, "layers": int(args[0].shape[0]),
           "walked": int(args[2]), "probe": bool(args[3]),
           "tiles": int(args[0].shape[1]), "tested_px": n_tested,
           "tested_px_kernel": int(t_k), "bit_exact": bool(same),
           "id_mismatches": int((k[1] != p[1]).sum()),
           "pending_mismatches": int((k[2] != p[2]).sum()),
           "max_abs_err": float((k[0] - p[0]).abs().max()), "max_ulp": None,
           "ms": graph_ms(lambda: masked.masked_resolve(*args), KERNEL_REPS),
           "ms_eager": cuda_ms(lambda: masked.masked_resolve(*args),
                               KERNEL_REPS),
           "plain_ms": cuda_ms(lambda: masked.masked_resolve_plain(*args),
                               1),
           **bound(n_bytes, 0), "library_ms": None}
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
    n_active = int(active.sum())

    def counts(traced):
        lit, blk = shade._classify_shadow(
            coarse, su, sv, sz, layer, maps.shape[-1], mode,
            shadow_rows=maps if kw.get("quad_lit", True) else None,
            shadow_fine=fine, traced_windows=traced)
        n_lit, n_blk = int((active & lit).sum()), int((active & blk).sum())
        return {"lit_px": n_lit, "blocked_px": n_blk,
                "uncertain_px": n_active - n_lit - n_blk,
                "uncertain_share": (n_active - n_lit - n_blk) / ndl.numel()}

    traced = kw.get("traced_windows", False)
    return {"phase": "classifier", "shadow_mode": mode,
            "pixels": ndl.numel(), "inactive_px": ndl.numel() - n_active,
            "traced_windows": traced, **counts(traced),
            "other_windows": counts(not traced),
            "cap": cap, "overflow": int(ovf),
            "coarse_cells": list(coarse.shape),
            "fine_cells": list(fine.shape) if fine is not None else None,
            "bit_exact": same,
            "max_abs_err": float(torch.where(active, (got - want).abs(),
                                             0.0).max()),
            "classified_ms": cuda_ms(
                lambda: shade.classified_shadow_factor(*args, **kw), 5),
            "dense_ms": cuda_ms(dense, 5)}


def strip_check(ref: dict, out: dict, n: int, ref_tid, tid) -> dict:
    """An n-strip frame against the single frame (tests/test_parallel.py's
    bounds): colour mismatch fraction (|difference| > 1e-3); the pixels
    whose visible triangle (``ref_tid`` / ``tid``, the dense G-buffers')
    differs, and the largest depth difference on every other pixel; the
    pixels whose depth differs by more than 2e-3; the summed triangles
    against [ref, n * ref]; and whether the pixels uncovered in both
    frames are equal bit for bit."""
    import torch
    c_ref, c_out = ref["color"], out["color"]
    mismatch = float(((c_ref - c_out).abs() > 1e-3).float().mean())
    cov_ref, cov_out = ref["depth"] < 1.0, out["depth"] < 1.0
    d = (ref["depth"] - out["depth"]).abs()
    same = ref_tid == tid
    bg = ~cov_ref & ~cov_out
    t_ref = ref["stats"]["triangles"]
    t_out = int(out["stats"]["triangles"])
    return {"mismatch_fraction": mismatch,
            "coverage_flips": int((cov_ref != cov_out).sum()),
            "id_diff_px": int((~same).sum()),
            "same_id_max_depth_diff": float(torch.where(same, d, 0.0).max()),
            "depth_off_px": int((d > 2e-3).sum()),
            "max_depth_diff": float(d.max()),
            "triangles": t_out, "triangles_ref": t_ref,
            "triangles_in_range": t_ref <= t_out <= n * t_ref,
            "background_px": int(bg.sum()),
            "background_bit_equal": bool(torch.equal(
                c_ref[:, bg].view(torch.int32),
                c_out[:, bg].view(torch.int32)))}


def layers_at(outs, pix, tile_h: int, tile_w: int, cols: int,
              sentinel: int) -> list:
    """The masked k-buffer layers of one view at the pixels ``pix``
    ([(y, x)] in the view): per pixel, [(triangle, f32 depth)] over every
    round's output ``outs`` ([(depth, ids)], [K, tiles, tile_h, tile_w])."""
    import torch
    if not pix:
        return []
    ys = torch.tensor([p[0] for p in pix])
    xs = torch.tensor([p[1] for p in pix])
    tile = (ys // tile_h) * cols + xs // tile_w
    got = [[] for _ in pix]
    for d, i in outs:
        dev = d.device
        dd = d[:, tile.to(dev), (ys % tile_h).to(dev),
               (xs % tile_w).to(dev)].cpu()
        ii = i[:, tile.to(dev), (ys % tile_h).to(dev),
               (xs % tile_w).to(dev)].cpu()
        for k in range(dd.shape[0]):
            for j in range(len(pix)):
                t = int(ii[k, j])
                if 0 <= t < sentinel:
                    got[j].append((t, float(dd[k, j])))
    return got


def flip_kinds(host, scene, viewproj, ref_g, strip_g, masked: range,
               ref_depth, strip_depth, ref_layers, strip_layers,
               tile_h: int, tile_w: int, cap: int = 4096) -> dict:
    """Why each pixel's visible triangle differs between the single frame
    and the strips.  ``ref_g`` and ``strip_g`` (one per strip, in order)
    are (tid, rows, vattr) of each view's dense G-buffer build.  Kinds,
    first match wins:
    - knife_edge: an edge of either triangle passes within 1e-3 pixels
      of the pixel centre (scene vertices in f64), where the top-left
      rule is decided by the rounding of each view's planes;
    - alpha_threshold: an alpha-tested triangle of the two passes the
      alpha test (>= 0.5, the port's own trilinear alpha at the pixel
      centre) in one frame and fails it in the other;
    - depth_order: both triangles cover the centre and their f64 depths
      there differ by less than twice the f32 depth rounding of the two
      frames at that pixel (|frame depth - f64 depth of the triangle it
      shows|, summed, plus 2^-22): two nearly coplanar surfaces whose
      order each frame's rounding decides;
    - kbuffer_tie: the alpha-tested triangle one frame shows is missing
      from the other frame's masked layers (``ref_layers`` /
      ``strip_layers``: each view's k-buffer outputs) at that pixel,
      where a layer of another triangle sits at its depth (its f64
      depth within twice that layer's own rounding plus 2^-22): the
      k-buffer keeps one fragment per depth, so two foliage quads whose
      f32 depths tie in one frame and not in the other change which
      one the alpha test sees;
    - other: none of these.
    The first ``cap`` differing pixels are classified; ``depth_order_gap``
    is the largest f64 depth gap among the depth_order pixels."""
    import numpy as np
    import torch
    from vk_renderer_tpu_torch.ops import masked as masked_ops
    ref_tid = ref_g[0]
    tid = torch.cat([g[0] for g in strip_g])
    h, w = ref_tid.shape
    sh = h // len(strip_g)
    a, b = ref_tid.cpu().numpy(), tid.cpu().numpy()
    rd, sd_ = ref_depth.cpu().numpy(), strip_depth.cpu().numpy()
    diff = np.argwhere(a != b)[:cap]
    out = {"classified": int(len(diff)), "knife_edge_px": 0,
           "alpha_threshold_px": 0, "depth_order_px": 0,
           "kbuffer_tie_px": 0, "other_px": 0,
           "alpha_threshold_max_margin": 0.0, "depth_order_gap": 0.0,
           "other": []}
    if not len(diff):
        return out
    pos = np.asarray(host.positions, np.float64)
    obj = np.asarray(host.vert_obj)
    world = np.asarray(host.obj_world, np.float64)
    tris = np.asarray(host.tris)
    vp = viewproj.double().cpu().numpy()
    dev = ref_tid.device

    def screen(t):
        """(x, y, z_ndc, all w > 0) of triangle t's corners."""
        v = tris[t]
        hom = np.concatenate([pos[v], np.ones((3, 1))], 1)
        clip = np.einsum("ij,kj->ki", vp, np.einsum("kij,kj->ki",
                                                    world[obj[v]], hom))
        xy = (clip[:, :2] / clip[:, 3:] + 1.0) * np.array([w / 2, h / 2])
        return xy, clip[:, 2] / clip[:, 3], bool((clip[:, 3] > 0).all())

    def edge_dist(t, cx, cy):
        xy, _, _ = screen(t)
        d = []
        for i in range(3):
            (x0, y0), (x1, y1) = xy[i], xy[(i + 1) % 3]
            d.append(abs((x1 - x0) * (cy - y0) - (y1 - y0) * (cx - x0))
                     / max(np.hypot(x1 - x0, y1 - y0), 1e-30))
        return min(d)

    def depth_at(t, cx, cy):
        """f64 depth of triangle t at the point, None if outside it."""
        xy, z, front = screen(t)
        (x0, y0), (x1, y1), (x2, y2) = xy
        det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if not front or det == 0.0:
            return None
        l1 = ((cx - x0) * (y2 - y0) - (x2 - x0) * (cy - y0)) / det
        l2 = ((x1 - x0) * (cy - y0) - (cx - x0) * (y1 - y0)) / det
        lam = np.array([1.0 - l1 - l2, l1, l2])
        return float(lam @ z) if (lam >= -1e-9).all() else None

    def alphas(g, t, px, py):
        return masked_ops.winner_alpha(
            scene, torch.as_tensor(t, dtype=torch.int32, device=dev), g[1],
            g[2], torch.as_tensor(px, dtype=torch.float32, device=dev),
            torch.as_tensor(py, dtype=torch.float32, device=dev)).cpu()

    # each pixel's alpha-tested triangles: the alpha test in both frames
    pairs = [(k, t) for k, (y, x) in enumerate(diff)
             for t in {int(a[y, x]), int(b[y, x])} if t in masked]
    flips = {}
    if pairs:
        ks = np.array([k for k, _ in pairs])
        ts = np.array([t for _, t in pairs])
        ys, xs = diff[ks, 0], diff[ks, 1]
        al_ref = alphas(ref_g, ts, xs + 0.5, ys + 0.5).numpy()
        al_str = np.empty_like(al_ref)
        for i, g in enumerate(strip_g):
            m = ys // sh == i
            if m.any():
                al_str[m] = alphas(g, ts[m], xs[m] + 0.5,
                                   ys[m] - i * sh + 0.5).numpy()
        for k, ar, as_ in zip(ks, al_ref, al_str):
            if (ar >= 0.5) != (as_ >= 0.5):
                flips[int(k)] = max(flips.get(int(k), 0.0),
                                    abs(float(ar) - 0.5),
                                    abs(float(as_) - 0.5))
    # each pixel's masked layers in the single frame and in its strip
    cols = -(-w // tile_w)
    sentinel = int(host.num_triangles)
    layers_a = layers_at(ref_layers, [tuple(p) for p in diff], tile_h,
                         tile_w, cols, sentinel)
    layers_b = [None] * len(diff)
    for i, outs in enumerate(strip_layers):
        ks = [k for k, (y, _) in enumerate(diff) if y // sh == i]
        for k, lay in zip(ks, layers_at(
                outs, [(int(diff[k][0]) - i * sh, int(diff[k][1]))
                       for k in ks], tile_h, tile_w, cols, sentinel)):
            layers_b[k] = lay

    def tie(t, cx, cy, layers):
        """Alpha-tested ``t`` missing from ``layers``, with a layer of
        another triangle at its depth (within that layer's rounding)."""
        if t not in masked or any(u == t for u, _ in layers):
            return False
        zt = depth_at(t, cx, cy)
        if zt is None:
            return False
        for u, zu in layers:
            zu64 = depth_at(u, cx, cy)
            if zu64 is not None and (abs(zt - zu)
                                     <= 2.0 * abs(zu - zu64) + 2.0 ** -22):
                return True
        return False

    for k, (y, x) in enumerate(diff):
        cx, cy = x + 0.5, y + 0.5
        ts = [int(t) for t in (a[y, x], b[y, x]) if t >= 0]
        if min(edge_dist(t, cx, cy) for t in ts) < 1e-3:
            out["knife_edge_px"] += 1
        elif k in flips:
            out["alpha_threshold_px"] += 1
            out["alpha_threshold_max_margin"] = max(
                out["alpha_threshold_max_margin"], flips[k])
        else:
            zs = [depth_at(t, cx, cy) for t in ts]
            gap = rounding = None
            if len(ts) == 2 and None not in zs:
                gap = abs(zs[0] - zs[1])
                rounding = 2.0 * (abs(float(rd[y, x]) - zs[0])
                                  + abs(float(sd_[y, x]) - zs[1])) + 2.0 ** -22
            if gap is not None and gap <= rounding:
                out["depth_order_px"] += 1
                out["depth_order_gap"] = max(out["depth_order_gap"], gap)
            elif tie(int(a[y, x]), cx, cy, layers_b[k]) or tie(
                    int(b[y, x]), cx, cy, layers_a[k]):
                out["kbuffer_tie_px"] += 1
            else:
                out["other_px"] += 1
                if len(out["other"]) < 8:
                    out["other"].append([int(y), int(x), int(a[y, x]),
                                         int(b[y, x]), zs, gap, rounding,
                                         layers_a[k][:12], layers_b[k][:12]])
    return out


def kernel_recorders(stack: contextlib.ExitStack) -> dict:
    """A Recorder on each kernel's wrapper where the frame calls it, by
    KERNELS name, entered on ``stack``."""
    from vk_renderer_tpu_torch.graph import frame
    from vk_renderer_tpu_torch.ops import post
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    return {name: stack.enter_context(Recorder(owner, attr))
            for name, (owner, attr) in (
                ("raster_depth", (rk, "rasterize_depth_grid")),
                ("raster_layers", (rk, "rasterize_layers_grid")),
                ("tonemap", (frame.POSTPROCESS_REGISTRY, "tonemap")),
                ("gradient", (post, "gradient")))}


def launch_checks(recs: dict) -> dict:
    """Every launch recorded on one frame (kernel_recorders) run again on
    its recorded inputs beside its plain version: raster kernels bit for
    bit (depth as int32 bits, ids), post kernels within POST_ULP.  Per
    kernel: the calls, the input shapes, the calls that disagree, max
    |difference| and (post kernels) max ulp."""
    import torch
    from vk_renderer_tpu_torch.ops import post
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    from vk_renderer_tpu_torch.ops.common import max_ulp
    plain = {"raster_depth": rk.rasterize_depth_grid_plain,
             "raster_layers": rk.rasterize_layers_grid_plain,
             "tonemap": post.tonemap_plain, "gradient": post.gradient_plain}
    out = {}
    for name, rec in recs.items():
        row = {"calls": len(rec.calls), "shapes": set(), "disagree": 0,
               "max_abs_err": 0.0, "max_ulp": None}
        for args, kw in rec.calls:
            k = rec.real(*args, **kw)
            p = plain[name](*args, **kw)
            if name.startswith("raster"):
                row["shapes"].add(tuple(args[3].shape))
                ok = (torch.equal(k[0].view(torch.int32),
                                  p[0].view(torch.int32))
                      and torch.equal(k[1], p[1]))
                err = float((k[0] - p[0]).abs().max()) if k[0].numel() else 0.0
            else:
                row["shapes"].add(tuple(k.shape))
                ulp = max_ulp(k, p)
                row["max_ulp"] = max(row["max_ulp"] or 0, ulp)
                ok = ulp <= POST_ULP
                finite = torch.isfinite(k) & torch.isfinite(p)
                err = (float((k - p)[finite].abs().max())
                       if bool(finite.any()) else 0.0)
            row["disagree"] += int(not ok)
            row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] = sorted(row["shapes"])
        out[name] = row
    return out


def strip_gate(name: str, chk: dict, stats: dict, n_px: int) -> list:
    """The failed gates of one strip frame (strip_check's and flip_kinds'
    dicts): overflow 0, colour mismatch under 0.5%, depth within 2e-3 on
    every pixel whose visible triangle is the same in both frames, at
    most 0.05% of the pixels with another visible triangle and each of
    those explained (flip_kinds), triangles in range, the uncovered
    pixels equal."""
    bad = [f"{name} {k} = {stats[k]}" for k in
           ("bin_overflow", "peel_overflow", "sparse_overflow") if stats[k]]
    if not chk["mismatch_fraction"] < 0.005:
        bad.append(f"{name}: mismatch fraction {chk['mismatch_fraction']}")
    if not chk["same_id_max_depth_diff"] <= 2e-3:
        bad.append(f"{name}: depth differs by "
                   f"{chk['same_id_max_depth_diff']} on a pixel whose "
                   f"visible triangle is the same")
    if not chk["id_diff_px"] <= 5e-4 * n_px:
        bad.append(f"{name}: {chk['id_diff_px']} pixels show another "
                   f"triangle")
    if chk["other_px"] or chk["classified"] < chk["id_diff_px"]:
        bad.append(f"{name}: pixels with another triangle unexplained: "
                   f"{chk['other_px']} ({chk['other']})")
    if not (chk["triangles_in_range"] and chk["background_bit_equal"]
            and chk["background_px"] > 0):
        bad.append(f"{name}: triangles or background differ ({chk})")
    return bad


def replica_digests() -> list:
    """SHA-256 of each of REPLICA_FILES."""
    import hashlib
    out = []
    for path in REPLICA_FILES:
        with open(path, "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def bench_config():
    """The bench frame's settings, config and camera (phase 4's): those
    of app/bench.py at its default size."""
    from vk_renderer_tpu_torch.app import bench
    from vk_renderer_tpu_torch.graph import driver
    settings = bench.bench_settings()
    cfg = driver.config_from_settings(settings, WIDTH, HEIGHT,
                                      shadow_size=SHADOW_SIZE)
    return settings, cfg, bench.bench_camera()


def viewer_sizes() -> list:
    """The render size of each frame of VIEWER_SCRIPT: the ladder's top
    rung first, one rung down per ',' and up per '.', clamped."""
    rung, out = len(VIEWER_LADDER) - 1, []
    for key, _ in VIEWER_SCRIPT:
        out.append(VIEWER_LADDER[rung])
        if key == ",":
            rung = max(0, rung - 1)
        elif key == ".":
            rung = min(len(VIEWER_LADDER) - 1, rung + 1)
    return out


def drive_viewer(scene, wrappers: dict) -> dict:
    """Phase 14: app.viewer's window-free core (ViewerSession) on the
    replica at VIEWER_W x VIEWER_H from the bench camera, driven by
    VIEWER_SCRIPT with the real clock, as its window loop drives it
    (frame, then the poll's slider and mouse actions, then the key).
    Every kernel's launch count is set to 0 before the session and read
    after it; the frame after the first at each size runs under
    kernel_recorders.  utils.build's build_library and load_library are
    wrapped for the whole drive.  After the drive, each frame's image is
    held against a fresh driver.render of copies of its camera, settings
    and config through the same upscale.  Returns the per-step record
    (size, synchronised ms, HUD, stats, launches, library builds and
    loads so far), the launch counts, the recorders by size, the frames
    whose image differs, whether q ended the loop, and the mean frame ms
    of the last frame's state at every rung."""
    import copy
    import torch
    from vk_renderer_tpu_torch.app import viewer
    from vk_renderer_tpu_torch.graph import driver
    from vk_renderer_tpu_torch.utils import build
    for fn in wrappers.values():
        fn.launches = 0
    session = viewer.ViewerSession(scene, VIEWER_W, VIEWER_H,
                                   time.perf_counter(),
                                   camera=bench_config()[2])
    sliders = session.trackbars()
    steps, snaps, recorded, going = [], [], {}, []
    with Recorder(build, "build_library") as rec_b, \
            Recorder(build, "load_library") as rec_l:
        for key, actions in VIEWER_SCRIPT:
            now = time.perf_counter()
            size = (session.cfg.width, session.cfg.height)
            record = (size not in recorded and bool(steps)
                      and steps[-1]["size"] == size)
            before = {n: fn.launches for n, fn in wrappers.items()}
            with contextlib.ExitStack() as stack:
                if record:
                    recorded[size] = kernel_recorders(stack)
                t0 = time.perf_counter()
                img, hud, stats = session.frame(now)
                torch.cuda.synchronize()
                ms = 1000.0 * (time.perf_counter() - t0)
            steps.append({"size": size, "ms": ms, "hud": hud,
                          "stats": stats, "shape": list(img.shape),
                          "builds": len(rec_b.calls) + len(rec_l.calls),
                          "launches": {n: fn.launches - before[n]
                                       for n, fn in wrappers.items()}})
            snaps.append((copy.deepcopy(session.cam),
                          copy.deepcopy(session.settings), session.cfg, img))
            for act in actions:
                if act[0] == "slider":
                    sliders[act[1]][2](act[2])
                else:
                    session.mouse(*act[1:])
            going.append(session.key(
                viewer.NO_KEY if key is None else ord(key), now))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    differ = []
    for i, (cam, settings, cfg, img) in enumerate(snaps):
        out = driver.render(scene, cam, settings, cfg)
        fresh = viewer.upscale_nearest(out["color_u8"], VIEWER_H, VIEWER_W)
        if not torch.equal(fresh, img):
            differ.append(i)
    # the last frame's state at every rung: one warm-up, then the mean of
    # VIEWER_RUNG_FRAMES synchronised frames (the drive's own frames move
    # the camera between sizes)
    cam, settings = snaps[-1][:2]
    same_state = {}
    for i in range(len(VIEWER_LADDER)):
        cfg = session.cfg_at(i)
        driver.render(scene, cam, settings, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VIEWER_RUNG_FRAMES):
            out = driver.render(scene, cam, settings, cfg)
        torch.cuda.synchronize()
        same_state["%dx%d" % (cfg.width, cfg.height)] = (
            1000.0 * (time.perf_counter() - t0) / VIEWER_RUNG_FRAMES)
    return {"steps": steps, "launches": launches, "recorded": recorded,
            "differ": differ, "same_state_ms": same_state,
            "quit_on_q": going == [True] * (len(going) - 1) + [False]}


def world_rank(rank: int, tmp: str) -> None:
    """One rank of the two-process world on the one card: loads the
    replica, joins the gloo group through a FileStore in ``tmp``, renders
    the bench frame through render_frame_sharded(group=...) (one warm-up
    and WORLD_FRAMES timed frames); rank 0 saves the last assembled frame,
    the mean frame time and its launch counts into ``tmp``."""
    import datetime
    import torch
    import torch.distributed as dist
    from vk_renderer_tpu_torch.graph import driver
    from vk_renderer_tpu_torch.ops import post
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    from vk_renderer_tpu_torch.parallel import sharded
    from vk_renderer_tpu_torch.scene import ktx
    from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    dev = torch.device("cuda", 0)
    b = SceneBuilder()
    b.load_gltf("assets/sponza_replica/Sponza.glb", "sponza")
    b.cubemap = ktx.load_cubemap("assets/sponza_replica/pisa_cube.ktx")
    scene = scene_to_torch(b.build(), dev)
    settings, cfg, cam = bench_config()
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=300))
    try:
        group = dist.group.WORLD
        sharded.render_frame_sharded(scene, sd, st, cfg, group=group)
        wrappers = (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
                    post.tonemap, post.gradient)
        for fn in wrappers:
            fn.launches = 0
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(WORLD_FRAMES):
            out = sharded.render_frame_sharded(scene, sd, st, cfg,
                                               group=group)
        torch.cuda.synchronize()
        ms = 1000.0 * (time.perf_counter() - t0) / WORLD_FRAMES
        if rank == 0:
            torch.save({"color": out["color"].cpu(),
                        "depth": out["depth"].cpu(),
                        "color_u8": out["color_u8"].cpu(),
                        "stats_vec": out["stats_vec"].cpu(),
                        "gathered_on": out["color"].device.type,
                        "frame_ms": ms,
                        "launches": [fn.launches for fn in wrappers]},
                       os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


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
        from vk_renderer_tpu_torch import entry as port_entry
        from vk_renderer_tpu_torch import native_bridge
        from vk_renderer_tpu_torch.app import bench, headless
        from vk_renderer_tpu_torch.graph import driver, frame, profiler
        from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
        from vk_renderer_tpu_torch.ops import masked, post, shade
        from vk_renderer_tpu_torch.ops import raster_kernels as rk
        from vk_renderer_tpu_torch.ops.common import cdiv, from_tiles
        from vk_renderer_tpu_torch.parallel import sharded
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
                "tonemap": post.tonemap, "gradient": post.gradient,
                "masked_resolve": masked.masked_resolve}

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
        with ThreadPoolExecutor(max_workers=3) as pool:
            futures = {src: pool.submit(mod.build_kernels)
                       for src, mod in ((RASTER_SRC, rk), (POST_SRC, post),
                                        (MASKED_SRC, masked))}
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

    # ---- 3. scenes: the replica with the NumPy heap (the frame's), then
    # again through the native bridge (built first, outside the load time)
    def load_replica(native):
        t0 = time.perf_counter()
        rb = SceneBuilder(native_textures=native)
        rb.load_gltf("assets/sponza_replica/Sponza.glb", "sponza")
        rb.cubemap = ktx.load_cubemap("assets/sponza_replica/pisa_cube.ktx")
        return rb, rb.build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    b, host, load_s = load_replica(False)
    scene = scene_to_torch(host, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    bridge = native_bridge.available()
    bridge_build_s = time.perf_counter() - t0
    native_load_s = texel_diff = None
    if bridge:
        _, nat_host, native_load_s = load_replica(True)
        texel_diff = int((nat_host.textures.texels
                          != host.textures.texels).sum())
        del nat_host
    emit({"phase": "scene", "scene": "sponza_replica",
          "triangles": int(host.num_triangles),
          "opaque": host.n_opaque, "masked": host.n_masked,
          "masked_raster": host.n_masked_raster,
          "transparent": host.n_transparent,
          "textures": int(host.textures.n_mips.shape[0]),
          "heap": "numpy", "load_s": load_s,
          "native_bridge": bridge, "bridge_build_s": bridge_build_s,
          "load_s_native": native_load_s,
          "heap_texels": int(host.textures.texels.size),
          "native_heap_texels_differing": texel_diff,
          "seconds": seconds})

    # ---- 4. the bench frame
    settings, cfg, cam = bench_config()
    reset_counts()
    with Recorder(rk, "rasterize_depth_grid") as rec_d, \
            Recorder(rk, "rasterize_layers_grid") as rec_k, \
            Recorder(frame.POSTPROCESS_REGISTRY, "tonemap") as rec_t, \
            Recorder(shade, "classified_shadow_factor") as rec_c, \
            Recorder(masked, "masked_resolve") as rec_m:
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
    gate_launches("bench frame", launches, list(KERNELS) + ["masked_resolve"])
    ref4 = {"color": color, "depth": out["depth"], "stats": stats}
    del out, color

    # ---- 5. kernels vs plain versions on the frame's own inputs
    cam_tiles = math.ceil(WIDTH / cfg.tile_w) * math.ceil(HEIGHT / cfg.tile_h)
    cam_calls = [c for c in rec_d.calls if c[0][2].shape[0] == cam_tiles]
    # the shadow pass rasters every cascade in one call, their tiles
    # stacked row-major
    sh_calls = [c for c in rec_d.calls if c[0][2].shape[0] ==
                frame.NUM_CASCADES * math.ceil(cfg.shadow_size / cfg.tile_w)
                * math.ceil(cfg.shadow_size / cfg.tile_h)]
    checks = {name: [] for name in KERNELS}
    try:
        checks["raster_depth"].append(compare_raster(
            "raster_depth", f"camera_opaque_{WIDTH}x{HEIGHT}",
            rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
            *cam_calls[-1], outputs_per_px=8))
        for call in sh_calls:
            checks["raster_depth"].append(compare_raster(
                "raster_depth",
                f"shadow_cascades{frame.NUM_CASCADES}_{SHADOW_SIZE}",
                rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
                *call, outputs_per_px=8))
        for r, call in enumerate(rec_k.calls[:MASKED_ROUNDS]):
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
        # the strip form: rows STRIP_ROW0 .. 2 * STRIP_ROW0 of the frame
        sh = STRIP_ROW0
        g_strip = compare_post(
            "gradient",
            f"strip_3x{sh}x{WIDTH}_row0_{STRIP_ROW0}_extent_{HEIGHT}",
            lambda *a: post.gradient(*a, extent_h=HEIGHT, row0=STRIP_ROW0),
            lambda *a: post.gradient_plain(*a, extent_h=HEIGHT,
                                           row0=STRIP_ROW0),
            (sh, WIDTH, st["bg_top"], st["bg_bottom"]),
            4 * 3 * sh * WIDTH + 32, 5 * 3 * sh)
        checks["gradient"].append(g_strip)
        whole = post.gradient(HEIGHT, WIDTH, st["bg_top"], st["bg_bottom"],
                              extent_h=HEIGHT)
        strip = post.gradient(sh, WIDTH, st["bg_top"], st["bg_bottom"],
                              extent_h=HEIGHT, row0=STRIP_ROW0)
        if not torch.equal(strip, whole[:, STRIP_ROW0:STRIP_ROW0 + sh]):
            failures.append("the gradient strip differs from the whole "
                            "frame's rows")
    except Exception:
        traceback.print_exc()
        failures.append("kernel check raised")
    expected = {"raster_depth": 1 + len(sh_calls) + 1,
                "raster_layers": MASKED_ROUNDS + 1}
    for name in ("raster_depth", "raster_layers"):
        cs = checks[name]
        if len(cs) != expected[name] or not all(c["bit_exact"] for c in cs):
            failures.append(f"{name} disagrees with its plain version "
                            f"(or a check is missing)")
    if len(sh_calls) != 1:
        failures.append(f"{len(sh_calls)} calls of the four cascades "
                        f"recorded, not 1")
    for name in ("tonemap", "gradient"):
        cs = checks[name]
        if not cs or not all(c["max_ulp"] <= POST_ULP for c in cs):
            failures.append(f"{name} is more than {POST_ULP} ulp from its "
                            f"plain version")
    # the masked pass's resolve on each round of the bench frame
    resolve_checks = []
    try:
        for r, (args, _) in enumerate(rec_m.calls):
            resolve_checks.append(compare_resolve(
                f"masked_round{r}_{WIDTH}x{HEIGHT}_k{args[0].shape[0]}",
                args))
    except Exception:
        traceback.print_exc()
        failures.append("resolve check raised")
    if (len(resolve_checks) < 2 or len(resolve_checks) != len(rec_m.calls)
            or not all(c["bit_exact"] for c in resolve_checks)):
        failures.append("masked_resolve disagrees with its plain version "
                        "(or a round's check is missing)")
    del rec_d, rec_k, rec_t, rec_m, cam_calls, sh_calls

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
        # the classifier's static-mode windows: the same image
        outs["static"] = driver.render(scene, cam, settings,
                                       dataclasses.replace(
                                           cfg, shadow_traced_windows=False))
        cs, ds, ss = (frame.stats_from_vec(outs[t]["stats_vec"])
                      for t in ("classified", "dense", "static"))
        cu8, du8, su8 = (outs[t]["color_u8"].cpu().numpy()
                         for t in ("classified", "dense", "static"))
        same = bool(np.array_equal(cu8, du8) and np.array_equal(cu8, su8))
        p = psnr(cu8.astype(np.float32) / 255.0,
                 du8.astype(np.float32) / 255.0)
        stats_equal = all(cs[k] == ds[k] == ss[k] for k in frame.STATS_KEYS
                          if k != "fallback_px")
        emit({"phase": "exactness", "width": WIDTH, "height": HEIGHT,
              "frames_per_run": EXACT_FRAMES,
              "frame_ms_classified": runs["classified"],
              "frame_ms_dense": runs["dense"], "u8_equal": same,
              "psnr_db": p, "stats_classified": cs, "stats_dense": ds,
              "stats_equal_but_fallback": stats_equal,
              "fallback_px": cs["fallback_px"],
              "fallback_px_static_windows": ss["fallback_px"],
              "launches": e_launches})
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

    # ---- 9. sharded strips of the bench frame on the card
    sd_b, st_b = driver.frame_inputs(scene, cam, settings, cfg)
    sharded_launches = {name: 0 for name in KERNELS}
    strip_errs = {name: 0.0 for name in KERNELS}
    two_strips = None
    masked_ids = range(host.n_opaque, host.n_opaque + host.n_masked)

    def dense_views(rec):
        """(tid, rows, vattr) of each view's dense G-buffer build."""
        return [(a[2], a[3], a[4]) for a, _ in rec.calls if a[2].dim() == 2]

    def rerun(calls):
        """The k-buffer outputs of recorded calls, run again."""
        return [rk.rasterize_layers_grid(*a, **kw) for a, kw in calls]

    with Recorder(frame, "_build_gbuffer") as rec_g, \
            Recorder(rk, "rasterize_layers_grid") as rec_l:
        frame.render_frame(scene, sd_b, st_b, cfg)
    (ref_g,) = dense_views(rec_g)
    ref_layers = rerun(rec_l.calls)
    del rec_g, rec_l
    for n in STRIPS:
        try:
            reset_counts()
            t0 = time.perf_counter()
            s_out = sharded.render_frame_sharded(scene, sd_b, st_b, cfg, n=n)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(SHARDED_FRAMES):
                s_out = sharded.render_frame_sharded(scene, sd_b, st_b, cfg,
                                                     n=n)
            torch.cuda.synchronize()
            s_ms = 1000.0 * (time.perf_counter() - t0) / SHARDED_FRAMES
            s_launches = read_counts()
            for name in KERNELS:
                sharded_launches[name] += s_launches[name]
            # per strip, after the counted run: its shadow rows, then its
            # view over the joined maps, every kernel launch recorded
            shadow_ms, view_ms, strips = [], [], []
            with contextlib.ExitStack() as stack:
                recs = kernel_recorders(stack)
                rec_g = stack.enter_context(Recorder(frame, "_build_gbuffer"))
                for i in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    strips.append(sharded.shadow_strip(scene, sd_b, cfg, i,
                                                       n))
                    torch.cuda.synchronize()
                    shadow_ms.append(1000.0 * (time.perf_counter() - t0))
                maps = torch.cat([m for m, _ in strips], 1)
                ends = []       # each strip's last k-buffer call
                for i, (_, ovf) in enumerate(strips):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sharded.view_strip(scene, sd_b, st_b, cfg, i, n, maps,
                                       ovf)
                    torch.cuda.synchronize()
                    view_ms.append(1000.0 * (time.perf_counter() - t0))
                    ends.append(len(recs["raster_layers"].calls))
            strip_g = dense_views(rec_g)
            lcalls = recs["raster_layers"].calls
            strip_layers = [rerun(lcalls[b0:b1])
                            for b0, b1 in zip([0] + ends[:-1], ends)]
            kinds = flip_kinds(host, scene, sd_b["viewproj"], ref_g,
                               strip_g, masked_ids, ref4["depth"],
                               s_out["depth"], ref_layers, strip_layers,
                               cfg.tile_h, cfg.tile_w)
            del strip_layers
            tid = torch.cat([g[0] for g in strip_g])
            del strips, maps, rec_g
            s_stats = frame.stats_from_vec(s_out["stats_vec"])
            chk = {**strip_check(ref4, s_out, n, ref_g[0], tid), **kinds}
            emit({"phase": "sharded", "strips": n, "width": WIDTH,
                  "height": HEIGHT, "strip_height": HEIGHT // n,
                  "warmup_s": warm_s, "frames": SHARDED_FRAMES,
                  "frame_ms": s_ms, "frame_ms_single": frame_ms,
                  "strip_shadow_ms": shadow_ms, "strip_view_ms": view_ms,
                  "stats": s_stats, "launches": s_launches, **chk})
            failures.extend(strip_gate(f"{n} strips", chk, s_stats,
                                       WIDTH * HEIGHT))
            gate_launches(f"{n} strips", s_launches, KERNELS)
            # the kernels at the strips' shapes against their plain versions
            kc = launch_checks(recs)
            del recs, strip_g, tid
            emit({"phase": "sharded_kernels", "strips": n, **kc})
            for name, row in kc.items():
                strip_errs[name] = max(strip_errs[name], row["max_abs_err"])
                if row["calls"] == 0 or row["disagree"]:
                    failures.append(f"{n} strips: {name} disagrees with its "
                                    f"plain version on {row['disagree']} of "
                                    f"{row['calls']} launches")
            if n == 2:
                two_strips = s_out
        except Exception:
            traceback.print_exc()
            failures.append(f"sharded phase n={n} raised")
    # a world of two processes on the one card, against the n = 2 frame
    try:
        import tempfile
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mp.spawn(world_rank, args=(tmp,), nprocs=2, join=True)
            world_s = time.perf_counter() - t0
            got = torch.load(os.path.join(tmp, "rank0.pt"))
        if two_strips is None:
            raise RuntimeError("no n = 2 frame to compare the world with")
        same = {k: bool(torch.equal(
                    got[k].view(torch.int32) if k in ("color", "depth")
                    else got[k],
                    two_strips[k].cpu().view(torch.int32)
                    if k in ("color", "depth") else two_strips[k].cpu()))
                for k in ("color", "depth", "color_u8", "stats_vec")}
        emit({"phase": "sharded_world", "ranks": 2, "backend": "gloo",
              "gathered_on": got["gathered_on"], "frames": WORLD_FRAMES,
              "frame_ms": got["frame_ms"], "seconds": world_s,
              "rank0_launches": dict(zip(wrappers, got["launches"])),
              "bit_equal_to_2_strips": same,
              "stats": frame.stats_from_vec(got["stats_vec"])})
        if not all(same.values()):
            failures.append(f"the two-process world differs from the "
                            f"2-strip frame: {same}")
        if got["gathered_on"] != "cuda":
            failures.append("the world's frame was not gathered on the card")
    except Exception:
        traceback.print_exc()
        failures.append("sharded world failed to form or to gather")
    del ref4, two_strips, ref_g, ref_layers

    # ---- the procedural scene of phases 10 and 12, built after the bench
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

    # ---- 10. frame parity: kernels vs plain versions at 480x272
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
            with bench.plain_kernels():
                ref = driver.render(p_scene, p_cam, p_set, pcfg)
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

    # ---- 11. small-input reference: GPU frame vs the port's CPU path
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

    # ---- 12. the transparent pass at full width
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

    # ---- 13. the headless CLI, in-process
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

    # ---- 14. the viewer's core on the replica at 1280x720
    viewer_launches = {name: 0 for name in KERNELS}
    viewer_errs = {name: 0.0 for name in KERNELS}
    try:
        t0 = time.perf_counter()
        v = drive_viewer(scene, wrappers)
        seconds = time.perf_counter() - t0
        steps = v["steps"]
        viewer_launches = v["launches"]
        by_size = {}
        for prev, st in zip(steps, steps[1:]):
            if st["size"] == prev["size"]:   # not the first at its size
                by_size.setdefault("%dx%d" % st["size"], []).append(st["ms"])
        emit({"phase": "viewer", "scene": "sponza_replica",
              "window": [VIEWER_W, VIEWER_H], "frames": len(steps),
              "seconds": seconds,
              "sizes": ["%dx%d" % st["size"] for st in steps],
              "step_ms": [st["ms"] for st in steps],
              "hud": [st["hud"] for st in steps],
              "frame_ms_by_size": {k: sum(ms) / len(ms)
                                   for k, ms in by_size.items()},
              "frame_ms_same_state": v["same_state_ms"],
              "launches": viewer_launches,
              "launches_per_frame": {name: sorted({st["launches"][name]
                                                   for st in steps})
                                     for name in KERNELS},
              "library_builds_first_frame": steps[0]["builds"],
              "library_builds_after_first_frame":
                  steps[-1]["builds"] - steps[0]["builds"],
              "frames_differing_from_fresh_render": v["differ"],
              "quit_on_q": v["quit_on_q"],
              "stats_first": steps[0]["stats"],
              "stats_last": steps[-1]["stats"]})
        want = viewer_sizes()
        if [st["size"] for st in steps] != want:
            failures.append(f"viewer sizes {[st['size'] for st in steps]} "
                            f"do not follow the ladder {want}")
        if any(st["shape"] != [VIEWER_H, VIEWER_W, 3] for st in steps):
            failures.append("a viewer frame is not at window size")
        if v["differ"]:
            failures.append(f"viewer frames {v['differ']} differ from a "
                            f"fresh render of their state")
        if steps[-1]["builds"] != steps[0]["builds"]:
            failures.append("a CUDA library was built or loaded after the "
                            "viewer's first frame")
        if not v["quit_on_q"]:
            failures.append("the viewer's loop did not end on q alone")
        for i, st in enumerate(steps):
            gate_stats(f"viewer frame {i}", st["stats"])
        gate_launches("viewer", viewer_launches, KERNELS)
        if sorted(v["recorded"]) != sorted(VIEWER_LADDER):
            failures.append(f"viewer launches recorded at "
                            f"{sorted(v['recorded'])}, not every rung")
        for size, recs in sorted(v["recorded"].items()):
            kc = launch_checks(recs)
            emit({"phase": "viewer_kernels", "size": "%dx%d" % size, **kc})
            for name, row in kc.items():
                viewer_errs[name] = max(viewer_errs[name], row["max_abs_err"])
                if row["calls"] == 0 or row["disagree"]:
                    failures.append(f"viewer {size}: {name} disagrees with "
                                    f"its plain version on "
                                    f"{row['disagree']} of {row['calls']} "
                                    f"launches")
        del v, steps
    except Exception:
        traceback.print_exc()
        failures.append("viewer phase raised")

    # ---- 15. the benchmark driver, in-process, at its defaults
    bench_launches = {name: 0 for name in KERNELS}
    try:
        before = replica_digests()
        reset_counts()
        out_buf, err_buf = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_buf), \
                contextlib.redirect_stderr(err_buf):
            rc = bench.main(["--passes"])
        seconds = time.perf_counter() - t0
        bench_launches = read_counts()
        stdout = out_buf.getvalue().splitlines()
        err_lines = err_buf.getvalue().splitlines()
        jl = [json.loads(ln) for ln in err_lines if ln.startswith("{")]
        line = json.loads(stdout[0]) if len(stdout) == 1 else None
        parity = [ln for ln in jl if "parity_psnr_db" in ln]
        bstats = [ln for ln in jl if "frametime_ms" in ln]
        contin = [ln for ln in jl if "continuity_scene" in ln]
        unchanged = replica_digests() == before
        emit({"phase": "bench", "argv": ["--passes"], "rc": rc,
              "seconds": seconds, "card": card_line, "stdout": stdout,
              "stdout_line": line,
              "note": [ln for ln in err_lines if ln.startswith("NOTE")],
              "passes_table": [ln for ln in err_lines
                               if not ln.startswith(("{", "NOTE"))],
              "parity": parity, "stats": bstats, "continuity": contin,
              "launches": bench_launches,
              "replica_files_unchanged": unchanged})
        if rc != 0:
            failures.append(f"bench returned {rc}")
        if line is None or list(line) != BENCH_LINE_KEYS or \
                line["metric"] != "sponza_replica_1080p_fps":
            failures.append(f"bench stdout is not one contract line: "
                            f"{stdout}")
        if len(bstats) != 1 or list(bstats[0]) != BENCH_STATS_KEYS:
            failures.append(f"bench stats line missing or malformed: "
                            f"{bstats}")
        else:
            gate_stats("bench", bstats[0])
            if bstats[0]["backend"] != "cuda":
                failures.append(f"bench backend {bstats[0]['backend']}")
        if len(parity) != 1 or parity[0]["parity_pass"] is not True:
            failures.append(f"bench parity failed: {parity}")
        if len(contin) != 1:
            failures.append(f"bench continuity line missing: {contin}")
        for name in KERNELS:
            if bench_launches[name] < BENCH_FRAMES:
                failures.append(f"{name} launched {bench_launches[name]} "
                                f"times in the bench, fewer than its "
                                f"{BENCH_FRAMES} timed frames")
        if not unchanged:
            failures.append("the bench changed the replica's files")
    except Exception:
        traceback.print_exc()
        failures.append("bench phase raised")

    # ---- 16. the driver entries: one entry() step on the card against
    # the CPU's, then the dry run's world on the CPU
    entry_launches = {name: 0 for name in KERNELS}
    entry_errs = {name: 0.0 for name in KERNELS}
    try:
        fn, args = port_entry.entry()
        reset_counts()
        with contextlib.ExitStack() as stack:
            recs = kernel_recorders(stack)
            t0 = time.perf_counter()
            g_out = fn(*args)
            torch.cuda.synchronize()
            g_s = time.perf_counter() - t0
        entry_launches = read_counts()
        kc = launch_checks(recs)
        del recs
        emit({"phase": "entry_kernels", **kc})
        for name, row in kc.items():
            entry_errs[name] = row["max_abs_err"]
            if row["calls"] == 0 or row["disagree"]:
                failures.append(f"entry: {name} disagrees with its plain "
                                f"version on {row['disagree']} of "
                                f"{row['calls']} launches")
        cfn, cargs = port_entry.entry("cpu")
        t0 = time.perf_counter()
        c_out = cfn(*cargs)
        c_s = time.perf_counter() - t0
        p = psnr(g_out["color_u8"].cpu().numpy().astype(np.float32) / 255.0,
                 c_out["color_u8"].numpy().astype(np.float32) / 255.0)
        gs, cs = (frame.stats_from_vec(g_out["stats_vec"]),
                  frame.stats_from_vec(c_out["stats_vec"]))
        del fn, args, cfn, cargs, g_out, c_out
        t0 = time.perf_counter()
        dry = port_entry.dryrun_multichip(DRYRUN_WORKERS)
        dry_s = time.perf_counter() - t0
        emit({"phase": "entries", "entry_seconds_card": g_s,
              "entry_seconds_cpu": c_s, "psnr_db_card_vs_cpu": p,
              "stats": gs, "stats_equal": gs == cs,
              "launches": entry_launches,
              "dryrun_workers": DRYRUN_WORKERS,
              # the dry run renders on the host's CPU cores, never the card
              "dryrun_cpu_seconds": dry_s,
              "dryrun_stats": dry["stats"],
              "dryrun_shape": list(dry["color_u8"].shape)})
        if not (p >= 40.0 and gs == cs):
            failures.append(f"entry card vs CPU: PSNR {p:.2f} dB, stats "
                            f"{gs} vs {cs}")
        gate_launches("entry", entry_launches, KERNELS)
    except Exception:
        traceback.print_exc()
        failures.append("entries phase raised")

    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    def entry(name):
        cs = checks[name]
        source, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (launches[name] + sharded_launches[name]
                             + viewer_launches[name] + bench_launches[name]
                             + entry_launches[name]),
                "max_abs_err": max([c["max_abs_err"] for c in cs]
                                   + [strip_errs[name], viewer_errs[name],
                                      entry_errs[name]]),
                "max_ulp": max((c["max_ulp"] for c in cs
                                if c["max_ulp"] is not None), default=None),
                "ms": cs[0]["ms"], "ms_eager": cs[0]["ms_eager"],
                "plain_ms": cs[0]["plain_ms"],
                "bound_ms": cs[0]["bound_ms"], "bound_by": cs[0]["bound_by"],
                "library_ms": None}

    rc0 = resolve_checks[0] if resolve_checks else {}
    emit({"kernels": [entry(name) for name in KERNELS] + [{
        "name": "masked_resolve", "route": "cuda", "source": MASKED_SRC,
        "replaces": None, "launches": launches["masked_resolve"],
        "max_abs_err": max([c["max_abs_err"] for c in resolve_checks],
                           default=None),
        "max_ulp": None, "ms": rc0.get("ms"),
        "ms_eager": rc0.get("ms_eager"), "plain_ms": rc0.get("plain_ms"),
        "bound_ms": rc0.get("bound_ms"), "bound_by": rc0.get("bound_by"),
        "library_ms": None}]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
