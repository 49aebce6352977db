#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vk_renderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:
  1. card: the GPU's name and power limit (nvidia-smi),
  2. build: compile csrc/raster.cu for sm_90a from this checkout,
  3. scene: load the committed Sponza replica (assets/sponza_replica),
  4. frame: the bench frame — driver.render at 1920x1080, CSM mode 3,
     skybox, tonemap, at the bench camera — one warm-up frame, then the
     mean of the timed frames, with every raster kernel's launch count
     over that run; bin/peel/sparse overflow must be 0,
  5. kernels: each CUDA kernel on the bench frame's own inputs (camera
     opaque records at 1080p and one 2048^2 cascade for the depth
     raster, masked round 0 for the k-buffer) against its plain PyTorch
     version, bit for bit, with both times,
  6. parity: the 480x272 frame rendered with the kernels against the same
     frame rendered with the plain versions (PSNR >= 40 dB),
  7. reference: the glTF test fixture (MASK material, CSM shadows, skybox)
     at 256x128 on the GPU against the port's CPU path, which the CPU
     tests hold against the JAX package's goldens (PSNR >= 40 dB, equal
     stats).
Then one {"kernels": [...]} line, the card line as nvidia-smi prints it,
and last {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, when there is no CUDA device or the package is missing, and
non-zero after any failed phase.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

WIDTH, HEIGHT, SHADOW_SIZE = 1920, 1080, 2048
PARITY_W, PARITY_H, PARITY_SHADOW = 480, 272, 1024
TIMED_FRAMES = 5
KERNEL_REPS = 10
SRC = "vk_renderer_tpu_torch/csrc/raster.cu"
FIXTURE = "tests/fixtures/textured_box/scene.gltf"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 1


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


class Recorder:
    """Wraps a kernel wrapper of ops/raster_kernels to keep the arguments
    of its calls (the bench frame's own kernel inputs)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.real(*args, **kw)
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def compare(name, shape_tag, kernel_fn, plain_fn, args, kw):
    """Kernel vs plain version on the same inputs: bit-for-bit check of
    depth and ids, max |depth difference|, and both times."""
    import torch
    kd, ki = kernel_fn(*args, **kw)
    pd, pi = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(kd, pd) and torch.equal(ki, pi))
    err = float((kd - pd).abs().max()) if kd.numel() else 0.0
    id_mismatch = int((ki != pi).sum())
    ms = cuda_ms(lambda: kernel_fn(*args, **kw), KERNEL_REPS)
    plain_ms = cuda_ms(lambda: plain_fn(*args, **kw), 1)
    out = {"phase": "kernel_check", "kernel": name, "input": shape_tag,
           "tiles": int(args[2].shape[0]),
           "records": int(args[0].shape[0]),
           "max_count": int(args[2].max()) if args[2].numel() else 0,
           "bit_exact": same, "max_abs_err": err,
           "id_mismatches": id_mismatch, "ms": ms, "plain_ms": plain_ms}
    emit(out)
    return out


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
        from vk_renderer_tpu_torch.graph import driver, frame
        from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
        from vk_renderer_tpu_torch.ops import raster_kernels as rk
        from vk_renderer_tpu_torch.scene import ktx
        from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
        from vk_renderer_tpu_torch.scene.camera import Camera
        from vk_renderer_tpu_torch.scene.types import scene_to_torch
        from vk_renderer_tpu_torch.utils.image import psnr
    except ImportError as e:
        return fail(f"the port's package is missing ({e}); run from the "
                    "root of a checkout")
    if "jax" in sys.modules:
        return fail("the port imported jax")

    failures = []
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    emit({"phase": "card", "nvidia_smi": card_line, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    try:
        lib_path = rk.build_kernels()
        log = os.path.splitext(lib_path)[0] + ".log"
        ptxas = ""
        if os.path.exists(log):
            with open(log) as f:
                ptxas = " | ".join(ln.strip() for ln in f
                                   if "registers" in ln or "spill" in ln)
        emit({"phase": "build", "ok": True, "source": SRC,
              "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    except Exception as e:   # a build failure ends the run
        emit({"phase": "build", "ok": False, "error": str(e)[-2000:]})
        return fail("kernel build failed")

    # ---- 3. scene
    t0 = time.perf_counter()
    b = SceneBuilder()
    b.load_gltf("assets/sponza_replica/Sponza.glb", "sponza")
    b.cubemap = ktx.load_cubemap("assets/sponza_replica/pisa_cube.ktx")
    host = b.build()
    scene = scene_to_torch(host, dev)
    torch.cuda.synchronize()
    emit({"phase": "scene", "triangles": int(host.num_triangles),
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
    rk.rasterize_depth_grid.launches = 0
    rk.rasterize_layers_grid.launches = 0
    with Recorder(rk, "rasterize_depth_grid") as rec_d, \
            Recorder(rk, "rasterize_layers_grid") as rec_k:
        t0 = time.perf_counter()
        out = driver.render(scene, cam, settings, cfg)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        out = driver.render(scene, cam, settings, cfg)
    torch.cuda.synchronize()
    frame_ms = 1000.0 * (time.perf_counter() - t0) / TIMED_FRAMES
    launches = {"raster_depth": rk.rasterize_depth_grid.launches,
                "raster_layers": rk.rasterize_layers_grid.launches}
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
    for key in ("bin_overflow", "peel_overflow", "sparse_overflow"):
        if stats[key] != 0:
            failures.append(f"frame {key} = {stats[key]}")
    if not (finite and shape_ok):
        failures.append("frame output not finite or misshapen")
    for name, n in launches.items():
        if n == 0:
            failures.append(f"{name} never launched on the main path")

    # ---- 5. kernels vs plain versions on the frame's own inputs
    cam_tiles = math.ceil(WIDTH / cfg.tile_w) * math.ceil(HEIGHT / cfg.tile_h)
    cam_calls = [c for c in rec_d.calls if c[0][2].shape[0] == cam_tiles]
    sh_calls = [c for c in rec_d.calls if c[0][2].shape[0] ==
                math.ceil(cfg.shadow_size / cfg.tile_w)
                * math.ceil(cfg.shadow_size / cfg.tile_h)]
    checks = {"raster_depth": [], "raster_layers": []}
    try:
        checks["raster_depth"].append(compare(
            "raster_depth", f"camera_opaque_{WIDTH}x{HEIGHT}",
            rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
            *cam_calls[-1]))
        checks["raster_depth"].append(compare(
            "raster_depth", f"shadow_cascade0_{SHADOW_SIZE}",
            rk.rasterize_depth_grid, rk.rasterize_depth_grid_plain,
            *sh_calls[0]))
        checks["raster_layers"].append(compare(
            "raster_layers", f"masked_round0_{WIDTH}x{HEIGHT}",
            rk.rasterize_layers_grid, rk.rasterize_layers_grid_plain,
            *rec_k.calls[0]))
    except Exception:
        traceback.print_exc()
        failures.append("kernel check raised")
    for name, cs in checks.items():
        if not cs or not all(c["bit_exact"] for c in cs):
            failures.append(f"{name} disagrees with its plain version")
    del rec_d, rec_k, cam_calls, sh_calls

    # ---- 6. frame parity: kernels vs plain versions at 480x272
    pcfg = driver.config_from_settings(settings, PARITY_W, PARITY_H,
                                       shadow_size=PARITY_SHADOW)
    try:
        t0 = time.perf_counter()
        fast = driver.render(scene, cam, settings, pcfg)["color_u8"]
        real = (rk.rasterize_depth_grid, rk.rasterize_layers_grid)
        rk.rasterize_depth_grid = rk.rasterize_depth_grid_plain
        rk.rasterize_layers_grid = rk.rasterize_layers_grid_plain
        try:
            ref = driver.render(scene, cam, settings, pcfg)["color_u8"]
        finally:
            rk.rasterize_depth_grid, rk.rasterize_layers_grid = real
        p = psnr(fast.cpu().numpy().astype(np.float32) / 255.0,
                 ref.cpu().numpy().astype(np.float32) / 255.0)
        emit({"phase": "parity", "width": PARITY_W, "height": PARITY_H,
              "shadow_size": PARITY_SHADOW, "psnr_db": p,
              "seconds": time.perf_counter() - t0})
        if not p >= 40.0:
            failures.append(f"parity PSNR {p:.2f} dB < 40 dB")
    except Exception:
        traceback.print_exc()
        failures.append("parity phase raised")

    # ---- 7. small-input reference: GPU frame vs the port's CPU path
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

    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    def entry(name, replaces):
        cs = checks[name]
        return {"name": name, "route": "cuda", "source": SRC,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "ms": cs[0]["ms"], "plain_ms": cs[0]["plain_ms"]}

    emit({"kernels": [
        entry("raster_depth", "vk_renderer_tpu/ops/raster_pallas.py:50"),
        entry("raster_layers", "vk_renderer_tpu/ops/raster_pallas.py:147"),
    ]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
