"""Headless renderer CLI — the windowless run() loop.

Counterpart of vk_renderer_tpu/app/headless.py.  Replaces the reference's
SDL main loop + ImGui overlay (src/vk_engine_run.cpp:16-66, 200-232) with
a camera-path player that renders N frames, writes PNGs, and prints the
stats the overlay shows (frametime / triangles / drawcalls) plus the
renderer's own deviation counters, one JSON line per frame, then one line
of averages over the frames after the first.

Usage (the GPU is the default device; ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU instead):
    python -m vk_renderer_tpu_torch.app.headless --scene sponza_like \
        --frames 8 --width 1920 --height 1080 --out frames --shadows --mode 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_scene(name: str, gltf_path: str | None,
                cubemap_path: str | None = None):
    """Host SceneArrays: a glTF file, or the procedural ``cube`` or
    ``sponza_like`` scene."""
    from ..scene import procedural
    cubemap = None
    if cubemap_path:  # KTX1/KTX2 skybox (ref: load_cubemap, vk_loader.cpp:521)
        from ..scene.ktx import load_cubemap
        cubemap = load_cubemap(cubemap_path)
    if gltf_path:
        from ..scene.assembly import SceneBuilder
        b = SceneBuilder()
        b.load_gltf(gltf_path, name or "scene")
        b.cubemap = (cubemap if cubemap is not None
                     else procedural.make_sky_cubemap(256))
        return b.build()
    b = (procedural.build_cube_scene() if name == "cube"
         else procedural.build_sponza_like())
    if cubemap is not None:
        b.cubemap = cubemap
    return b.build()


def camera_path(i: int, n: int):
    """Slow orbit through the colonnade."""
    from ..scene.camera import Camera
    t = i / max(n, 1)
    cam = Camera(position=np.array([9.0 - 14.0 * t, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2 + 0.2 * np.sin(t * 2 * np.pi)
    return cam


def main(argv=None) -> int:
    """Parse ``argv``, render, print the stats lines; returns the exit
    code (non-zero when the device asked for is absent)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sponza_like")
    ap.add_argument("--gltf", default=None, help="explicit glTF path")
    ap.add_argument("--cubemap", default=None,
                    help="KTX1/KTX2 cubemap file for the skybox")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=1280)   # vk_engine.h:38
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--out", default=None, help="PNG output directory")
    ap.add_argument("--shadows", action="store_true")
    ap.add_argument("--mode", type=int, default=0,
                    help="shadow mode: 0 Hard 1 PCF 2 PCSS 3 CSM")
    ap.add_argument("--background", action="store_true")
    ap.add_argument("--tonemap", action="store_true")
    ap.add_argument("--flat", action="store_true", help="mesh.frag shading")
    ap.add_argument("--overlap", type=int, default=2,
                    help="frames in flight (the FRAME_OVERLAP=2 analog, "
                         "vk_engine.h:10): render frame N before pulling "
                         "frame N-overlap+1's stats; 1 = serialized")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    import torch

    from ..graph import driver
    from ..graph.frame import stats_from_vec
    from ..graph.scenedata import RenderSettings
    from ..scene.types import scene_to_torch
    from ..utils.image import save_png

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"headless: --device {args.device} asked for, but no CUDA "
              f"device is available (pass --device cpu to render on the "
              f"CPU)", file=sys.stderr)
        return 2

    scene = scene_to_torch(build_scene(args.scene, args.gltf, args.cubemap),
                           device)
    settings = RenderSettings(enable_shadows=args.shadows,
                              shadow_mode=args.mode,
                              enable_background=args.background,
                              enable_postprocess=args.tonemap)
    cfg = driver.config_from_settings(settings, args.width, args.height,
                                      shading="flat" if args.flat else "pbr")
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    # frames in flight: frame N is rendered before frame N-overlap+1's
    # stats are pulled (the pull is the fence wait)
    overlap = max(1, args.overlap)
    inflight: list[tuple[int, dict]] = []
    clock = {"last": None}

    def pull(entry):
        i, out = entry
        stats = stats_from_vec(out["stats_vec"])  # blocks: the fence wait
        now = time.perf_counter()
        dt_ms = (now - clock["last"]) * 1000 if clock["last"] else 0.0
        clock["last"] = now
        print(json.dumps({
            "frame": i,
            "frametime_ms": round(dt_ms, 3),   # pull-to-pull (pipelined)
            "triangles": stats["triangles"],
            "drawcalls": stats["drawcalls"],
            "bin_overflow": stats["bin_overflow"],
            "peel_overflow": stats["peel_overflow"],
            "sparse_overflow": stats["sparse_overflow"],
        }), flush=True)
        if args.out:
            save_png(os.path.join(args.out, f"frame_{i:04d}.png"),
                     out["color_u8"].cpu().numpy())

    t_loop = None
    for i in range(args.frames):
        cam = camera_path(i, args.frames)
        out = driver.render(scene, cam, settings, cfg)
        if i == 0:
            # warm-up frame (kernel build, allocator): retire it, start
            # the clock
            pull((0, out))
            t_loop = time.perf_counter()
            continue
        inflight.append((i, out))
        if len(inflight) >= overlap:
            pull(inflight.pop(0))
    while inflight:
        pull(inflight.pop(0))
    if args.frames > 1 and t_loop is not None:
        total = time.perf_counter() - t_loop
        n = args.frames - 1
        print(json.dumps({"avg_frametime_ms": round(1000 * total / n, 3),
                          "avg_fps": round(n / total, 2),
                          "overlap": overlap, "device": str(device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
