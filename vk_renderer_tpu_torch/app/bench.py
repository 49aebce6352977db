"""Benchmark driver: the bench frame at 1920x1080 on the card.

Counterpart of the JAX package's ``bench.py`` (at the repository root),
step for step and in its order:

- scene: ``VKR_SPONZA`` (default ``assets/Sponza/Sponza.gltf`` in the
  checkout) with the procedural sky cubemap if that file exists, else the
  committed Sponza replica (``assets/sponza_replica``: the GLB and its KTX
  cubemap, written only when its tag file is missing) after a ``NOTE:``
  line on stderr.  ``--gltf PATH`` renders another glTF file instead,
  with the procedural sky, named after its stem (small scenes for CPU
  runs);
- the settings (CSM mode 3, tonemap), the pure ``config_from_settings``
  defaults at the frame size and the bench camera;
- one warm-up frame and one pull of its stats;
- with ``--passes``, ``graph/profiler.profile_passes`` as a table on
  stderr;
- the timed frames: a synchronise and one pull of the warm-up frame's
  stats vector before the clock starts, ``--frames`` frames each after a
  0.002 rad yaw step, a synchronise and one pull of the last frame's
  stats vector before it stops;
- stdout: exactly one JSON line, ``{"metric": "<scene>_1080p_fps",
  "value", "unit": "fps", "vs_baseline": fps / 60}`` (``<W>x<H>`` in
  place of ``1080p`` at another size);
- stderr: the parity line, the stats line (bench.py's nine keys, the
  warm-up frame's stats, ``backend`` the torch device type) and, unless
  ``--no-continuity`` or the scene is itself ``sponza_like``, the
  continuity line of the procedural 260k-triangle scene (one warm-up,
  then 10 timed frames closed the same way).

Parity renders the camera as the timed loop left it (bench.py's camera
object, moved by the loop) at 480x272 with 1024^2 shadow maps twice: with
the kernels, and inside ``plain_kernels()``, which swaps the five kernel
dispatchers for their plain PyTorch versions.  The kernels equal their
plain versions, so on the card the PSNR is infinite
(``utils.image.psnr`` returns ``inf`` for equal images) and
``json.dumps`` writes it as ``Infinity``, as bench.py's own line would;
Python's ``json.loads`` reads it back.  On the CPU both frames are plain.

Usage (the card is the default device; without one it exits 2 and
prints nothing on stdout; ``--device cpu`` runs the plain versions):
    python -m vk_renderer_tpu_torch.app.bench [--passes] [--no-continuity]
    python -m vk_renderer_tpu_torch.app.bench --device cpu \\
        --gltf tests/fixtures/textured_box/scene.gltf --width 64 \\
        --height 32 --shadow-size 256 --frames 2 --no-continuity

Nothing falls back: a kernel that fails to build or launch raises out of
``main``.  The parity frame's plain run is the only place where plain
versions run while a card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ..graph import driver, frame, profiler
from ..graph.scenedata import RenderSettings
from ..ops import masked, post
from ..ops import raster_kernels as rk
from ..scene import procedural, sponza_replica
from ..scene.camera import Camera
from ..scene.types import scene_to_torch
from ..utils.image import psnr
from .headless import build_scene

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
YAW_STEP = 0.002
CONTINUITY_FRAMES = 10
PARITY_W, PARITY_H, PARITY_SHADOW = 480, 272, 1024


@contextlib.contextmanager
def plain_kernels():
    """Swap the five kernel dispatchers the frame calls for their plain
    PyTorch versions for the body; restore them however it ends."""
    real = (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
            frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient,
            masked.masked_resolve)
    rk.rasterize_depth_grid = rk.rasterize_depth_grid_plain
    rk.rasterize_layers_grid = rk.rasterize_layers_grid_plain
    frame.POSTPROCESS_REGISTRY["tonemap"] = post.tonemap_plain
    post.gradient = post.gradient_plain
    masked.masked_resolve = masked.masked_resolve_plain
    try:
        yield
    finally:
        (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
         frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient,
         masked.masked_resolve) = real


def load_scene(gltf: str | None = None):
    """(host SceneArrays, scene name): ``gltf`` with the procedural sky
    if given, else bench.py's choice of the real Sponza or the committed
    replica."""
    if gltf:
        name = os.path.splitext(os.path.basename(gltf))[0]
        return build_scene(name, gltf), name
    sponza = os.environ.get("VKR_SPONZA",
                            os.path.join(REPO, "assets", "Sponza",
                                         "Sponza.gltf"))
    if os.path.exists(sponza):
        return build_scene("structure", sponza), "sponza"
    print("NOTE: real Sponza.gltf not found — benching the replica asset "
          "(assets/sponza_replica, set VKR_SPONZA to override)",
          file=sys.stderr)
    glb, ktx = sponza_replica.ensure_assets(
        os.path.join(REPO, "assets", "sponza_replica"))
    return build_scene("sponza", glb, ktx), "sponza_replica"


def bench_settings() -> RenderSettings:
    """bench.py's full feature set: CSM shadows (mode 3) and tonemap."""
    return RenderSettings(enable_shadows=True, shadow_mode=3,
                          enable_postprocess=True)


def bench_camera() -> Camera:
    """bench.py's camera, looking down the long axis."""
    cam = Camera(position=np.array([9.0, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2
    return cam


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(scene, cam: Camera, settings: RenderSettings, cfg):
    """One frame and its stats (one device-to-host pull): (out, stats)."""
    out = driver.render(scene, cam, settings, cfg)
    return out, frame.stats_from_vec(out["stats_vec"])


def time_frames(scene, cam: Camera, settings: RenderSettings, cfg, last,
                frames: int) -> float:
    """Seconds of ``frames`` frames, each after a YAW_STEP turn of
    ``cam``.  Everything queued before the clock starts is drained by a
    synchronise and a pull of ``last``'s stats vector; the clock stops
    after a synchronise and a pull of the last frame's."""
    device = scene.positions[0].device
    _sync(device)
    last["stats_vec"].cpu()
    t0 = time.perf_counter()
    for _ in range(frames):
        cam.yaw += YAW_STEP
        last = driver.render(scene, cam, settings, cfg)
    _sync(device)
    last["stats_vec"].cpu()
    return time.perf_counter() - t0


def parity_db(scene, cam: Camera, settings: RenderSettings) -> float:
    """PSNR of the PARITY_W x PARITY_H frame rendered with the kernels
    against the same frame rendered with their plain versions."""
    pcfg = driver.config_from_settings(settings, PARITY_W, PARITY_H,
                                       shadow_size=PARITY_SHADOW)

    def u8(out):
        return out["color_u8"].cpu().numpy().astype(np.float32) / 255.0

    fast = u8(driver.render(scene, cam, settings, pcfg))
    with plain_kernels():
        ref = u8(driver.render(scene, cam, settings, pcfg))
    return float(psnr(fast, ref))


def main(argv=None) -> int:
    """Parse ``argv``, run the bench, print its lines; returns the exit
    code (2 when the device asked for is absent)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", action="store_true",
                    help="print the per-pass ms breakdown to stderr")
    ap.add_argument("--no-continuity", action="store_true",
                    help="skip the procedural same-scene continuity frame")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--shadow-size", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--gltf", default=None,
                    help="bench this glTF file instead of Sponza")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"bench: --device {args.device} asked for, but no CUDA device "
              f"is available (pass --device cpu to run the plain versions "
              f"on the CPU)", file=sys.stderr)
        return 2

    host, scene_name = load_scene(args.gltf)
    scene = scene_to_torch(host, device)
    settings = bench_settings()
    cfg = driver.config_from_settings(settings, args.width, args.height,
                                      shadow_size=args.shadow_size)
    cam = bench_camera()

    out, stats = warm_up(scene, cam, settings, cfg)

    if args.passes:
        sd, st = driver.frame_inputs(scene, cam, settings, cfg)
        timings = profiler.profile_passes(scene, sd, st, cfg)
        print(profiler.format_table(timings), file=sys.stderr)

    dt = time_frames(scene, cam, settings, cfg, out, args.frames)
    fps = args.frames / dt
    size = ("1080p" if (args.width, args.height) == (1920, 1080)
            else f"{args.width}x{args.height}")
    print(json.dumps({
        "metric": f"{scene_name}_{size}_fps",
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 4),
    }), flush=True)

    p_db = parity_db(scene, cam, settings)
    print(json.dumps({"parity_psnr_db": p_db,
                      "parity_pass": p_db >= 40.0}), file=sys.stderr)

    print(json.dumps({
        "frametime_ms": round(1000 * dt / args.frames, 3),
        "triangles": stats["triangles"],
        "drawcalls": stats["drawcalls"],
        "bin_overflow": stats["bin_overflow"],
        "peel_overflow": stats["peel_overflow"],
        "sparse_overflow": stats["sparse_overflow"],
        "fallback_px": stats["fallback_px"],
        "backend": device.type,
        "scene_triangles": int(scene.num_triangles),
    }), file=sys.stderr)

    if not args.no_continuity and scene_name != "sponza_like":
        del scene, out
        pscene = scene_to_torch(procedural.build_sponza_like().build(),
                                device)
        out, _ = warm_up(pscene, cam, settings, cfg)
        cdt = time_frames(pscene, cam, settings, cfg, out,
                          CONTINUITY_FRAMES) / CONTINUITY_FRAMES
        print(json.dumps({
            "continuity_scene": "procedural_sponza_like",
            "continuity_frametime_ms": round(1000 * cdt, 3),
            "continuity_fps": round(1.0 / cdt, 3),
        }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
