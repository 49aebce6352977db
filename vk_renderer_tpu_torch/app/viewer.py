"""Interactive viewer — the SDL window + camera-input loop equivalent.

Port of vk_renderer_tpu/app/viewer.py.  Reference: run()
(src/vk_engine_run.cpp:16-66) + Camera input (src/vk_camera.cpp:6-24) +
the ImGui settings window (vk_engine_run.cpp:200-232).  The key bindings
map the reference's:

  W/A/S/D   move (5 units/s, vk_camera.cpp:30)
  drag      look (yaw/pitch at 1/200 rad per pixel, vk_camera.cpp:10-11)
  1..4      shadow mode Hard/PCF/PCSS/CSM
  h         toggle shadows        b  toggle background
  p         toggle postprocess    q/ESC  quit
  j/l i/k   sun azimuth / elevation (ImGui Scene Lighting panel analog)
  - = [ ]   sunlight / ambient intensity
  , .       render scale down/up (the resize_swapchain analog,
            vk_engine.cpp:95-128)

Two parts:

- ``ViewerSession``, the window-free core: the scene on its device, the
  settings, the camera, the render-scale ladder, the 500 ms frame-time
  window and the held-key emulation.  ``frame(now)`` renders one
  iteration of the loop and returns the RGB image at window size on the
  scene's device (the nearest-neighbour upscale is an index gather on the
  device); ``key``, ``mouse`` and ``trackbars`` take the input.  It needs
  no window, so it also runs where there is no display or OpenCV.
- ``main(argv)``, the shell: OpenCV's HighGUI window, mouse callback,
  trackbars, HUD text and key polling.  Only it imports ``cv2``.

The port is eager: every toggle flips a per-frame tensor and a resize
only changes the frame's shapes, so the CUDA kernels are built once, at
the first frame, and no toggle or resize builds or loads a library again.

Usage (a display and OpenCV are needed; the GPU is the default device):
    python -m vk_renderer_tpu_torch.app.viewer \
        --gltf assets/sponza_replica/Sponza.glb \
        --cubemap assets/sponza_replica/pisa_cube.ktx
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ..graph import driver
from ..graph.frame import stats_from_vec
from ..graph.scenedata import RenderSettings
from ..scene.camera import Camera

SCALES = (0.5, 0.75, 1.0)
HOLD_S = 0.25
SHADOW_MODES = ("Hard", "PCF", "PCSS", "CSM")
NO_KEY, ESC = 255, 27
WINDOW = "vk_renderer_tpu"


def ladder_size(width: int, height: int, scale: float) -> tuple[int, int]:
    """The render size at one rung of the ladder: any size works (the
    raster kernels guard partial tiles); scale 1.0 renders exactly the
    requested window size."""
    return max(128, int(width * scale)), max(64, int(height * scale))


def nearest_index(src: int, dst: int) -> np.ndarray:
    """The source index of each of ``dst`` output positions, as OpenCV's
    ``resize(..., INTER_NEAREST)`` picks it: floor(i * (1 / (dst / src)))
    in double precision, clamped to the last source position."""
    step = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * step).astype(np.int64),
                      src - 1)


def upscale_nearest(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """``img`` ([h, w, C]) resized to [height, width, C] by nearest
    neighbour, on its own device (the swapchain-blit upscale)."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    ys = torch.from_numpy(nearest_index(h, height)).to(img.device)
    xs = torch.from_numpy(nearest_index(w, width)).to(img.device)
    return img.index_select(0, ys).index_select(1, xs)


class ViewerSession:
    """The viewer's loop state without a window (module docstring).  The
    caller reads the clock once per iteration and passes that reading to
    ``frame`` and then to ``key``, as the loop of the JAX viewer does."""

    def __init__(self, scene, width: int, height: int, now: float,
                 camera: Camera | None = None):
        self.scene = scene
        self.width, self.height = width, height
        self.settings = RenderSettings()
        self.cam = camera if camera is not None else Camera()
        # ONE config per resolution, the shadow subsystem always built
        # (enable_shadows=True): h / 1-4 / b / p flip per-frame tensors
        self._cfgs: dict[int, object] = {}
        self.scale_i = len(SCALES) - 1
        self.cfg = self.cfg_at(self.scale_i)
        self.last = now
        # 500 ms-WINDOW rolling frametime + fps, the reference's
        # accumulation (vk_engine_run.cpp:26-32)
        self.win_t, self.win_n = 0.0, 0
        self.frametime_ms, self.fps = 0.0, 0.0
        # HighGUI delivers ONE key per poll and no key-up events: each
        # movement key stays "down" for HOLD_S after its last poll
        self.held: dict[int, float] = {}
        self.drag: tuple[int, int] | None = None

    def cfg_at(self, i: int):
        """The FrameConfig of ladder rung ``i`` (built once per rung)."""
        if i not in self._cfgs:
            w, h = ladder_size(self.width, self.height, SCALES[i])
            self._cfgs[i] = replace(
                driver.config_from_settings(self.settings, w, h),
                enable_shadows=True)
        return self._cfgs[i]

    def frame(self, now: float):
        """One loop iteration at clock reading ``now``: move the camera by
        the elapsed time, render, advance the frame-time window.  Returns
        (RGB u8 [height, width, 3] on the scene's device, HUD text,
        stats)."""
        dt, self.last = now - self.last, now
        self.cam.update(dt)
        out = driver.render(self.scene, self.cam, self.settings, self.cfg)
        img = upscale_nearest(out["color_u8"], self.height, self.width)
        self.win_t += dt
        self.win_n += 1
        if self.win_t >= 0.5:                 # the 500 ms window rolls over
            self.frametime_ms = 1000.0 * self.win_t / self.win_n
            self.fps = self.win_n / self.win_t
            self.win_t, self.win_n = 0.0, 0
        stats = stats_from_vec(out["stats_vec"])
        s = self.settings
        hud = (f"{self.cfg.width}x{self.cfg.height}  "
               f"{self.frametime_ms:.1f} ms  {self.fps:.1f} fps  "
               f"tris {stats['triangles']}  "
               f"draws {stats['drawcalls']}  "
               f"shadows {'on' if s.enable_shadows else 'off'}"
               f"/{SHADOW_MODES[s.shadow_mode]}")
        return img, hud, stats

    def key(self, key: int, now: float) -> bool:
        """One key poll (NO_KEY when none) at the iteration's clock
        reading ``now``: the held-key set, the camera's velocity, then
        the key's action.  Returns False on q / ESC."""
        if key != NO_KEY:
            self.held[key] = now
        down = {k for k, t in self.held.items() if now - t < HOLD_S}
        self.cam.process_keys(w=ord("w") in down, s=ord("s") in down,
                              a=ord("a") in down, d=ord("d") in down)
        s = self.settings
        if key in (ord("q"), ESC):
            return False
        elif key == ord("h"):
            s.enable_shadows = not s.enable_shadows
        elif key == ord("b"):
            s.enable_background = not s.enable_background
        elif key == ord("p"):
            s.enable_postprocess = not s.enable_postprocess
        elif key in (ord("1"), ord("2"), ord("3"), ord("4")):
            s.shadow_mode = key - ord("1")
        elif key in (ord(","), ord(".")):          # render-scale resize
            self.scale_i = int(np.clip(
                self.scale_i + (1 if key == ord(".") else -1),
                0, len(SCALES) - 1))
            self.cfg = self.cfg_at(self.scale_i)
            self.win_t, self.win_n = 0.0, 0        # restart the stat window
        # light editing (the ImGui Scene Lighting panel,
        # vk_engine_run.cpp:212-216)
        elif key in (ord("j"), ord("l")):          # rotate sun azimuth
            a = 0.1 if key == ord("l") else -0.1
            c, s_ = np.cos(a), np.sin(a)
            d = s.sunlight_direction
            d[0], d[2] = c * d[0] - s_ * d[2], s_ * d[0] + c * d[2]
        elif key in (ord("i"), ord("k")):          # raise/lower sun
            s.sunlight_direction[1] = float(np.clip(
                s.sunlight_direction[1] + (-0.1 if key == ord("i") else 0.1),
                -2.0, 2.0))
        elif key in (ord("-"), ord("=")):          # sunlight intensity
            f = 1.25 if key == ord("=") else 0.8
            s.sunlight_color[:3] = np.clip(s.sunlight_color[:3] * f,
                                           0.0, 16.0)
        elif key in (ord("["), ord("]")):          # ambient intensity
            f = 1.25 if key == ord("]") else 0.8
            s.ambient_color[:3] = np.clip(s.ambient_color[:3] * f, 0.0, 4.0)
        return True

    def mouse(self, event: str, x: int, y: int) -> None:
        """A drag looks around: ``event`` is "down" (a button pressed),
        "up" (released) or "move"."""
        if event == "down":
            self.drag = (x, y)
        elif event == "up":
            self.drag = None
        elif event == "move" and self.drag is not None:
            self.cam.process_mouse(x - self.drag[0], y - self.drag[1])
            self.drag = (x, y)

    def trackbars(self) -> list:
        """The Scene Lighting colour editors (vk_engine_run.cpp:213-216),
        one 0..255 slider per channel writing through to the settings
        (sun colour 0..4, ambient 0..1), as (name, initial position,
        setter(value)) in the order the window creates them."""
        def setter(arr, ch, scale):
            def set_value(v):
                arr[ch] = v / 255.0 * scale
            return set_value

        s = self.settings
        out = []
        for ch, name in enumerate("RGB"):
            out.append((f"sun {name}",
                        int(np.clip(s.sunlight_color[ch], 0, 4) / 4.0 * 255),
                        setter(s.sunlight_color, ch, 4.0)))
            out.append((f"ambient {name}",
                        int(np.clip(s.ambient_color[ch], 0, 1) * 255),
                        setter(s.ambient_color, ch, 1.0)))
        return out


def main(argv=None) -> int:
    """The HighGUI window around a ViewerSession; returns the exit code
    (2 when the device asked for is absent)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cube")
    ap.add_argument("--gltf", default=None)
    ap.add_argument("--cubemap", default=None, help="KTX1/KTX2 skybox file")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"viewer: --device {args.device} asked for, but no CUDA "
              f"device is available (pass --device cpu to render on the "
              f"CPU)", file=sys.stderr)
        return 2
    try:
        import cv2
    except ImportError:
        raise SystemExit("viewer requires OpenCV (cv2)")

    from ..scene.types import scene_to_torch
    from .headless import build_scene

    scene = scene_to_torch(build_scene(args.scene, args.gltf, args.cubemap),
                           device)
    session = ViewerSession(scene, args.width, args.height,
                            time.perf_counter())

    def on_mouse(event, x, y, flags, _param):
        if event in (cv2.EVENT_MBUTTONDOWN, cv2.EVENT_LBUTTONDOWN):
            session.mouse("down", x, y)
        elif event in (cv2.EVENT_MBUTTONUP, cv2.EVENT_LBUTTONUP):
            session.mouse("up", x, y)
        elif event == cv2.EVENT_MOUSEMOVE:
            session.mouse("move", x, y)

    cv2.namedWindow(WINDOW)
    cv2.setMouseCallback(WINDOW, on_mouse)
    for name, pos, setter in session.trackbars():
        cv2.createTrackbar(name, WINDOW, pos, 255, setter)

    while True:
        now = time.perf_counter()
        img, hud, _ = session.frame(now)
        bgr = img.cpu().numpy()[:, :, ::-1].copy()
        cv2.putText(bgr, hud, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
        cv2.imshow(WINDOW, bgr)
        if not session.key(cv2.waitKey(1) & 0xFF, now):
            break
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
