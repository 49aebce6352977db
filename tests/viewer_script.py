"""A scripted, window-free drive of a viewer's ``main`` (the JAX
package's or the port's), shared by tests/test_torch_viewer.py (the port
against the JAX viewer on the CPU) and tests/test_torch_cuda.py (the
port on the card against the port on the CPU).  Imports no JAX.

- ``HighGUI`` stands in for the part of ``cv2`` the viewers call: it
  keeps the mouse and trackbar callbacks, records every ``imshow`` image
  and ``putText`` string, and its ``waitKey`` plays ``SCRIPT``.
- ``Clock`` is a fixed-step ``time`` for the viewer module.
- ``run_viewer`` also wraps the package's ``driver.render`` to record the
  camera, settings, size and stats of every frame, and its
  ``driver.config_from_settings`` to give the viewer small shadow maps
  and a smaller program (``SMALL``; the default 2048^2 cascades cost
  seconds a frame on the CPU, the JAX frame's compile about a minute a
  size on one core)."""

import dataclasses
import sys
import types

import numpy as np

W, H = 256, 128
ARGV = ["--scene", "cube", "--width", str(W), "--height", str(H)]
# the small-frame sizes of tests/test_frame.py, and the dense shadow
# filter and no sky compaction (exact alternatives, each held to the
# default paths elsewhere), which cut the JAX frame's compile by ~40%
SMALL = dict(cap_opaque=128, cap_masked=64, cap_transparent=64,
             shadow_size=256, shadow_cap=256, shadow_classify_cap=0,
             sky_sparse_cap=0)
CLOCK_STEP = 0.125      # four frames fill the 500 ms window
MOUSE = {"down": 1, "move": 0, "up": 4}     # HighGUI's event codes
# one waitKey poll per frame: (key or None, [actions fired during the
# poll]); an action is ("drag", [(event, x, y), ...]) or
# ("slider", name, value).  Every key binding but ESC, the six sliders,
# one drag and one resize (',' to 3/4 scale and '.' back).
SCRIPT = [
    ("h", [("slider", "sun R", 200), ("slider", "ambient G", 90)]),
    ("1", [("slider", "sun G", 30), ("slider", "ambient R", 10)]),
    ("2", [("slider", "sun B", 255), ("slider", "ambient B", 40)]),
    ("3", []), ("4", []), ("h", []), ("b", []), ("p", []),
    ("j", []), ("l", []), ("l", []), ("i", []), ("k", []), ("k", []),
    ("-", []), ("=", []), ("=", []), ("[", []), ("]", []),
    ("w", []), ("a", []),
    (None, [("drag", [("down", 40, 30), ("move", 70, 45),
                      ("move", 100, 41), ("up", 100, 41)])]),
    ("s", []), ("d", []),
    (",", []), (None, []), (".", []),
    ("q", []),
]


class Clock:
    """time.perf_counter() stepping CLOCK_STEP per reading."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += CLOCK_STEP
        return self.t


class HighGUI(types.ModuleType):
    """The part of cv2 the viewers call, without a window."""
    EVENT_MOUSEMOVE, EVENT_LBUTTONDOWN, EVENT_MBUTTONDOWN = 0, 1, 3
    EVENT_LBUTTONUP, EVENT_MBUTTONUP = 4, 6
    INTER_NEAREST, FONT_HERSHEY_SIMPLEX = 0, 0

    def __init__(self, script):
        super().__init__("cv2")
        self.script = list(script)
        self.shown, self.texts, self.sliders = [], [], {}
        self.on_mouse = None

    def namedWindow(self, win):
        pass

    def setMouseCallback(self, win, fn):
        self.on_mouse = fn

    def createTrackbar(self, name, win, pos, top, fn):
        self.sliders[name] = (pos, top, fn)

    def resize(self, img, size, interpolation):
        """Nearest neighbour as OpenCV picks it (tests/test_torch_viewer.py
        holds this index to cv2.resize)."""
        from vk_renderer_tpu_torch.app.viewer import nearest_index
        w, h = size
        return img[nearest_index(img.shape[0], h)][
            :, nearest_index(img.shape[1], w)]

    def putText(self, img, text, org, font, scale, colour, thickness):
        self.texts.append(text)

    def imshow(self, win, img):
        self.shown.append(np.array(img))

    def waitKey(self, delay):
        key, actions = self.script.pop(0)
        for act in actions:
            if act[0] == "drag":
                for ev, x, y in act[1]:
                    self.on_mouse(MOUSE[ev], x, y, 0, None)
            else:
                self.sliders[act[1]][2](act[2])
        return 255 if key is None else ord(key)

    def destroyAllWindows(self):
        pass


def run_viewer(monkeypatch, module, driver, argv):
    """Run ``module.main(argv)`` under HighGUI(SCRIPT) and a Clock.
    Returns (the HighGUI, [per frame: camera position, yaw, pitch,
    settings, render size, stats list])."""
    gui, frames = HighGUI(SCRIPT), []
    render, config = driver.render, driver.config_from_settings

    def spy(scene, cam, settings, cfg):
        out = render(scene, cam, settings, cfg)
        vec = out["stats_vec"]
        vec = vec.cpu().numpy() if hasattr(vec, "cpu") else np.asarray(vec)
        frames.append({
            "position": np.array(cam.position), "yaw": cam.yaw,
            "pitch": cam.pitch,
            "settings": {k: np.array(v) for k, v in
                         dataclasses.asdict(settings).items()},
            "size": (cfg.width, cfg.height),
            "stats": [int(x) for x in vec]})
        return out

    def small(settings, width, height, **kw):
        return config(settings, width, height, **{**SMALL, **kw})

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", gui)
        m.setattr(module, "time", Clock())
        m.setattr(driver, "render", spy)
        m.setattr(driver, "config_from_settings", small)
        module.main(argv)
    return gui, frames
