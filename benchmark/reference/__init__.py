"""The benchmark's plain reference of one frame.

A frozen copy of the renderer's plain path in plain PyTorch and NumPy:
glTF and KTX loading, the texture heap, the per-frame scene data, the
frame graph and every raster and post pass in its plain form.  It imports
nothing of the program under test and takes nothing it made: it loads the
scene files itself, builds its own heap and scene tensors, and works each
frame out again from the camera pose and settings the benchmark hands to
both sides.

``load_scene`` -> device scene; ``render`` -> one frame's dict (colour,
visibility after the masked pass, shadow maps, stats).
"""

from __future__ import annotations

import numpy as np

from .graph import driver
from .graph.frame import FrameConfig, render_frame
from .graph.scenedata import RenderSettings
from .scene.camera import Camera

__all__ = ["Camera", "FrameConfig", "RenderSettings", "load_scene",
           "render"]


def load_scene(gltf_path: str, cubemap_path: str, device):
    """The glTF scene with its KTX skybox as device tensors."""
    from .scene.assembly import SceneBuilder
    from .scene.ktx import load_cubemap
    from .scene.types import scene_to_torch
    b = SceneBuilder()
    b.load_gltf(gltf_path, "scene")
    b.cubemap = load_cubemap(cubemap_path)
    return scene_to_torch(b.build(), device)


def camera(position, yaw: float, pitch: float = 0.0) -> Camera:
    return Camera(position=np.asarray(position, np.float32), yaw=float(yaw),
                  pitch=float(pitch))


def render(scene, cam: Camera, settings: RenderSettings,
           cfg: FrameConfig) -> dict:
    """One frame: render_frame's dict, with ``tid`` and ``shadow_maps``."""
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    return render_frame(scene, sd, st, cfg)
