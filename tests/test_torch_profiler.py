"""The port's per-pass profiler on the CPU at 64x32: the JAX profiler's
stage names in the frame's order, each a finite positive time, and the
text table.  The stages are read from the frame's own spans over whole
frames; a stage the scene does not run is left out.  Imports no JAX."""

import math
import os

import numpy as np
import pytest

from vk_renderer_tpu_torch.graph import driver, profiler
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.scene import procedural
from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)

STAGES = ("shadow", "setup", "bin", "records", "raster_opaque", "masked",
          "masked_kraster0", "gbuffer", "shade", "compose", "transparent",
          "tonemap", "full_frame")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "textured_box", "scene.gltf")


def _cube():
    """The cube with its -y face made additive transparent, seen from
    below (tests/test_torch_frame.py's transparent cube)."""
    host = procedural.build_cube_scene().build()
    host.n_opaque -= 2
    host.n_transparent = 2
    cam = Camera(position=np.array([0.1, -2.2, -4.6], np.float32))
    cam.pitch = 1.3
    return host, cam


def _fixture():
    """The glTF fixture: a MASK material, so the masked stages run."""
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(16)
    return b.build(), Camera()


@pytest.mark.parametrize("name,make,skipped", [
    ("cube", _cube, {"masked_kraster0", "masked"}),
    ("fixture", _fixture, {"transparent"})], ids=["cube", "fixture"])
def test_profile_passes_stage_order(name, make, skipped, capsys):
    host, cam = make()
    scene = scene_to_torch(host, "cpu")
    assert scene.cubemap is not None
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = driver.config_from_settings(settings, 64, 32, shadow_size=64)
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    timings = profiler.profile_passes(scene, sd, st, cfg, iters=1)
    assert tuple(timings) == tuple(s for s in STAGES if s not in skipped)
    assert all(math.isfinite(v) and v > 0 for v in timings.values())
    assert math.isfinite(timings.unprofiled_ms) and timings.unprofiled_ms > 0
    table = profiler.format_table(timings)
    print(table)
    lines = capsys.readouterr().out.splitlines()
    for stage in timings:
        assert any(ln.split()[:1] == [stage] for ln in lines), stage
    assert any(ln.split()[:2] == ["stage", "sum"] for ln in lines)
    assert any(ln.split()[:1] == ["unprofiled"] for ln in lines)


def test_profile_passes_without_shadows():
    """Shadows compiled out: no shadow stage, the shade stage still runs
    (over the 1x1 placeholder maps)."""
    host, cam = _cube()
    scene = scene_to_torch(host, "cpu")
    settings = RenderSettings(enable_postprocess=True)
    cfg = driver.config_from_settings(settings, 64, 32)
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    timings = profiler.profile_passes(scene, sd, st, cfg, iters=1)
    assert tuple(timings) == tuple(
        s for s in STAGES if s not in {"masked_kraster0", "masked", "shadow"})
