"""The port's whole frame on the CPU against the JAX package's goldens.

The configs are tools/make_goldens.py's, mapped onto the port's
FrameConfig by field name; scenes are built with the JAX package's
builders and carried across with scene_to_torch.  Each frame must reach
PSNR >= 40 dB against the checked-in golden with zero bin / peel / sparse
overflow (tests/test_goldens.py's gate).  No JAX frame is compiled."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from vk_renderer_tpu.utils.image import load_png
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch
from vk_renderer_tpu_torch.utils.image import psnr

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
PORTED = ("cube_pbr_sky_tonemap", "cube_csm", "gltf_fixture")


def _golden_configs():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_goldens import golden_configs
    return {e[0]: e for e in golden_configs()}


def port_config(cfg):
    """The JAX FrameConfig's semantic fields under the port's names."""
    names = {f.name for f in dataclasses.fields(frame.FrameConfig)}
    return frame.FrameConfig(**{n: getattr(cfg, n) for n in names})


def port_settings(settings):
    return RenderSettings(**{f.name: getattr(settings, f.name)
                             for f in dataclasses.fields(RenderSettings)})


def _render(name):
    _, builder, settings, cfg = _golden_configs()[name]
    scene = scene_to_torch(builder().build(), "cpu")
    return driver.render(scene, Camera(), port_settings(settings),
                         port_config(cfg))


@pytest.mark.parametrize("name", PORTED)
def test_port_frame_matches_golden(name):
    out = _render(name)
    stats = frame.stats_from_vec(out["stats_vec"])
    for key in ("bin_overflow", "peel_overflow", "sparse_overflow"):
        assert stats[key] == 0, f"{name}: {key} = {stats[key]}"
    got = out["color_u8"].numpy()
    assert got.shape == (128, 256, 3)
    want = load_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[..., :3]
    p = psnr(got.astype(np.float32) / 255.0, want.astype(np.float32) / 255.0)
    assert p >= 40.0, f"{name}: PSNR {p:.1f} dB < 40 dB vs golden"


def test_masked_pass_runs_continuation_rounds(monkeypatch):
    """The fixture's MASK material goes through the k-buffer: round 0,
    then tail rounds while pixels stay pending.  With one peel per round
    the frame must need the tail rounds, and still match the full-depth
    frame exactly."""
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    _, builder, settings, cfg = _golden_configs()["gltf_fixture"]
    scene = scene_to_torch(builder().build(), "cpu")
    calls = []
    real = rk.rasterize_layers_grid

    def spy(*args, **kw):
        calls.append(args[6])                 # k_layers
        return real(*args, **kw)

    monkeypatch.setattr(rk, "rasterize_layers_grid", spy)
    pcfg = port_config(cfg)
    full = driver.render(scene, Camera(), port_settings(settings), pcfg)
    shallow = dataclasses.replace(pcfg, masked_peels=1,
                                  masked_tail_rounds=8, masked_tail_peels=1)
    calls.clear()
    out = driver.render(scene, Camera(), port_settings(settings), shallow)
    assert len(calls) > 1 and calls[0] == 1
    assert frame.stats_from_vec(out["stats_vec"])["peel_overflow"] == 0
    np.testing.assert_array_equal(out["color_u8"].numpy(),
                                  full["color_u8"].numpy())


def test_transparent_scene_raises():
    from vk_renderer_tpu.scene import procedural
    host = procedural.build_cube_scene().build()
    host.n_opaque -= 2
    host.n_transparent = 2
    scene = scene_to_torch(host, "cpu")
    cfg = frame.FrameConfig(width=128, height=64)
    with pytest.raises(NotImplementedError, match="transparent"):
        driver.render(scene, Camera(), RenderSettings(), cfg)
