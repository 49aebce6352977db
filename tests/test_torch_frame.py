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

import torch_threads  # noqa: F401  (bounds torch's threads)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
PORTED = ("cube_flat_bg", "cube_pbr_sky_tonemap", "cube_csm",
          "sponza_like_flagship", "gltf_fixture")


def _golden_configs():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_goldens import golden_configs
    return {e[0]: e for e in golden_configs()}


def port_config(cfg):
    """The JAX FrameConfig's semantic fields under the port's names (the
    port's own fields, such as ``shadow_traced_windows``, keep their
    defaults)."""
    names = {f.name for f in dataclasses.fields(frame.FrameConfig)}
    return frame.FrameConfig(**{n: getattr(cfg, n) for n in names
                                if hasattr(cfg, n)})


def port_settings(settings):
    return RenderSettings(**{f.name: getattr(settings, f.name)
                             for f in dataclasses.fields(RenderSettings)})


def golden_camera(builder):
    """make_goldens.render_config's camera: the sponza builders look down
    the hall from eye level, every other scene from the origin."""
    cam = Camera()
    if "sponza" in getattr(builder, "__name__", ""):
        cam.position = np.array([9.0, 1.8, 0.3], np.float32)
        cam.yaw = float(np.pi / 2)
    return cam


def _render(name):
    _, builder, settings, cfg = _golden_configs()[name]
    scene = scene_to_torch(builder().build(), "cpu")
    return driver.render(scene, golden_camera(builder),
                         port_settings(settings), port_config(cfg))


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


def test_transparent_cube_matches_jax_frame(monkeypatch):
    """The cube with its last two triangles (the -y face) made additive
    transparent, seen from below at 100x70 so the face fills most of the
    frame and its layer also covers tile padding (columns past 100, rows
    past 70 — the pass must crop them), through the port and through the
    JAX package's render_frame: equal stats, u8 frames >= 40 dB, float
    colours within 1e-4 (the tonemap forms differ by up to ~4e-5)
    wherever the depths agree to 1e-6."""
    from vk_renderer_tpu.graph import driver as jdriver
    from vk_renderer_tpu.graph import frame as jframe
    from vk_renderer_tpu.graph.frame import FrameConfig as JaxConfig
    from vk_renderer_tpu.graph.scenedata import (
        RenderSettings as JaxSettings)
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu_torch.ops import raster_kernels as rk
    from vk_renderer_tpu_torch.ops.common import from_tiles
    host = procedural.build_cube_scene().build()
    host.n_opaque -= 2
    host.n_transparent = 2
    cam = Camera(position=np.array([0.1, -2.2, -4.6], np.float32))
    cam.pitch = 1.3
    settings = JaxSettings(enable_postprocess=True, enable_background=True)
    jcfg = JaxConfig(width=100, height=70)
    jout = jframe.render_frame(
        host.device_put(), jdriver.scene_data_pytree(cam, settings, jcfg),
        jdriver.make_settings_pytree(settings), jcfg)
    layers = []
    real = rk.rasterize_layers_grid

    def spy(*args, **kw):
        out = real(*args, **kw)
        layers.append(out[1][0])
        return out

    monkeypatch.setattr(rk, "rasterize_layers_grid", spy)
    out = driver.render(scene_to_torch(host, "cpu"), cam,
                        port_settings(settings), port_config(jcfg))
    layer0 = from_tiles(layers[-1], 3, 1) != host.tris.shape[0]
    assert int(layer0[:70, :100].sum()) > 0
    assert int(layer0.sum() - layer0[:70, :100].sum()) > 0   # padding
    stats = frame.stats_from_vec(out["stats_vec"])
    assert stats == jframe.stats_from_vec(jout["stats_vec"])
    assert stats["peel_overflow"] == 0 and stats["bin_overflow"] == 0
    p = psnr(out["color_u8"].numpy().astype(np.float32) / 255.0,
             np.asarray(jout["color_u8"]).astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB"
    same = np.abs(out["depth"].numpy() - np.asarray(jout["depth"])) <= 1e-6
    diff = np.abs(out["color"].numpy() - np.asarray(jout["color"]))[:, same]
    assert diff.max() <= 1e-4, float(diff.max())


def test_headless_cli_renders_on_the_cpu_when_asked(tmp_path, capsys):
    """The port's headless CLI: --device cpu renders the procedural cube
    (flat shading, gradient background), prints one JSON stats line per
    frame and an average line, writes the PNGs and returns 0."""
    import json
    from vk_renderer_tpu_torch.app import headless
    out_dir = tmp_path / "frames"
    rc = headless.main(["--scene", "cube", "--flat", "--background",
                        "--frames", "2", "--width", "64", "--height", "32",
                        "--device", "cpu", "--out", str(out_dir)])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["frame"] for ln in lines[:-1]] == [0, 1]
    assert all(ln["bin_overflow"] == 0 and ln["peel_overflow"] == 0
               for ln in lines[:-1])
    assert lines[-1]["device"] == "cpu" and "avg_frametime_ms" in lines[-1]
    assert sorted(os.listdir(out_dir)) == ["frame_0000.png",
                                           "frame_0001.png"]


def test_headless_cli_refuses_a_missing_cuda_device(monkeypatch, capsys):
    """The default device is cuda, with no silent fallback to the CPU."""
    import torch
    from vk_renderer_tpu_torch.app import headless
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert headless.main(["--scene", "cube", "--frames", "1"]) != 0
    assert "--device cpu" in capsys.readouterr().err
