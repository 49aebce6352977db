"""The port's sponza_like goldens that the CPU test budget held back
until the frame's CPU depth raster culled its records: one per shadow
filter mode (Hard, PCF, PCSS: one rastered cascade), the 512x512
flagship, and the flagship with the nearest-mip knob against the JAX
package's render_frame.

Each golden frame must reach PSNR >= 40 dB against the checked-in
golden with zero bin / peel / sparse overflow (tests/test_goldens.py's
gate; the configs are tools/make_goldens.py's).  In a file of its own so
that ``--dist loadfile`` can give it another worker than
tests/test_torch_frame.py."""

import dataclasses
import os

import numpy as np
import pytest

from vk_renderer_tpu.utils.image import load_png
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.scene.types import scene_to_torch
from vk_renderer_tpu_torch.utils.image import psnr

import torch_threads  # noqa: F401  (bounds torch's threads)
from test_torch_frame import (GOLDEN_DIR, _golden_configs, golden_camera,
                              port_config, port_settings)


def _zero_overflow(name, stats):
    for key in ("bin_overflow", "peel_overflow", "sparse_overflow"):
        assert stats[key] == 0, f"{name}: {key} = {stats[key]}"


@pytest.mark.parametrize("name", ["sponza_like_hard", "sponza_like_pcf",
                                  "sponza_like_pcss",
                                  "sponza_like_flagship_512"])
def test_port_sponza_golden(name):
    _, builder, settings, cfg = _golden_configs()[name]
    scene = scene_to_torch(builder().build(), "cpu")
    out = driver.render(scene, golden_camera(builder),
                        port_settings(settings), port_config(cfg))
    _zero_overflow(name, frame.stats_from_vec(out["stats_vec"]))
    got = out["color_u8"].numpy()
    assert got.shape == (cfg.height, cfg.width, 3)
    want = load_png(os.path.join(GOLDEN_DIR, f"{name}.png"))[..., :3]
    p = psnr(got.astype(np.float32) / 255.0, want.astype(np.float32) / 255.0)
    assert p >= 40.0, f"{name}: PSNR {p:.1f} dB < 40 dB vs golden"


def test_port_flagship_nearest_mip_matches_jax_frame():
    """The flagship golden's config with ``mr_nearest_mip`` (the
    metallic-roughness texture at one bilinear tap of the nearest mip)
    through the port and the JAX package's render_frame: equal stats,
    PSNR >= 40 dB, and a frame that differs from the knob-off one."""
    from vk_renderer_tpu.graph import driver as jdriver
    from vk_renderer_tpu.graph import frame as jframe
    _, builder, settings, cfg = _golden_configs()["sponza_like_flagship"]
    jcfg = dataclasses.replace(cfg, mr_nearest_mip=True)
    host = builder().build()
    cam = golden_camera(builder)
    jout = jframe.render_frame(
        host.device_put(), jdriver.scene_data_pytree(cam, settings, jcfg),
        jdriver.make_settings_pytree(settings), jcfg)
    out = driver.render(scene_to_torch(host, "cpu"), cam,
                        port_settings(settings), port_config(jcfg))
    stats = frame.stats_from_vec(out["stats_vec"])
    _zero_overflow("nearest_mip", stats)
    assert stats == jframe.stats_from_vec(jout["stats_vec"])
    got = out["color_u8"].numpy().astype(np.float32) / 255.0
    p = psnr(got, np.asarray(jout["color_u8"]).astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB vs the JAX frame"
    golden = load_png(os.path.join(GOLDEN_DIR, "sponza_like_flagship.png"))
    assert not np.array_equal(out["color_u8"].numpy(), golden[..., :3])
