"""The port's additive transparent pass against the JAX package's frame.

The scene, settings, camera and config are tests/test_frame_oracle.py's
(textured ground, two boxes, an alpha-masked foliage quad and an additive
pane facing the camera; skybox, gradient background, tonemap) with its
shadow mode 0 (hard shadows, one cascade: the cheapest of its configs to
compile), rendered at 96x72 — 72 rows is not a multiple of the 32-row
tile, so the last tile row holds padding rows that the transparent layers
must not shade or count (tests/test_torch_frame.py's transparent cube
puts a transparent layer into the padding itself).  The frame goes through the port (CPU, the
kernels' plain versions) and through vk_renderer_tpu.graph.frame.
render_frame.  Gates: equal stats; the u8 frames >= 40 dB; the float
colours within 1e-4 wherever the two depths agree to 1e-6 (the port's
tonemap is the exp/log form, the JAX frame's the pow form — they differ
by up to ~4e-5 — and the Pallas interpret raster contracts its plane
evaluation into FMAs, a few ulp of depth); and transparent layer 0 covers
pixels."""

import numpy as np
import pytest

from vk_renderer_tpu.graph import driver as jdriver
from vk_renderer_tpu.graph import frame as jframe
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.ops import raster_kernels as rk
from vk_renderer_tpu_torch.ops.common import cdiv, from_tiles
from vk_renderer_tpu_torch.scene.types import scene_to_torch
from vk_renderer_tpu_torch.utils.image import psnr

import torch_threads  # noqa: F401  (bounds torch's threads)
import test_frame_oracle as tfo
from test_torch_frame import port_config

W, H = 96, 72
MODE = 0            # hard shadows: one rastered cascade


def _jax_config(settings):
    return jdriver.config_from_settings(
        settings, W, H, shadow_size=tfo.SHADOW, shadow_cascades=1,
        cap_opaque=256, cap_masked=64, cap_transparent=64, rec_opaque=512,
        rec_masked=128, rec_transparent=128, rec_shadow=512,
        shadow_cap=512, big_cap=128, shadow_big_cap=128,
        masked_peels=4, transparent_peels=2, packed_rows=True,
        masked_tail_rounds=1, masked_tail_peels=2)


@pytest.fixture(scope="module")
def frames():
    """(JAX output, port output, port layer-0 coverage, port config)."""
    host = tfo._scene_builder().build()
    assert host.n_transparent > 0
    settings = tfo._settings(MODE)
    cam = tfo._camera()
    jcfg = _jax_config(settings)
    jout = jframe.render_frame(
        host.device_put(), jdriver.scene_data_pytree(cam, settings, jcfg),
        jdriver.make_settings_pytree(settings), jcfg)
    jout = {k: np.asarray(jout[k]) for k in ("color", "depth", "stats_vec",
                                             "color_u8")}

    cfg = port_config(jcfg)
    calls = []
    real = rk.rasterize_layers_grid

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args[6], out))
        return out

    rk.rasterize_layers_grid = spy
    try:
        tout = driver.render(scene_to_torch(host, "cpu"), cam, settings, cfg)
    finally:
        rk.rasterize_layers_grid = real
    # the transparent pass is the frame's last k-buffer pass
    k_layers, (_, ids) = calls[-1]
    assert k_layers == cfg.transparent_peels + 1
    layer0 = from_tiles(ids[0], cdiv(H, cfg.tile_h), cdiv(W, cfg.tile_w))
    cover0 = int((layer0[:H, :W] != host.tris.shape[0]).sum())
    return jout, tout, cover0, cfg


def test_transparent_frame_stats_match_jax(frames):
    jout, tout, _, _ = frames
    got = frame.stats_from_vec(tout["stats_vec"])
    want = jframe.stats_from_vec(jout["stats_vec"])
    assert got == want
    for key in ("bin_overflow", "peel_overflow", "sparse_overflow"):
        assert got[key] == 0, key


def test_transparent_layer0_covers_pixels(frames):
    _, _, cover0, _ = frames
    assert cover0 > 0


def test_transparent_frame_matches_jax(frames):
    jout, tout, _, _ = frames
    got_u8 = tout["color_u8"].numpy()
    assert got_u8.shape == (H, W, 3)
    p = psnr(got_u8.astype(np.float32) / 255.0,
             jout["color_u8"].astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB"
    same = np.abs(tout["depth"].numpy() - jout["depth"]) <= 1e-6
    assert same.mean() > 0.99
    diff = np.abs(tout["color"].numpy() - jout["color"])[:, same]
    assert diff.max() <= 1e-4, float(diff.max())

