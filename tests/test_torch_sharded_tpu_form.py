"""Why strips may change the visible triangle of knife-edge pixels.

tests/test_parallel.py holds every pixel of the JAX package's 8-strip
cube frame within 2e-3 of its single frame.  That test runs the JAX
frame's XLA reference raster (vk_renderer_tpu/ops/raster.py
``rasterize_depth``), which evaluates each edge at (pixel - anchor) over
the whole frame.  The TPU path evaluates the tile-folded planes of its
records instead (raster_pallas.py ``build_records``: k = c + a (tx0 - ax)
+ b (ty0 - ay), then a * x + b * y + k per pixel), and the port's kernels
and plain versions follow that form bit for bit.  On the cube the two
triangles of a face share an edge on the frame's diagonal X + Y = 192,
which runs exactly through pixel centres; each triangle's planes are
anchored and normalised on their own, so there the top-left rule is
decided by rounding, and a strip's row-remapped projection can hand such
a pixel to the other triangle of the face, or to neither.

Here the JAX package's own TPU path (its setup, packed binning,
``build_records`` and the Pallas depth kernel in interpret mode) renders
the cube's camera depth as one frame and as 8 strips:

- it, too, leaves pixels of that diagonal uncovered in the strips;
- the port's plain depth walk on the same JAX records leaves exactly the
  pixels uncovered that the port's own 8-strip frame does;
- the interpreter's ids differ from the port walk's only on that
  diagonal: its XLA CPU program contracts the plane evaluation into
  FMAs (tests/test_torch_raster.py), which moves which of those pixels
  round the other way."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_renderer_tpu.ops import binning as jbin
from vk_renderer_tpu.ops import raster as jraster
from vk_renderer_tpu.ops import raster_pallas as jpallas
from vk_renderer_tpu.ops import setup as jsetup
from vk_renderer_tpu.parallel import sharded as jsharded
from vk_renderer_tpu.scene import procedural as jprocedural
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.ops import raster_kernels as rk
from vk_renderer_tpu_torch.parallel import sharded
from vk_renderer_tpu_torch.scene import procedural
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)

W, H, N = 256, 128, 8
TW, TH = 128, 32


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Interpret-mode pallas executables embed host callbacks that the
    persistent compilation cache cannot (de)serialize (see
    tests/test_raster_pallas.py)."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    jax.clear_caches()


def _interpret(fn, *args, **kw):
    from jax.experimental import pallas as pl
    real_call = pl.pallas_call

    def fake_call(*a, **k):
        k["interpret"] = True
        return real_call(*a, **k)

    with mock.patch.object(jpallas.pl, "pallas_call", fake_call):
        return fn(*args, **kw)


def _tpu_form_view(scene, viewproj, h):
    """The JAX TPU path's camera depth raster of one h-row view: (the
    Pallas kernel's depth and ids, the port's plain walk's on the same
    records)."""
    _, clip = jsetup.transform_vertices(scene.positions, scene.vert_obj,
                                        scene.obj_world, viewproj)
    n_tris = scene.tris[0].shape[0]
    st = jsetup.triangle_setup(clip, scene.tris, jnp.ones(n_tris, bool), W,
                               h, cull=jsetup.CULL_BACK)
    (plan,) = jbin.bin_buckets_packed(
        st["bbox"], st["valid"], ((0, n_tris),), W, h, tile_w=TW, tile_h=TH,
        caps=(128,), rec_caps=(4096,), max_span=16, big_cap=512,
        edge=st["edge"], anchor=st["anchor"])
    assert int(plan["overflow"]) == 0
    rec = jpallas.build_records(jraster.pad_setup(st), st["bbox"],
                                plan["rec_tri"], plan["rec_tile"], W // TW,
                                TW, TH)
    jd, ji = _interpret(jpallas.rasterize_depth_packed, rec,
                        plan["rec_start"], plan["counts"], W, h, n_tris,
                        tile_w=TW, tile_h=TH)
    td, ti = rk.rasterize_depth_packed(
        torch.from_numpy(np.array(rec)),
        torch.from_numpy(np.array(plan["rec_start"])),
        torch.from_numpy(np.array(plan["counts"])), W, h, n_tris,
        tile_w=TW, tile_h=TH)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def _holes(single, strips):
    d1 = single[0]
    d = np.concatenate([s[0] for s in strips])
    return {(int(y), int(x)) for y, x in np.argwhere((d1 < 1.0) != (d < 1.0))}


def test_knife_edge_flips_are_the_tpu_kernels_own():
    scene = jprocedural.build_cube_scene().build().device_put()
    tscene = scene_to_torch(procedural.build_cube_scene().build(), "cpu")
    settings = RenderSettings(enable_shadows=True, shadow_mode=0)
    # tests/test_parallel.py's small_cfg
    cfg = frame.FrameConfig(width=W, height=H, tile_w=TW, tile_h=TH,
                            cap_opaque=128, cap_masked=64,
                            cap_transparent=64, shadow_size=256,
                            shadow_cap=256, enable_shadows=True)
    sd, st = driver.frame_inputs(tscene, Camera(), settings, cfg)
    vp = jnp.asarray(sd["viewproj"].numpy())
    sh = H // N
    single = _tpu_form_view(scene, vp, H)
    strips = [_tpu_form_view(scene, jsharded._row_slice_matrix(
        vp, jnp.float32(i * sh), H, sh), sh) for i in range(N)]
    on_diagonal = {(y, x) for y in range(H) for x in range(W)
                   if x + y == 191}

    # the JAX TPU path's own strips open holes on the diagonal
    jax_holes = _holes(single[0], [s[0] for s in strips])
    assert jax_holes and jax_holes <= on_diagonal, jax_holes

    # the port's walk on the JAX records opens the port frame's holes
    walk_holes = _holes(single[1], [s[1] for s in strips])
    ref = frame.render_frame(tscene, sd, st, cfg)
    out = sharded.render_frame_sharded(tscene, sd, st, cfg, n=N)
    port_holes = {(int(y), int(x)) for y, x in np.argwhere(
        ((ref["depth"] < 1.0) != (out["depth"] < 1.0)).numpy())}
    assert walk_holes == port_holes and len(port_holes) == len(jax_holes)

    # interpreter and walk agree on the single frame, and on the strips
    # off the diagonal
    np.testing.assert_array_equal(single[0][1], single[1][1])
    j_ids = np.concatenate([s[0][1] for s in strips])
    t_ids = np.concatenate([s[1][1] for s in strips])
    diff = {(int(y), int(x)) for y, x in np.argwhere(j_ids != t_ids)}
    assert diff <= on_diagonal, diff
