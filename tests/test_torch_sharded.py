"""The port's sharded strips (vk_renderer_tpu_torch/parallel/sharded.py)
on the CPU, at tests/test_parallel.py's sizes: the cube at 256x128 and
the 12k-triangle sponza_like flagship config.

- ``_row_slice_matrix`` equals the JAX function bit for bit;
- skybox and gradient strips equal the JAX functions given the strip's
  offset (skybox rtol 1e-5 / atol 1e-6, tests/test_torch_shading.py's
  tolerance); the gradient strips equal the port's single-frame rows
  bit for bit and the JAX sharded frame's divide form within 1 ulp;
- the port's strips against the port's single frame, with
  test_parallel.py's checks: colour mismatch fraction (> 1e-3) under
  0.5%, depth within 2e-3, triangles in [ref, n * ref] (exactly n * ref
  with the camera inside the cube), overflow counters 0.  Depth is held
  on every pixel at n = 2 and 4; at n = 8 the strips change the visible
  triangle of the pixels the TPU kernel's own rounding changes
  (tests/test_torch_sharded_tpu_form.py), all on the cube's diagonal,
  and depth is held on every other pixel;
- a two-process gloo world equals the in-process strips bit for bit.

JAX is imported only by the tests that compare against it, so the gloo
world's processes start without it."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.ops import post
from vk_renderer_tpu_torch.ops import skybox as tsky
from vk_renderer_tpu_torch.ops.common import max_ulp
from vk_renderer_tpu_torch.parallel import sharded
from vk_renderer_tpu_torch.scene import procedural
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)


def small_cfg(**kw):
    """tests/test_parallel.py's small_cfg under the port's field names."""
    base = dict(width=256, height=128, tile_w=128, tile_h=32, cap_opaque=128,
                cap_masked=64, cap_transparent=64, shadow_size=256,
                shadow_cap=256)
    base.update(kw)
    return frame.FrameConfig(**base)


def _cube():
    return scene_to_torch(procedural.build_cube_scene().build(), "cpu")


def _check_strips(ref, out, n, ref_tid, tid):
    """test_parallel.py's bounds, with depth held within 2e-3 on every
    pixel whose visible triangle (``ref_tid`` / ``tid``, the dense
    G-buffer's) is the same in both frames.  Returns the pixels whose
    visible triangle differs, (y, x)."""
    c_ref, c_out = ref["color"].numpy(), out["color"].numpy()
    mismatch = (np.abs(c_ref - c_out) > 1e-3).mean()
    assert mismatch < 0.005, f"sharded mismatch fraction {mismatch}"
    diff = (ref_tid != tid).numpy()
    np.testing.assert_allclose(ref["depth"].numpy()[~diff],
                               out["depth"].numpy()[~diff], atol=2e-3)
    t_ref = int(ref["stats"]["triangles"])
    t_out = int(out["stats"]["triangles"])
    assert t_ref > 0 and t_ref <= t_out <= n * t_ref
    for k in ("bin_overflow", "peel_overflow", "sparse_overflow"):
        assert int(ref["stats"][k]) == 0 and int(out["stats"][k]) == 0, k
    assert out["color_u8"].shape == ref["color_u8"].shape
    return np.argwhere(diff)


def _edge_distance(host, viewproj, t, cx, cy, w, h):
    """Pixel distance, in f64, from (cx, cy) to the nearest edge of
    triangle ``t`` projected through ``viewproj`` onto a w x h frame."""
    v = np.asarray(host.tris)[t]
    hom = np.concatenate([np.asarray(host.positions, np.float64)[v],
                          np.ones((3, 1))], 1)
    world = np.asarray(host.obj_world, np.float64)[np.asarray(
        host.vert_obj)[v]]
    clip = np.einsum("ij,kj->ki", viewproj.double().numpy(),
                     np.einsum("kij,kj->ki", world, hom))
    xy = (clip[:, :2] / clip[:, 3:] + 1.0) * np.array([w / 2, h / 2])
    dist = []
    for i in range(3):
        (x0, y0), (x1, y1) = xy[i], xy[(i + 1) % 3]
        dist.append(abs((x1 - x0) * (cy - y0) - (y1 - y0) * (cx - x0))
                    / max(np.hypot(x1 - x0, y1 - y0), 1e-30))
    return min(dist)


def _render_with_tids(monkeypatch, fn, *args, **kw):
    """fn's frame and the visible-triangle ids of its dense G-buffer
    builds (one per view, in strip order), joined along rows."""
    tids = []
    real = frame._build_gbuffer

    def record(scene, sd, tid, *a, **k):
        if tid.dim() == 2:
            tids.append(tid)
        return real(scene, sd, tid, *a, **k)
    monkeypatch.setattr(frame, "_build_gbuffer", record)
    out = fn(*args, **kw)
    monkeypatch.undo()
    return out, torch.cat(tids, 0)


@pytest.mark.parametrize("y0,full_h,slice_h", [
    (0, 128, 64), (64, 128, 64), (96, 128, 32), (112, 128, 16),
    (270, 1080, 270), (810, 1080, 270), (1536, 2048, 512), (0, 1080, 1080)])
def test_row_slice_matrix_matches_jax(y0, full_h, slice_h):
    import jax.numpy as jnp
    from vk_renderer_tpu.parallel import sharded as jsharded
    rng = np.random.default_rng(y0 + full_h + slice_h)
    mat = rng.normal(size=(4, 4)).astype(np.float32)
    got = sharded._row_slice_matrix(torch.from_numpy(mat), y0, full_h,
                                    slice_h)
    want = jsharded._row_slice_matrix(jnp.asarray(mat), jnp.float32(y0),
                                      full_h, slice_h)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_skybox_and_gradient_strips_match_jax(n):
    """Each strip's skybox colours equal the JAX skybox_colors at the
    strip's y_offset; each gradient strip equals the port's single-frame
    rows bit for bit (``row0``), and the JAX sharded frame's divide form
    ``(y + y_offset) / full_height`` (vk_renderer_tpu/graph/frame.py
    compose) within 1 ulp: the port multiplies by f32(1 / full_height)."""
    import jax.numpy as jnp
    from vk_renderer_tpu.ops import skybox as jsky
    from vk_renderer_tpu.scene import procedural as jprocedural
    b = jprocedural.build_cube_scene()
    b.cubemap = jprocedural.make_sky_cubemap(16)
    host = b.build()
    jcube = host.device_put().cubemap
    tcube = scene_to_torch(host, "cpu").cubemap
    h, w = 128, 96
    sh = h // n
    cam = Camera(position=np.array([0.3, 0.2, 1.0], np.float32))
    cam.pitch = 0.4
    view = cam.view_matrix().astype(np.float32)
    proj = cam.projection_matrix(w / h).astype(np.float32)
    rng = np.random.default_rng(n)
    top, bottom = rng.uniform(0, 1, size=(2, 4)).astype(np.float32)
    whole = post.gradient(h, w, torch.from_numpy(top),
                          torch.from_numpy(bottom), extent_h=h)
    for i in range(n):
        y0 = i * sh
        got = tsky.skybox_colors(tcube, torch.from_numpy(view),
                                 torch.from_numpy(proj), sh, w, y0, h)
        want = jsky.skybox_colors(jcube, jnp.asarray(view), jnp.asarray(proj),
                                  sh, w, jnp.float32(y0), h)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        strip = post.gradient(sh, w, torch.from_numpy(top),
                              torch.from_numpy(bottom), extent_h=h, row0=y0)
        assert torch.equal(strip, whole[:, y0:y0 + sh])
        blend = ((jnp.arange(sh, dtype=jnp.float32) + jnp.float32(y0))
                 / h)[:, None]
        jax_bg = np.stack([np.broadcast_to(np.asarray(
            top[c] * (1.0 - blend) + bottom[c] * blend), (sh, w))
            for c in range(3)])
        assert max_ulp(strip, torch.from_numpy(jax_bg)) <= 1


def _cube_inputs():
    """The cube with shadows (mode 0) at 256x128."""
    scene = _cube()
    settings = RenderSettings(enable_shadows=True, shadow_mode=0)
    cfg = small_cfg(enable_shadows=True)
    sd, st = driver.frame_inputs(scene, Camera(), settings, cfg)
    return scene, sd, st, cfg


@pytest.mark.parametrize("n", [2, 4, 8])
def test_strips_match_the_single_frame(n, monkeypatch):
    scene, sd, st, cfg = _cube_inputs()
    ref, ref_tid = _render_with_tids(monkeypatch, frame.render_frame, scene,
                                     sd, st, cfg)
    out, tid = _render_with_tids(monkeypatch, sharded.render_frame_sharded,
                                 scene, sd, st, cfg, n=n)
    flips = _check_strips(ref, out, n, ref_tid, tid)
    # the cube face's two triangles share the edge on the frame's
    # diagonal X + Y = 192, which runs exactly through pixel centres:
    # there the TPU kernel's per-triangle tile-folded planes decide the
    # top-left rule by rounding (tests/test_torch_sharded_tpu_form.py),
    # so a strip may hand such a pixel to the other triangle of the face
    # (the same plane) or, at n = 8, to neither
    assert all(x + y == 191 for y, x in flips), flips
    holes = (ref["depth"] < 1.0) != (out["depth"] < 1.0)
    if n < 8:
        # every pixel, as tests/test_parallel.py holds the JAX frame
        assert not bool(holes.any())
        np.testing.assert_allclose(ref["depth"].numpy(),
                                   out["depth"].numpy(), atol=2e-3)
    else:
        assert 0 < int(holes.sum()) <= 8
    # background rows no triangle covers are the single frame's bit for
    # bit: the gradient's row offset
    empty = (ref["depth"] >= 1.0).all(1) & (out["depth"] >= 1.0).all(1)
    assert bool(empty.any())
    assert torch.equal(out["color"][:, empty], ref["color"][:, empty])


@pytest.mark.parametrize("n", [2, 8])
def test_strip_stats_exact_with_the_camera_inside_the_cube(n):
    """Inside the cube's bounding sphere every strip's frustum keeps the
    object, so the summed stats are n times the single frame's."""
    scene = _cube()
    cam = Camera(position=np.array([0.0, 0.0, -5.0], np.float32))
    settings = RenderSettings()
    cfg = small_cfg()
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    ref = frame.render_frame(scene, sd, st, cfg)
    out = sharded.render_frame_sharded(scene, sd, st, cfg, n=n)
    t_ref = int(ref["stats"]["triangles"])
    assert t_ref > 0
    assert int(out["stats"]["triangles"]) == n * t_ref
    assert int(out["stats"]["drawcalls"]) == n * int(
        ref["stats"]["drawcalls"])


def test_strip_heights_must_divide():
    scene = _cube()
    cfg = small_cfg(height=120)
    sd, st = driver.frame_inputs(scene, Camera(), RenderSettings(), cfg)
    with pytest.raises(AssertionError, match="height"):
        sharded.render_frame_sharded(scene, sd, st, cfg, n=16)


def _gloo_inputs():
    scene = _cube()
    settings = RenderSettings(enable_shadows=True, shadow_mode=0)
    cfg = small_cfg(enable_shadows=True)
    sd, st = driver.frame_inputs(scene, Camera(), settings, cfg)
    return scene, sd, st, cfg


def _gloo_rank(rank, store_path, out_dir):
    """One rank of a two-process gloo world: renders its strip through
    render_frame_sharded(group=...) and saves the assembled frame."""
    import datetime
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = sharded.render_frame_sharded(*_gloo_inputs(),
                                           group=dist.group.WORLD)
        torch.save({k: out[k] for k in ("color", "depth", "color_u8",
                                        "stats_vec")},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gloo_world_equals_the_in_process_strips(tmp_path):
    """Two processes, one strip each, joined by all_gather / all_reduce
    over gloo: every rank returns the in-process n = 2 frame bit for bit
    (colour and depth as int32 bits, the u8 image, the summed stats)."""
    mp.spawn(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path)),
             nprocs=2, join=True)
    want = sharded.render_frame_sharded(*_gloo_inputs(), n=2)
    for rank in (0, 1):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        for k in ("color", "depth"):
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32)), (rank, k)
        assert torch.equal(got["color_u8"], want["color_u8"])
        assert torch.equal(got["stats_vec"], want["stats_vec"])


def test_flagship_config_strips_match_the_single_frame(monkeypatch):
    """tests/test_parallel.py's flagship parity config: CSM (4 cascades,
    mode 3), the classifier (tables built after the gather), masked
    foliage and additive transparent buckets, skybox and tonemap, on the
    12k-triangle sponza_like scene, as 8 strips."""
    host = procedural.build_sponza_like(target_tris=12_000).build()
    scene = scene_to_torch(host, "cpu")
    assert scene.n_masked > 0 and scene.n_transparent > 0
    cam = Camera(position=np.array([9.0, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = small_cfg(enable_shadows=True, shadow_cap=65536, cap_opaque=65536,
                    cap_masked=32768, cap_transparent=8192, rec_opaque=4096,
                    rec_masked=2048, rec_transparent=1024, rec_shadow=4096,
                    masked_peels=8, masked_tail_rounds=1,
                    masked_tail_peels=2, shadow_cascades=4)
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)
    ref, ref_tid = _render_with_tids(monkeypatch, frame.render_frame, scene,
                                     sd, st, cfg)
    out, tid = _render_with_tids(monkeypatch, sharded.render_frame_sharded,
                                 scene, sd, st, cfg, n=8)
    flips = _check_strips(ref, out, 8, ref_tid, tid)
    # pixels with another visible triangle: at most 0.05% of the frame,
    # each on an edge through its centre (knife edges, as on the cube)
    assert len(flips) <= 5e-4 * cfg.width * cfg.height
    for y, x in flips:
        tris = [int(t) for t in (ref_tid[y, x], tid[y, x]) if t >= 0]
        assert min(_edge_distance(host, sd["viewproj"], t, x + 0.5, y + 0.5,
                                  cfg.width, cfg.height)
                   for t in tris) < 1e-3, (y, x)
