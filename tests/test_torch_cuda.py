"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the raster kernels bit for bit (depths and ids), the post kernels
within 2 ulp (the tonemap's logf / expf are CUDA's; the gradient is
bit-exact), the masked pass's resolve bit for bit (its state, the probe
and the tested-pixel counts; synthetic rounds, and the pass on the
Sponza replica at 1080p).  Also the shadow classifier (PyTorch ops, no kernel of its
own) on the card: its masks equal the CPU's and its factor the dense
filter's, bit for bit.

The plain versions are held against the JAX package's Pallas kernels on
the CPU (tests/test_torch_raster.py); this file closes the chain on the
GPU.  It imports no JAX, so it runs on a machine without it; there the
suite's conftest (which imports JAX) is left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a CUDA device every test skips."""

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch.ops import binning, masked, post, raster, shade
from vk_renderer_tpu_torch.ops import texture as tex
from vk_renderer_tpu_torch.ops import raster_kernels as rk
from vk_renderer_tpu_torch.ops import setup
from vk_renderer_tpu_torch.ops.common import max_ulp

import masked_cases as mc
import torch_threads  # noqa: F401  (bounds torch's threads)
from raster_streams import (COLS, H, N_TILES, R, SENT, TH, TW, W,
                            clip_scene, heavy_stream, pad_records,
                            synthetic_stream, whole_and_tiny_stream)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _scene_stream():
    """Records of a random 40-triangle scene (some w-crossing) over the
    2 x 2 tile grid, built by the port's own setup, binning and records
    (each held exactly against the JAX package on the CPU)."""
    clip, tris = clip_scene(7, 40, w_cross=3)
    st = setup.triangle_setup(
        tuple(torch.from_numpy(clip[:, c]) for c in range(4)),
        tuple(torch.from_numpy(tris[:, c]) for c in range(3)),
        torch.ones(40, dtype=torch.bool), W, H, cull=setup.CULL_NONE)
    (plan,) = binning.bin_buckets_packed(
        st["bbox"], st["valid"], ((0, 40),), W, H, tile_w=TW, tile_h=TH,
        caps=(64,), rec_caps=(R,), max_span=4, big_cap=8, edge=st["edge"],
        anchor=st["anchor"])
    assert int(plan["overflow"]) == 0
    rec = rk.build_records(raster.pad_setup(st), st["bbox"], plan["rec_tri"],
                           plan["rec_tile"], COLS, TW, TH)
    return (pad_records(rec.numpy()), plan["rec_start"].numpy(),
            plan["counts"].reshape(-1).numpy())


STREAMS = {
    "scene": _scene_stream,
    "synthetic": synthetic_stream,
    # one tile of 3,100 records (ties on chunk and segment boundaries,
    # -0.0 against +0.0), two light tiles and an empty one
    "heavy": lambda: heavy_stream(11, TH),
    # whole-tile records (nothing culled) among tiny ones (nearly all)
    "whole_and_tiny": lambda: whole_and_tiny_stream(12, TH),
}


def _to(dev, stream):
    return [torch.from_numpy(np.asarray(x)).to(dev) for x in stream]


@pytest.fixture(params=list(STREAMS))
def stream(request, dev):
    return _to(dev, STREAMS[request.param]())


def _tile_planes(dev, seed, values):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(np.asarray(values, np.float32),
                                       size=(N_TILES, TH, TW))).to(dev)


def _same(kernel_out, plain_out):
    """Ids equal, and depths equal bit for bit (as int32, so that -0.0
    and +0.0 differ)."""
    (kd, ki), (pd, pi) = kernel_out, plain_out
    torch.cuda.synchronize()
    assert torch.equal(ki, pi), f"{int((ki != pi).sum())} ids differ"
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32)), \
        float((kd - pd).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("peel", [False, True], ids=["init", "floor"])
def test_depth_kernel_matches_plain(stream, dev, peel):
    """A partly seeded z-buffer (init depth and id), and a strict peel
    floor (z > floor, with 2.0 blanking a pixel)."""
    init_d = _tile_planes(dev, 1, [1.0, 1.0, 0.35])
    init_i = torch.where(init_d < 1.0, 59, SENT).to(torch.int32)
    floor = _tile_planes(dev, 2, [-1.0, 0.15, 0.3, 2.0]) if peel else None
    before = rk.rasterize_depth_grid.launches
    args = (*stream, init_d, init_i, floor)
    _same(rk.rasterize_depth_grid(*args, tile_h=TH),
          rk.rasterize_depth_grid_plain(*args, tile_h=TH))
    assert rk.rasterize_depth_grid.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["scene", "heavy", "whole_and_tiny"])
def test_depth_kernel_init_two(dev, name):
    """A z-buffer at 2.0: there an uncovered record that hits the band
    (zc = 2.0 <= 2.0) takes the id, also where the kernel culled it."""
    stream = _to(dev, STREAMS[name]())
    init_d = torch.full((N_TILES, TH, TW), 2.0, device=dev)
    init_i = torch.full((N_TILES, TH, TW), SENT, dtype=torch.int32,
                        device=dev)
    args = (*stream, init_d, init_i)
    want = rk.rasterize_depth_grid_plain(*args, tile_h=TH)
    _same(rk.rasterize_depth_grid(*args, tile_h=TH), want)
    assert bool(((want[0] == 2.0) & (want[1] != SENT)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k_layers", range(1, 17))
@pytest.mark.parametrize("name", ["heavy", "whole_and_tiny"])
def test_kbuffer_kernel_every_depth(dev, name, k_layers):
    """K = 1..16 on the heavy and the whole-and-tiny streams, with bounds
    of 2.0 (real entries at depth 2.0 beside empty slots) and a floor."""
    rec, start, counts = _to(dev, STREAMS[name]())
    bound = _tile_planes(dev, 5, [0.65, 1.0, 2.0])
    floor = _tile_planes(dev, 6, [-1.0, 0.0, 0.15, 0.3])
    args = (rec, start, counts, bound, floor, SENT, k_layers)
    _same(rk.rasterize_layers_grid(*args, tile_h=TH),
          rk.rasterize_layers_grid_plain(*args, tile_h=TH))


@pytest.mark.cuda
def test_block_timer_launch_is_uncounted(dev):
    rec, start, counts = _to(dev, STREAMS["heavy"]())
    init_d = torch.ones((N_TILES, TH, TW), device=dev)
    init_i = torch.full((N_TILES, TH, TW), SENT, dtype=torch.int32,
                        device=dev)
    before = rk.rasterize_depth_grid.launches
    ns = rk.kernel_block_ns(rk.rasterize_depth_grid, rec, start, counts,
                            init_d, init_i, tile_h=TH)
    torch.cuda.synchronize()
    assert rk.rasterize_depth_grid.launches == before
    assert ns.shape == (rk._lib().vkr_raster_blocks(N_TILES, TH, 0), 2)
    took = ns[:, 1] - ns[:, 0]
    assert bool((took >= 0).all()) and int(took.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k_layers", [1, 3, 7, 10, 16])
@pytest.mark.parametrize("peel", [False, True], ids=["bound", "floor"])
def test_kbuffer_kernel_matches_plain(stream, dev, k_layers, peel):
    """Every depth of the layer stack the masked pass asks for (10 in round
    0, 6 + the probe in the tail), the kernel's limit (16), a bound
    (z <= bound) and a floor (z > floor)."""
    bound = _tile_planes(dev, 3, [0.65, 1.0])
    floor = _tile_planes(dev, 4, [-1.0, 0.15, 0.3, 2.0]) if peel else None
    before = rk.rasterize_layers_grid.launches
    args = (*stream, bound, floor, SENT, k_layers)
    _same(rk.rasterize_layers_grid(*args, tile_h=TH),
          rk.rasterize_layers_grid_plain(*args, tile_h=TH))
    assert rk.rasterize_layers_grid.launches == before + 1


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_arguments(dev):
    rec, start, counts = (torch.from_numpy(np.asarray(x)).to(dev)
                          for x in synthetic_stream())
    bound = torch.ones((N_TILES, TH, TW), device=dev)
    with pytest.raises(ValueError, match="k_layers"):
        rk.rasterize_layers_grid(rec, start, counts, bound, None, SENT, 17,
                                 tile_h=TH)
    with pytest.raises(ValueError, match="on cpu"):
        rk.rasterize_layers_grid(rec, start.cpu(), counts, bound, None, SENT,
                                 2, tile_h=TH)
    with pytest.raises(TypeError):
        rk.rasterize_depth_grid(rec, start, counts, bound,
                                bound.to(torch.int64), tile_h=TH)
    # the bulk copies need 16-byte aligned records
    flat = torch.zeros(rec.numel() + 1, device=dev)
    shifted = flat[1:].reshape(rec.shape)
    with pytest.raises(ValueError, match="aligned"):
        rk.rasterize_layers_grid(shifted, start, counts, bound, None, SENT,
                                 2, tile_h=TH)


POST_SHAPES = [(1, 1), (7, 130), (1080, 1920)]
POST_ULP = 2


def _hdr_image(dev, h, w, seed):
    """HDR colours with the edge values first: 0, -0, denormals, the
    smallest normal, 1, 1e30, inf and a NaN."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 16, size=3 * h * w).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, 3e-39, 1.17549435e-38, 1.0, 1e30,
                        np.inf, np.nan, 1e-30], np.float32)
    img[:min(img.size, special.size)] = special[:img.size]
    return torch.from_numpy(img.reshape(3, h, w)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", POST_SHAPES, ids=lambda x: str(x))
def test_tonemap_kernel_matches_plain(dev, h, w):
    img = _hdr_image(dev, h, w, h + w)
    before = post.tonemap.launches
    got = post.tonemap(img)
    want = post.tonemap_plain(img)
    torch.cuda.synchronize()
    assert post.tonemap.launches == before + 1
    ulp = max_ulp(got, want)
    print(f"tonemap {h}x{w}: max_ulp {ulp}")
    assert ulp <= POST_ULP, ulp
    assert float(got.reshape(-1)[0]) == 0.0          # zero maps to 0


@pytest.mark.cuda
def test_tonemap_kernel_takes_an_unaligned_view(dev):
    """A view whose start is not 16-byte aligned takes the scalar loop."""
    img = _hdr_image(dev, 7, 130, 3).reshape(-1)
    flat = torch.empty(img.numel() + 1, device=dev)[1:]
    flat.copy_(img)
    got = post.tonemap(flat)
    assert max_ulp(got, post.tonemap_plain(flat)) <= POST_ULP


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", POST_SHAPES, ids=lambda x: str(x))
@pytest.mark.parametrize("extent", ["h", "short"])
def test_gradient_kernel_matches_plain(dev, h, w, extent):
    rng = np.random.default_rng(h * w)
    top, bottom = (torch.from_numpy(x).to(dev) for x in rng.uniform(
        0, 1, size=(2, 4)).astype(np.float32))
    top[1] = 3e-39                                       # a denormal
    extent_h = None if extent == "h" else max(1, h - 3)
    before = post.gradient.launches
    got = post.gradient(h, w, top, bottom, extent_h)
    want = post.gradient_plain(h, w, top, bottom, extent_h)
    torch.cuda.synchronize()
    assert post.gradient.launches == before + 1
    assert got.shape == (3, h, w)
    ulp = max_ulp(got, want)
    print(f"gradient {h}x{w} extent {extent_h}: max_ulp {ulp}")
    assert ulp <= POST_ULP, ulp


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0, 1, 270, 810, 4093])
@pytest.mark.parametrize("w", [1920, 130])
def test_gradient_kernel_row_offset(dev, row0, w):
    """The strip form: rows row0 .. row0 + h of an extent-row gradient
    equal the plain version, and the whole frame's rows bit for bit."""
    h, extent = 270, 4363
    rng = np.random.default_rng(row0 + w)
    top, bottom = (torch.from_numpy(x).to(dev) for x in rng.uniform(
        0, 1, size=(2, 4)).astype(np.float32))
    got = post.gradient(h, w, top, bottom, extent, row0=row0)
    want = post.gradient_plain(h, w, top, bottom, extent, row0=row0)
    whole = post.gradient(extent, w, top, bottom, extent)
    torch.cuda.synchronize()
    assert max_ulp(got, want) <= POST_ULP
    assert torch.equal(got, whole[:, row0:row0 + h])


@pytest.mark.cuda
def test_strips_on_the_card_equal_the_cpu_strips(dev, monkeypatch):
    """The cube with shadows at 256x128 as 2 strips
    (parallel/sharded.py) on the card and on the CPU: every depth raster
    of the frame (each strip's one raster of all its cascade rows, and
    its camera rows) gives the same depth bits and triangle ids on
    both."""
    from vk_renderer_tpu_torch.graph import driver, frame
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.parallel import sharded
    from vk_renderer_tpu_torch.scene import procedural
    from vk_renderer_tpu_torch.scene.camera import Camera
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    host = procedural.build_cube_scene().build()
    settings = RenderSettings(enable_shadows=True, shadow_mode=0)
    cfg = frame.FrameConfig(width=256, height=128, cap_opaque=128,
                            cap_masked=64, cap_transparent=64,
                            shadow_size=256, shadow_cap=256,
                            enable_shadows=True)
    rasters = {}
    real = raster.rasterize_plan
    for where in ("cpu", dev):
        seen = rasters.setdefault(str(where), [])

        def spy(*args, **kw):
            out = real(*args, **kw)
            seen.append([t.cpu() for t in out])
            return out

        monkeypatch.setattr(raster, "rasterize_plan", spy)
        scene = scene_to_torch(host, where)
        sd, st = driver.frame_inputs(scene, Camera(), settings, cfg)
        out = sharded.render_frame_sharded(scene, sd, st, cfg, n=2)
        assert frame.stats_from_vec(out["stats_vec"])["bin_overflow"] == 0
    cpu, card = rasters["cpu"], rasters[str(dev)]
    # per strip: its rows of every cascade in one raster, then its camera
    # rows
    assert len(cpu) == len(card) == 2 * 2
    for (cd, ci), (gd, gi) in zip(cpu, card):
        assert torch.equal(cd.view(torch.int32), gd.view(torch.int32))
        assert torch.equal(ci, gi)


@pytest.mark.cuda
def test_shadow_pass_runs_without_a_host_sync(dev):
    """The cube's four 256^2 cascades on the card: the batched shadow
    pass (setup, binning, records and the one depth raster of every
    cascade) runs under ``set_sync_debug_mode("error")``, so no op in it
    waits for the device, and its pair-packed maps and bin overflow equal
    the CPU's bit for bit."""
    from vk_renderer_tpu_torch.graph import driver, frame
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.scene import procedural
    from vk_renderer_tpu_torch.scene.camera import Camera
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    host = procedural.build_cube_scene().build()
    settings = RenderSettings(enable_shadows=True, shadow_mode=3)
    cfg = driver.config_from_settings(settings, 256, 128, shadow_size=256,
                                      shadow_cap=256)
    got = {}
    for where in ("cpu", dev):
        scene = scene_to_torch(host, where)
        sd, _ = driver.frame_inputs(scene, Camera(), settings, cfg)
        if where == dev:
            frame.shadow_pass(scene, sd, cfg)       # builds the kernels
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                maps, ovf = frame.shadow_pass(scene, sd, cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            maps, ovf = frame.shadow_pass(scene, sd, cfg)
        got[str(where)] = (maps.cpu(), int(ovf))
    (cmaps, covf), (gmaps, govf) = got["cpu"], got[str(dev)]
    assert cmaps.shape == (frame.NUM_CASCADES, 256, 256)
    assert torch.equal(cmaps, gmaps)
    assert covf == govf == 0


@pytest.mark.cuda
def test_post_wrappers_reject_bad_arguments(dev):
    with pytest.raises(TypeError):
        post.tonemap(torch.ones((3, 4, 4), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        post.tonemap(torch.ones((3, 4, 4), device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="on cpu"):
        post.gradient(4, 4, torch.ones(4, device=dev), torch.ones(4))


def _classifier_case(seed, h=64, w=96, size=256):
    """Flat 0.25 / 0.9 half-plane maps with a noisy band (lit, blocked and
    uncertain pixels all exist; tests/test_torch_classifier.py), identity
    light matrices, one pixel in ten uncovered or facing away: (packed
    maps, scene data, G-buffer, n_dot_l) on the CPU."""
    rng = np.random.default_rng(seed)
    smap = np.full((4, size, size), 0.9, np.float32)
    smap[:, :, : size // 2] = 0.25
    smap[:, :, size // 2 - 8: size // 2 + 8] = rng.uniform(
        0.1, 0.95, size=(4, size, 16))
    sd = {"cascade_distances": torch.tensor([2.0, 8.0, 22.0, 100.0]),
          "light_viewproj": torch.eye(4).repeat(4, 1, 1)}
    g = {k: torch.from_numpy(rng.uniform(lo, hi, (h, w)).astype(np.float32))
         for k, lo, hi in (("wx", -1.3, 1.3), ("wy", -1.3, 1.3),
                           ("wz", 0.15, 0.97), ("view_z", 0.5, 80))}
    g["covered"] = torch.from_numpy(rng.random((h, w)) < 0.9)
    ndl = torch.from_numpy((rng.random((h, w)) < 0.9).astype(np.float32))
    return tex.pack_shadow_maps(torch.from_numpy(smap)), sd, g, ndl


def _on(dev, tree):
    if isinstance(tree, dict):
        return {k: v.to(dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_classified_shadow_on_the_card(dev, mode):
    """Modes 0-3, all three classifier stages: the card's lit / blocked
    masks equal the CPU's, and its classified factor equals its dense
    factor on active pixels (0 elsewhere), bit for bit."""
    packed, sd, g, ndl = _classifier_case(40 + mode)
    tables = (tex.build_shadow_coarse(packed, block=16),
              tex.build_shadow_coarse(packed, block=4))
    masks = {}
    for where in ("cpu", dev):
        p, s, gb = _on(where, packed), _on(where, sd), _on(where, g)
        su, sv, sz, layer = shade.shadow_coords(gb["wx"], gb["wy"], gb["wz"],
                                                gb["view_z"], s, mode)
        masks[str(where)] = [m.cpu() for m in shade._classify_shadow(
            _on(where, tables[0]), su, sv, sz, layer, 256, mode,
            shadow_rows=p, shadow_fine=_on(where, tables[1]))]
    cpu, card = masks["cpu"], masks[str(dev)]
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    assert bool(cpu[0].any()) and bool(cpu[1].any())
    p, s, gb, n = _on(dev, packed), _on(dev, sd), _on(dev, g), _on(dev, ndl)
    got, ovf = shade.classified_shadow_factor(
        p, _on(dev, tables[0]), gb, s, mode, True, n, n.numel(),
        shadow_fine=_on(dev, tables[1]))
    dense = shade.compute_shadow_factor(p, gb["wx"], gb["wy"], gb["wz"],
                                        gb["view_z"], s, mode, True)
    torch.cuda.synchronize()
    assert int(ovf) == 0
    active = gb["covered"] & (n > 0)
    assert torch.equal(got.view(torch.int32),
                       torch.where(active, dense, 0.0).view(torch.int32))



@pytest.mark.cuda
def test_viewer_core_on_the_card(dev, monkeypatch):
    """The port's viewer (app/viewer.py) on the card against itself on
    the CPU, both driven through main by one key script and one
    fixed-step clock (tests/viewer_script.py, the script the CPU test
    holds the CPU viewer to the JAX viewer with): equal HUD strings,
    every frame >= 40 dB with equal stats (phase 11's bound of
    chip_smoke.py for the card's frame against the CPU path), the same
    camera and render sizes; the card's upscale of one image equals the
    CPU's bit for bit."""
    from viewer_script import ARGV, SCRIPT, run_viewer
    from vk_renderer_tpu_torch.app import viewer
    from vk_renderer_tpu_torch.graph import driver
    from vk_renderer_tpu_torch.utils.image import psnr
    cgui, cframes = run_viewer(monkeypatch, viewer, driver,
                               ARGV + ["--device", "cpu"])
    ggui, gframes = run_viewer(monkeypatch, viewer, driver,
                               ARGV + ["--device", "cuda"])
    assert len(ggui.shown) == len(cgui.shown) == len(SCRIPT)
    assert ggui.texts == cgui.texts
    for i, (cf, gf, ci, gi) in enumerate(zip(cframes, gframes, cgui.shown,
                                             ggui.shown)):
        p = psnr(gi.astype(np.float32) / 255.0, ci.astype(np.float32) / 255.0)
        assert p >= 40.0, (i, p)
        assert gf["stats"] == cf["stats"] and gf["size"] == cf["size"], i
        assert np.array_equal(gf["position"], cf["position"])
    src = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (540, 960, 3), dtype=np.uint8))
    got = viewer.upscale_nearest(src.to(dev), 720, 1280)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), viewer.upscale_nearest(src, 720, 1280))


@pytest.mark.cuda
def test_bench_main_on_the_card(dev):
    """The port's benchmark driver (app/bench.py) on the card at 256x128
    on its default scene: exit 0, one stdout JSON line, the kernels'
    frame >= 40 dB against the plain versions' (the parity line), the
    stats line from the card.  Overflow is gated at the bench's own size,
    1920x1080, by chip_smoke.py phase 15."""
    import contextlib
    import io
    import json
    from vk_renderer_tpu_torch.app import bench
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(["--width", "256", "--height", "128", "--frames",
                         "2", "--no-continuity"])
    assert rc == 0
    (line,) = out.getvalue().splitlines()
    assert json.loads(line)["metric"] == "sponza_replica_256x128_fps"
    lines = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    (parity,) = [ln for ln in lines if "parity_psnr_db" in ln]
    assert parity["parity_psnr_db"] >= 40.0 and parity["parity_pass"]
    (stats,) = [ln for ln in lines if "frametime_ms" in ln]
    assert stats["backend"] == "cuda" and stats["triangles"] > 0


ACROSS_FRAMES = 3


def _across_case(case: str, dev):
    """(scene, settings, config, camera) of one across-cards case on
    ``dev``: the cube with shadows at 256x128, or the bench frame (the
    Sponza replica at 1920x1080, CSM, tonemap; chip_smoke.py's)."""
    from vk_renderer_tpu_torch.graph import driver, frame
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.scene import ktx, procedural
    from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
    from vk_renderer_tpu_torch.scene.camera import Camera
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    if case == "cube":
        settings = RenderSettings(enable_shadows=True, shadow_mode=0)
        cfg = frame.FrameConfig(width=256, height=128, cap_opaque=128,
                                cap_masked=64, cap_transparent=64,
                                shadow_size=256, shadow_cap=256,
                                enable_shadows=True)
        return (scene_to_torch(procedural.build_cube_scene().build(), dev),
                settings, cfg, Camera())
    b = SceneBuilder()
    b.load_gltf("assets/sponza_replica/Sponza.glb", "sponza")
    b.cubemap = ktx.load_cubemap("assets/sponza_replica/pisa_cube.ktx")
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = driver.config_from_settings(settings, 1920, 1080,
                                      shadow_size=2048)
    cam = Camera(position=np.array([9.0, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2
    return scene_to_torch(b.build(), dev), settings, cfg, cam


def _across_rank(rank: int, world: int, tmp: str, case: str) -> None:
    """One rank of the across-cards world: card ``rank`` over nccl, one
    strip each through
    render_frame_sharded(group=...), one warm-up and ACROSS_FRAMES timed
    frames.  Rank 0 then leaves the group, renders the same ``world``
    strips in turn on its own device, and saves into ``tmp`` whether the
    two frames are equal bit for bit and both frame times."""
    import datetime
    import os
    import time
    import torch.distributed as dist
    from vk_renderer_tpu_torch.graph import driver, frame
    from vk_renderer_tpu_torch.parallel import sharded
    torch.cuda.set_device(rank)
    scene, settings, cfg, cam = _across_case(case,
                                             torch.device("cuda", rank))
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)

    def timed(**kw):
        out = sharded.render_frame_sharded(scene, sd, st, cfg, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ACROSS_FRAMES):
            out = sharded.render_frame_sharded(scene, sd, st, cfg, **kw)
        torch.cuda.synchronize()
        return out, 1000.0 * (time.perf_counter() - t0) / ACROSS_FRAMES

    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        got, world_ms = timed(group=dist.group.WORLD)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return
    want, turn_ms = timed(n=world)
    same = {k: bool(torch.equal(
        got[k].view(torch.int32) if k in ("color", "depth") else got[k],
        want[k].view(torch.int32) if k in ("color", "depth") else want[k]))
        for k in ("color", "depth", "color_u8", "stats_vec")}
    torch.save({"equal": same, "world_ms": world_ms, "in_turn_ms": turn_ms,
                "gathered_on": got["color"].device.type,
                "stats": frame.stats_from_vec(got["stats_vec"]),
                "devices": [torch.cuda.get_device_name(i)
                            for i in range(world)]},
               os.path.join(tmp, "rank0.pt"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cube", "bench"])
def test_strips_across_cards(dev, case, tmp_path):
    """The frame as one strip per card (4 cards, or 2 where fewer are
    lent): a world of processes over nccl, one card per rank, through
    render_frame_sharded(group=...).  Its assembled frame equals the same
    strips rendered in turn on one card bit for bit (colour and depth as
    int32 bits, u8, stats); prints both frame times."""
    import json
    import torch.multiprocessing as mp
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two or more CUDA devices ({count} here)")
    world = 4 if count >= 4 else 2
    mp.spawn(_across_rank, args=(world, str(tmp_path), case),
             nprocs=world, join=True)
    got = torch.load(tmp_path / "rank0.pt")
    print(json.dumps({"test": "strips_across_cards", "case": case,
                      "ranks": world, **got}))
    assert got["gathered_on"] == "cuda"
    assert all(got["equal"].values()), got["equal"]
    assert got["stats"]["bin_overflow"] == 0


# ---- the masked pass's resolve (ops/masked.py, csrc/masked.cu) ----------

def _resolve_case(seed, k_layers, probe, custom, colours, cont,
                  max_alpha=255, empty_share=0.1):
    scene, rows, vattr = mc.scene_and_rows(seed, custom, colours, max_alpha)
    d, i = mc.layers(seed, k_layers, empty_share=empty_share)
    n_walk = k_layers - 1 if probe and k_layers > 1 else k_layers
    return ((d, i, n_walk, probe, mc.state(seed, continuing=cont), scene,
             rows, vattr, mc.COLS, mc.WIDTH, mc.HEIGHT))


# random K in 1..11 over the seeds, the probe, the custom-sampler path,
# the vertex-colour layout and a continuation state each on some of them
RESOLVE_CASES = {f"seed{s}_k{1 + (7 * s) % 11}": (
    s, 1 + (7 * s) % 11, s % 2 == 1, s % 3 == 2, s % 4 == 3, s % 5 >= 3,
    150 if s % 2 else 255) for s in range(14)}
RESOLVE_CASES["all_empty"] = (20, 4, True, False, False, False, 255, 1.0)
RESOLVE_CASES["no_empty_custom"] = (21, 10, True, True, True, True, 140,
                                    0.0)


def _same_state(got, want):
    for name, a, b in zip(("depth", "tid", "pending", "deepest"), got,
                          want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_kernel_matches_plain(dev, case):
    args = mc.on(dev, _resolve_case(*RESOLVE_CASES[case]))
    probe = args[3]
    tested_k = torch.zeros((), dtype=torch.int64, device=dev)
    tested_p = torch.zeros((), dtype=torch.int64, device=dev)
    before = masked.masked_resolve.launches
    got, got_p = masked.masked_resolve(*args, tested_k)
    want, want_p = masked.masked_resolve_plain(*args, tested_p)
    torch.cuda.synchronize()
    assert masked.masked_resolve.launches == before + 1
    assert got[0].device.type == "cuda"
    _same_state(got, want)
    assert int(tested_k) == int(tested_p)
    if probe:
        assert int(got_p) == int(want_p)
    else:
        assert got_p is None and want_p is None
    # without a counter the kernel counts nothing and resolves the same
    again, _ = masked.masked_resolve(*args)
    _same_state(again, want)


@pytest.mark.cuda
def test_resolve_kernel_chains_two_rounds(dev):
    """Round 0 (K = 10) and a probe round (6 + 1) on its state, as the
    pass chains them, against the plain version's chain."""
    scene, rows, vattr = mc.on(dev, mc.scene_and_rows(30, max_alpha=140))
    d0, i0 = mc.on(dev, mc.layers(30, 10, empty_share=0.02))
    d1, i1 = mc.on(dev, mc.layers(31, 7, empty_share=0.1))
    st = mc.on(dev, mc.state(30))
    tail = (scene, rows, vattr, mc.COLS, mc.WIDTH, mc.HEIGHT)
    out = {}
    for name, fn in (("kernel", masked.masked_resolve),
                     ("plain", masked.masked_resolve_plain)):
        s0, p0 = fn(d0, i0, 10, False, st, *tail)
        s1, p1 = fn(d1, i1, 6, True, s0, *tail)
        assert p0 is None
        out[name] = (s1, int(p1))
    _same_state(out["kernel"][0], out["plain"][0])
    assert out["kernel"][1] == out["plain"][1] > 0


@pytest.mark.cuda
def test_resolve_wrapper_rejects_bad_arguments(dev):
    args = list(mc.on(dev, _resolve_case(40, 3, False, False, False, True)))
    with pytest.raises(ValueError, match="n_walk"):
        masked.masked_resolve(*(args[:2] + [4] + args[3:]))
    with pytest.raises(TypeError):
        masked.masked_resolve(args[0], args[1].to(torch.int64), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        masked.masked_resolve(args[0].transpose(2, 3).contiguous()
                              .transpose(2, 3), *args[1:])
    st = args[4]
    with pytest.raises(ValueError, match="on cpu"):
        masked.masked_resolve(*args[:4], (st[0].cpu(),) + st[1:],
                              *args[5:])
    with pytest.raises(ValueError, match="do not hold"):
        masked.masked_resolve(*args[:8], 2, *args[9:])
    with pytest.raises(TypeError):
        masked.masked_resolve(*args,
                              torch.zeros((), dtype=torch.int32, device=dev))


NAVE_WALK_POSE20 = (7.334, 1.8, 0.3, 1.663184, 0.0)


@pytest.mark.cuda
def test_masked_pass_on_the_replica_equals_the_plain_resolve(dev,
                                                             monkeypatch):
    """The Sponza replica at 1920x1080 (CSM, 2048^2 cascades, big_cap
    2048) from nave_walk's pose 20: the masked pass with the kernel
    against the same pass with the plain resolve forced on the card:
    equal depth (bits), ids and peel overflow; the kernel's launches rise
    by exactly the rounds that ran, and the tested-pixel counts agree."""
    from vk_renderer_tpu_torch.app.headless import build_scene
    from vk_renderer_tpu_torch.graph import driver, frame
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.scene.camera import Camera
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    from vk_renderer_tpu_torch.utils import tracing
    host = build_scene("scene", "assets/sponza_replica/Sponza.glb",
                       "assets/sponza_replica/pisa_cube.ktx")
    scene = scene_to_torch(host, dev)
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = driver.config_from_settings(settings, 1920, 1080,
                                      shadow_size=2048, big_cap=2048)
    x, y, z, yaw, pitch = NAVE_WALK_POSE20
    cam = Camera(position=np.array([x, y, z], np.float32), yaw=yaw,
                 pitch=pitch)
    calls = []
    real_pass = frame._masked_pass

    def record(*args, **kw):
        calls.append((args, kw))
        return real_pass(*args, **kw)

    monkeypatch.setattr(frame, "_masked_pass", record)
    driver.render(scene, cam, settings, cfg)
    monkeypatch.setattr(frame, "_masked_pass", real_pass)
    (args, kw), = calls
    kernel = masked.masked_resolve

    def run():
        k0 = rk.rasterize_layers_grid.launches
        r0 = kernel.launches
        tracing.reset()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            out = frame._masked_pass(*args, **kw)
        torch.cuda.synchronize()
        counts = tracing.counters()
        tracing.reset()
        return (out, rk.rasterize_layers_grid.launches - k0,
                kernel.launches - r0, counts)

    got, rounds, launched, counts_k = run()
    with monkeypatch.context() as m:
        m.setattr(masked, "masked_resolve", masked.masked_resolve_plain)
        want, rounds_p, launched_p, counts_p = run()
    assert rounds >= 2 and launched == rounds == counts_k["masked.rounds"]
    assert rounds_p == rounds and launched_p == 0
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2]) == 0
    assert counts_k["masked.alpha_px"] == counts_p["masked.alpha_px"] > 0
    masked_px = (got[1] >= host.n_opaque) & (got[1] < host.n_opaque
                                            + host.n_masked)
    assert int(masked_px.sum()) > 100_000
