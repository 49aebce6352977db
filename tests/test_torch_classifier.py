"""The port's shadow classifier, shadow and sky cap accounting and the
nearest-mip knob against the JAX package on the same inputs (made from a
seed with numpy), at small sizes: 256^2 maps, 16x24 pixels.

Tolerances: classifier tables, masks and overflow counts are compared
exactly; the classified factor equals the port's own dense filter bit for
bit, and the JAX package's classified factor within f32 rounding (atol
1e-6: its cond branches are fused by XLA).  Frames compare their u8
images exactly.  No JAX frame is compiled."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_renderer_tpu.ops import shade as jshade
from vk_renderer_tpu.ops import skybox as jsky
from vk_renderer_tpu.ops import texture as jtex
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.ops import shade as tshade
from vk_renderer_tpu_torch.ops import skybox as tsky
from vk_renderer_tpu_torch.ops import texture as ttex
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "textured_box",
                       "scene.gltf")
COARSE_BLOCK, FINE_BLOCK = 16, 4   # 2048/64 and 2048/16 cells per side


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _maps(seed, structured, layers=4, size=256):
    """tests/test_shadow_filters.py TestClassifiedShadow._setup's maps:
    flat 0.25 / 0.9 half-planes with a noisy band in the middle (certain
    blocked, certain lit and uncertain regions all exist), or noise."""
    rng = np.random.default_rng(seed)
    if structured:
        smap = np.full((layers, size, size), 0.9, np.float32)
        smap[:, :, : size // 2] = 0.25
        band = slice(size // 2 - 8, size // 2 + 8)
        smap[:, :, band] = rng.uniform(
            0.1, 0.95, size=(layers, size, 16)).astype(np.float32)
    else:
        smap = rng.uniform(0.1, 0.9,
                           size=(layers, size, size)).astype(np.float32)
    return rng, ttex.pack_shadow_maps(T(smap)).numpy()


def _setup(seed, structured, h=16, w=24):
    """(packed maps, scene data, G-buffer, n_dot_l) as numpy: light
    matrices are the identity (su = wx * 0.5 + 0.5); one pixel in ten is
    uncovered and one in ten faces away from the sun."""
    rng, packed = _maps(seed, structured)
    m = np.stack([np.eye(4, dtype=np.float32)] * 4)
    sd = {"cascade_distances": np.array([2.0, 8.0, 22.0, 100.0], np.float32),
          "light_viewproj": m}
    g = {"wx": rng.uniform(-1.3, 1.3, (h, w)),
         "wy": rng.uniform(-1.3, 1.3, (h, w)),
         "wz": rng.uniform(0.15, 0.97, (h, w)),
         "view_z": rng.uniform(0.5, 80, (h, w))}
    g = {k: v.astype(np.float32) for k, v in g.items()}
    g["covered"] = rng.random((h, w)) < 0.9
    n_dot_l = np.where(rng.random((h, w)) < 0.9, 1.0, 0.0).astype(np.float32)
    return packed, sd, g, n_dot_l


def _tables(packed):
    return (ttex.build_shadow_coarse(T(packed), block=COARSE_BLOCK),
            ttex.build_shadow_coarse(T(packed), block=FINE_BLOCK))


def _dicts(sd, g):
    return ({k: J(v) for k, v in sd.items()}, {k: T(v) for k, v in sd.items()},
            {k: J(v) for k, v in g.items()}, {k: T(v) for k, v in g.items()})


@pytest.mark.parametrize("size,block", [(256, 4), (256, 16), (256, 64),
                                        (8, None)],
                         ids=["b4", "b16", "b64", "tiny_map"])
def test_build_shadow_coarse_matches_jax(size, block):
    """Cells equal as integers; on an 8^2 map the default block (16)
    clamps to one cell per map."""
    _, packed = _maps(size, structured=False, size=size)
    got = ttex.build_shadow_coarse(T(packed), block=block)
    want = jtex.build_shadow_coarse(J(packed), block=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if block is None:
        assert got.shape == (4, 1, 1)
    for s in (8, 256, 512, 1024, 2048, 4096):
        assert ttex.coarse_block_for(s) == jtex.coarse_block_for(s)
        assert ttex.fine_block_for(s) == jtex.fine_block_for(s)


@pytest.mark.parametrize("fine", [False, True], ids=["nofine", "fine"])
@pytest.mark.parametrize("quad", [False, True], ids=["noquad", "quad"])
@pytest.mark.parametrize("structured", [True, False],
                         ids=["structured", "random"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_classify_masks_match_jax(mode, structured, quad, fine):
    """_classify_shadow's lit and blocked masks, and its parts, equal the
    JAX function's called with a Python int mode, on the same coordinates
    (the port's shadow_coords, so the two classifiers see equal inputs)."""
    _check_masks(mode, structured, quad, fine, traced=False)


@pytest.mark.parametrize("fine", [False, True], ids=["nofine", "fine"])
@pytest.mark.parametrize("quad", [False, True], ids=["noquad", "quad"])
@pytest.mark.parametrize("structured", [True, False],
                         ids=["structured", "random"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_traced_classify_masks_match_jax(mode, structured, quad, fine):
    """With ``traced_windows`` the masks and parts equal the JAX
    function's called with the mode as an array, as the JAX frame's
    traced mode calls it (eagerly)."""
    _check_masks(mode, structured, quad, fine, traced=True)


def _check_masks(mode, structured, quad, fine, traced):
    packed, sd, g, _ = _setup(100 + 8 * mode + 4 * structured + 2 * quad
                              + fine, structured)
    coarse, fine_t = _tables(packed)
    _, tsd, _, tg = _dicts(sd, g)
    su, sv, sz, layer = tshade.shadow_coords(tg["wx"], tg["wy"], tg["wz"],
                                             tg["view_z"], tsd, mode)
    got = tshade._classify_shadow(
        coarse, su, sv, sz, layer, 256, mode, return_parts=True,
        shadow_rows=T(packed) if quad else None,
        shadow_fine=fine_t if fine else None, traced_windows=traced)
    want = jshade._classify_shadow(
        J(coarse), J(su), J(sv), J(sz), J(layer), 256,
        jnp.asarray(mode) if traced else mode,
        return_parts=True, shadow_rows=J(packed) if quad else None,
        shadow_fine=J(fine_t) if fine else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert not bool((got[0] & got[1]).any())
    assert set(got[2]) == set(want[2])
    for k, v in got[2].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[2][k]),
                                      err_msg=k)
    if structured:
        # the structured maps leave pixels of all three classes
        assert bool(got[0].any()) and bool(got[1].any())
        assert not bool((got[0] | got[1]).all())


@pytest.mark.parametrize("structured", [True, False],
                         ids=["structured", "random"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_classified_factor_is_the_dense_factor(mode, structured):
    """The classified factor (all three stages) equals the port's dense
    filter bit for bit on active pixels and is 0 elsewhere, with a cap
    that holds every uncertain pixel and with a cap of 5 (the dense
    fallback).  At the cap of 5 it equals the JAX package's classified
    factor within f32 rounding, and both count the same overflow."""
    packed, sd, g, ndl = _setup(200 + 2 * mode + structured, structured)
    coarse, fine_t = _tables(packed)
    jsd, tsd, jg, tg = _dicts(sd, g)
    active = tg["covered"] & (T(ndl) > 0)
    dense = tshade.compute_shadow_factor(T(packed), tg["wx"], tg["wy"],
                                         tg["wz"], tg["view_z"], tsd, mode,
                                         True)
    exact = torch.where(active, dense, 0.0)
    for cap in (ndl.size, 5):
        got, ovf = tshade.classified_shadow_factor(
            T(packed), coarse, tg, tsd, mode, True, T(ndl), cap,
            shadow_fine=fine_t)
        assert torch.equal(got, exact), f"cap {cap}"
        assert (int(ovf) > 0) == (cap == 5)
    want, jovf = jshade.classified_shadow_factor(
        J(packed), J(coarse), jg, jsd, mode, True, J(ndl), 5,
        shadow_fine=J(fine_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert int(ovf) == int(jovf)
    assert 0.0 < float(exact[active].mean()) < 1.0


@pytest.mark.parametrize("scaled", [False, True], ids=["pcf", "pcss"])
def test_batched_taps_equal_tap_by_tap(scaled):
    """The filters sample all their taps in one batch (shade._taps); each
    tap equals a one-tap sample_shadow at the same offset bit for bit, so
    the factor is the tap-by-tap loop's."""
    packed, sd, g, _ = _setup(11 + scaled, True)
    _, tsd, _, tg = _dicts(sd, g)
    su, sv, sz, layer = tshade.shadow_coords(tg["wx"], tg["wy"], tg["wz"],
                                             tg["view_z"], tsd, 3)
    maps = T(packed)
    if scaled:
        offsets = tshade.POISSON_DISK[:tshade.NUM_SAMPLES_PCF]
        scale = tshade.LIGHT_SIZE_UV * (sz - tshade.NEAR_PLANE) / sz
    else:
        texel = 1.0 / 256
        offsets = [(i * texel, j * texel) for i in (-1, 0, 1)
                   for j in (-1, 0, 1)]
        scale = None
    got = tshade._taps(maps, su, sv, offsets, scale, layer)
    for k, (ox, oy) in enumerate(offsets):
        if scale is None:
            want = ttex.sample_shadow(maps, su + ox, sv + oy, layer)
        else:
            want = ttex.sample_shadow(maps, su + ox * scale, sv + oy * scale,
                                      layer)
        assert torch.equal(got[k].view(torch.int32),
                           want.view(torch.int32)), k


def test_classified_factor_shadows_off():
    packed, sd, g, ndl = _setup(7, True)
    coarse, _ = _tables(packed)
    _, tsd, _, tg = _dicts(sd, g)
    got, ovf = tshade.classified_shadow_factor(T(packed), coarse, tg, tsd, 3,
                                               False, T(ndl), 4)
    assert int(ovf) == 0 and not bool(got.any())


def test_sparse_shadow_factor_matches_jax():
    """Plain compaction: the first ``cap`` active pixels in raster order
    are filtered, the rest read 0 and are counted, as compact_mask does;
    with room for every active pixel it is the dense factor on them."""
    packed, sd, g, ndl = _setup(8, True)
    jsd, tsd, jg, tg = _dicts(sd, g)
    got, ovf = tshade._sparse_shadow_factor(T(packed), tg, tsd, 1, True,
                                            T(ndl), 50)
    want, jovf = jshade._sparse_shadow_factor(J(packed), jg, jsd, 1, True,
                                              J(ndl), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    active = tg["covered"] & (T(ndl) > 0)
    assert int(ovf) == int(jovf) == int(active.sum()) - 50
    full, ovf = tshade._sparse_shadow_factor(T(packed), tg, tsd, 1, True,
                                             T(ndl), ndl.size)
    dense = tshade.compute_shadow_factor(T(packed), tg["wx"], tg["wy"],
                                         tg["wz"], tg["view_z"], tsd, 1,
                                         True)
    assert int(ovf) == 0
    assert torch.equal(full, torch.where(active, dense, 0.0))


@pytest.fixture(scope="module")
def fixture_scenes():
    """The glTF fixture (2 materials, textures with alpha) with a small
    sky cubemap: (JAX device scene, port scene)."""
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu.scene.assembly import SceneBuilder
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(16)
    host = b.build()
    return host.device_put(), scene_to_torch(host, "cpu")


@pytest.mark.parametrize("mode", [0, 3])
@pytest.mark.parametrize("shading", ["pbr", "flat"])
def test_shaders_with_the_classifier_equal_dense(fixture_scenes, shading,
                                                 mode):
    """shade_pbr / shade_flat with the classifier (tables and a cap) equal
    themselves with the dense filter bit for bit on covered pixels (the
    frame overwrites the others), and report overflow 0."""
    _, tscene = fixture_scenes
    packed, sd, g, _ = _setup(300 + mode, True)
    rng = np.random.default_rng(mode)
    shape = g["wx"].shape
    cam = Camera(position=np.array([0.5, 1.0, 4.0], np.float32))
    from vk_renderer_tpu_torch.graph.scenedata import build_scene_data
    full = build_scene_data(cam, RenderSettings(enable_shadows=True,
                                                shadow_mode=mode), 2.0)
    full.update(sd)
    tsd = {k: T(np.asarray(v, np.float32)) for k, v in full.items()}
    # light from above and behind the receivers: most pixels face it
    tsd["sunlight_direction"] = T(np.array([0.1, -0.3, -1.0, mode],
                                           np.float32))
    gb = {k: T(v) for k, v in g.items()}
    for k in ("nx", "ny"):
        gb[k] = T(rng.normal(0, 0.3, shape).astype(np.float32))
    gb["nz"] = T(np.ones(shape, np.float32))
    for k in ("cr", "cg", "cb"):
        gb[k] = T(rng.uniform(0.5, 1, shape).astype(np.float32))
    gb["u"], gb["v"] = (T(rng.uniform(-1, 2, shape).astype(np.float32))
                        for _ in range(2))
    for k in ("dudx", "dvdx", "dudy", "dvdy"):
        gb[k] = T(rng.uniform(-0.02, 0.02, shape).astype(np.float32))
    gb["mat_id"] = T(rng.integers(0, int(tscene.mat_tex_ids.shape[0]),
                                  shape).astype(np.int32))
    shader = tshade.shade_pbr if shading == "pbr" else tshade.shade_flat
    rgb_d, a_d = shader(gb, tscene, tsd, T(packed), mode, True)
    rgb_c, a_c, ovf = shader(gb, tscene, tsd, T(packed), mode, True,
                             shadow_sparse_cap=g["wx"].size,
                             shadow_coarse=_tables(packed))
    assert int(ovf) == 0
    assert torch.equal(a_c, a_d)
    cov = gb["covered"]
    for c, d in zip(rgb_c, rgb_d):
        assert torch.equal(c[cov], d[cov])


@pytest.mark.parametrize("cap", ["hw", 8], ids=["hw", "cap8"])
def test_skybox_cap_accounting_matches_jax(fixture_scenes, cap):
    """composite_skybox with a cap: the image does not depend on it, and
    the overflow equals the JAX function's (tests/test_frame.py:297-307)."""
    jscene, tscene = fixture_scenes
    rng = np.random.default_rng(5)
    h, w = 40, 64
    depth = np.where(rng.random((h, w)) < 0.3, 1.0,
                     rng.uniform(0.2, 0.99, (h, w))).astype(np.float32)
    color = rng.random((3, h, w)).astype(np.float32)
    cam = Camera()
    view = cam.view_matrix().astype(np.float32)
    proj = cam.projection_matrix(w / h).astype(np.float32)
    c = h * w if cap == "hw" else cap
    base, ovf0 = tsky.composite_skybox(tuple(T(x) for x in color), T(depth),
                                    tscene.cubemap, T(view), T(proj))
    got, ovf = tsky.composite_skybox(tuple(T(x) for x in color), T(depth),
                                     tscene.cubemap, T(view), T(proj),
                                     sparse_cap=c)
    _, jovf = jsky.composite_skybox(tuple(J(x) for x in color), J(depth),
                                    jscene.cubemap, J(view), J(proj),
                                    sparse_cap=c)
    for a, b in zip(got, base):
        assert torch.equal(a, b)
    assert int(ovf0) == 0 and int(ovf) == int(jovf)
    n_sky = int((depth >= 1.0).sum())
    assert int(ovf) == (n_sky - 8 if cap == 8 else 0)


def test_nearest_mip_sampling_matches_jax(fixture_scenes):
    """sample_trilinear(nearest_mip=True): one bilinear at round(lambda)."""
    jscene, tscene = fixture_scenes
    rng = np.random.default_rng(9)
    shape = (40, 48)
    n_tex = int(tscene.textures.n_mips.shape[0])
    tex_id = rng.integers(0, n_tex, size=shape).astype(np.int32)
    u, v = rng.uniform(-2, 3, size=(2,) + shape).astype(np.float32)
    d = (10.0 ** rng.uniform(-4, -0.5, size=(4,) + shape)
         * rng.choice([-1, 1], size=(4,) + shape)).astype(np.float32)
    want = jtex.sample_trilinear(jscene.textures, J(tex_id), J(u), J(v),
                                 *map(J, d), nearest_mip=True)
    got = ttex.sample_trilinear(tscene.textures, T(tex_id), T(u), T(v),
                                *map(T, d), nearest_mip=True)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    tri = ttex.sample_trilinear(tscene.textures, T(tex_id), T(u), T(v),
                                *map(T, d))
    assert not all(torch.equal(a, b) for a, b in zip(got, tri))


def test_nearest_mip_refused_with_custom_samplers():
    from vk_renderer_tpu_torch.scene.textures import TextureHeapBuilder
    from vk_renderer_tpu_torch.scene.types import textures_to_torch
    b = TextureHeapBuilder()
    b.add(np.zeros((4, 4, 4), np.uint8), srgb=False, mipmapped=True,
          sampler_mode=1 | 2)
    table = textures_to_torch(b.build(), "cpu")
    z = torch.zeros((2, 2))
    with pytest.raises(AssertionError, match="custom samplers"):
        ttex.sample_trilinear(table, torch.zeros((2, 2), dtype=torch.int32),
                              z, z, z, z, z, z, nearest_mip=True)


def _golden(name):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_frame import (_golden_configs, golden_camera,
                                  port_config, port_settings)
    _, builder, settings, cfg = _golden_configs()[name]
    return (scene_to_torch(builder().build(), "cpu"), golden_camera(builder),
            port_settings(settings), port_config(cfg))


@pytest.fixture(scope="module")
def cube_csm():
    """The cube_csm golden's scene, camera, settings and config, and its
    frame with the default classified shadows."""
    scene, cam, settings, cfg = _golden("cube_csm")
    return scene, cam, settings, cfg, driver.render(scene, cam, settings,
                                                    cfg)


@pytest.mark.parametrize("variant", [
    {"shadow_classify_cap": 0},
    {"shadow_fine_classify": False},
    {"shadow_classify_cap": 0, "shadow_sparse_cap": 1 << 20},
    {"shadow_traced_windows": False}],
    ids=["dense", "coarse_only", "plain_compaction", "static_windows"])
def test_cube_csm_frame_is_the_same_image(cube_csm, variant):
    """The cube_csm golden frame with the default classified shadows
    (the JAX frame's traced windows) equals the same frame on another
    shadow path: identical u8 image, equal stats.  ``fallback_px`` (the
    classifier's cap misses) is 0 on every path here: the auto cap holds
    every uncertain pixel."""
    scene, cam, settings, cfg, base = cube_csm
    assert cfg.shadow_classify_cap == -1 and cfg.enable_shadows
    assert cfg.shadow_traced_windows
    other = driver.render(scene, cam, settings,
                          dataclasses.replace(cfg, **variant))
    np.testing.assert_array_equal(base["color_u8"].numpy(),
                                  other["color_u8"].numpy())
    s0 = frame.stats_from_vec(base["stats_vec"])
    s1 = frame.stats_from_vec(other["stats_vec"])
    assert s0 == s1
    assert s0["sparse_overflow"] == 0 and s0["bin_overflow"] == 0


def test_cube_csm_tiny_cap_stats_equal_the_jax_frame(cube_csm):
    """At a classifier cap of 64 pixels both frames miss their caps; with
    the traced windows the port's uncertain pixels are the JAX frame's,
    so every stat, fallback_px included, equals the JAX render_frame's.
    The JAX frame's terms the port has no counterpart for are 0 here:
    the cube has no masked triangles (no tail-tile cap), and its pair
    caps are off (0) or the full emission length, which no pair count
    exceeds (no pair_cap fallback)."""
    from vk_renderer_tpu.graph import driver as jdriver
    from vk_renderer_tpu.graph import frame as jframe
    from vk_renderer_tpu.scene import procedural
    from test_torch_frame import _golden_configs
    scene, cam, settings, cfg, _ = cube_csm
    _, _, jsettings, jcfg = _golden_configs()["cube_csm"]
    jcfg = dataclasses.replace(jcfg, shadow_classify_cap=64)
    host = procedural.build_cube_scene().build()
    assert host.n_masked == 0
    n_tris = host.tris.shape[0]
    for cap, span, big, size_w, size_h in (
            (jcfg.pair_cap, jcfg.max_span, jcfg.big_cap, jcfg.width,
             jcfg.height),
            (jcfg.shadow_pair_cap, jcfg.shadow_max_span, jcfg.shadow_big_cap,
             jcfg.shadow_size, jcfg.shadow_size)):
        n_tiles = -(-size_w // jcfg.tile_w) * -(-size_h // jcfg.tile_h)
        assert jframe._resolve_pair_cap(cap, n_tris, span, big, n_tiles) \
            in (0, n_tris * span + big * n_tiles)
    jout = jframe.render_frame(
        host.device_put(), jdriver.scene_data_pytree(cam, jsettings, jcfg),
        jdriver.make_settings_pytree(jsettings), jcfg)
    want = jframe.stats_from_vec(jout["stats_vec"])
    out = driver.render(scene, cam, settings,
                        dataclasses.replace(cfg, shadow_classify_cap=64))
    got = frame.stats_from_vec(out["stats_vec"])
    assert want["fallback_px"] > 0
    assert got == want
    static = driver.render(scene, cam, settings, dataclasses.replace(
        cfg, shadow_classify_cap=64, shadow_traced_windows=False))
    np.testing.assert_array_equal(static["color_u8"].numpy(),
                                  out["color_u8"].numpy())
    # at CSM the traced windows differ only in the fine window's width
    # of at least one texel: no more pixels are left uncertain here
    assert frame.stats_from_vec(static["stats_vec"])["fallback_px"] \
        <= got["fallback_px"]
