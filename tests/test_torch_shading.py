"""Port interpolation, texturing, shading, skybox and post against the JAX
package on the same inputs (made from a seed with numpy).

Tolerance rtol=1e-5, atol=1e-6 for float outputs: the f32 sums and the
transcendental functions (pow, log2, exp2, rsqrt) may round differently
between XLA and PyTorch.  Stored forms (16-bit shadow words) and integer
outputs are compared exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_renderer_tpu.graph.scenedata import RenderSettings, build_scene_data
from vk_renderer_tpu.ops import interp as jinterp
from vk_renderer_tpu.ops import post as jpost
from vk_renderer_tpu.ops import raster as jraster
from vk_renderer_tpu.ops import setup as jsetup
from vk_renderer_tpu.ops import shade as jshade
from vk_renderer_tpu.ops import skybox as jsky
from vk_renderer_tpu.ops import texture as jtex
from vk_renderer_tpu.scene.camera import Camera
from vk_renderer_tpu_torch.ops import interp as tinterp
from vk_renderer_tpu_torch.ops import post as tpost
from vk_renderer_tpu_torch.ops import shade as tshade
from vk_renderer_tpu_torch.ops import skybox as tsky
from vk_renderer_tpu_torch.ops import texture as ttex
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)

TOL = dict(rtol=1e-5, atol=1e-6)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "textured_box",
                       "scene.gltf")


def T(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **{**TOL, **kw})


@pytest.fixture(scope="module")
def scenes():
    """The glTF fixture (textures with alpha, 2 materials) + a small sky
    cubemap: (JAX device scene, port scene)."""
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu.scene.assembly import SceneBuilder
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(16)
    host = b.build()
    return host.device_put(), scene_to_torch(host, "cpu")


def _scene_data(mode=3):
    cam = Camera(position=np.array([0.5, 1.0, 4.0], np.float32))
    cam.yaw = 0.2
    sd = build_scene_data(cam, RenderSettings(enable_shadows=True,
                                              shadow_mode=mode), 2.0)
    return ({k: jnp.asarray(v) for k, v in sd.items()},
            {k: T(np.asarray(v, np.float32)) for k, v in sd.items()})


def test_interpolation_matches_jax():
    rng = np.random.default_rng(0)
    n, v, h, w = 30, 90, 24, 40
    pts = rng.uniform([0, 0], [w, h], size=(v, 2))
    clip = np.stack([pts[:, 0] / w * 2 - 1, pts[:, 1] / h * 2 - 1,
                     rng.uniform(0.1, 0.9, v), rng.uniform(0.5, 2.0, v)],
                    1).astype(np.float32)
    clip[:, :3] *= clip[:, 3:]
    tris = rng.integers(0, v, size=(n, 3)).astype(np.int32)
    st = jsetup.triangle_setup(tuple(jnp.asarray(clip[:, c])
                                     for c in range(4)),
                               tuple(jnp.asarray(tris[:, c])
                                     for c in range(3)),
                               jnp.ones(n, bool), w, h,
                               cull=jsetup.CULL_NONE)
    pad = jraster.pad_setup(st)
    tris_p = tuple(jnp.asarray(np.append(tris[:, c], 0)) for c in range(3))
    mat_p = jnp.asarray(rng.integers(0, 3, n + 1).astype(np.int32))
    jrows = jinterp.build_tri_rows(pad, tris_p, mat_p)
    trows = tinterp.build_tri_rows(
        {k: [T(p) for p in pad[k]] for k in pad},
        tuple(T(t) for t in tris_p), T(mat_p))
    for a, b in zip(jrows, trows):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tid = rng.integers(-1, n, size=(h, w)).astype(np.int32)
    jw = jinterp.interpolation_weights_rows(jnp.asarray(tid), *jrows)
    tw = tinterp.interpolation_weights_rows(T(tid), *trows)
    np.testing.assert_array_equal(tw["mat_id"].numpy(),
                                  np.asarray(jw["mat_id"]))
    for k in range(3):
        np.testing.assert_array_equal(tw["vidx"][k].numpy(),
                                      np.asarray(jw["vidx"][k]))
    vattr = rng.normal(size=(v, 8)).astype(np.float32)
    jc = jinterp.gather_corners(jnp.asarray(vattr), jw["vidx"])
    tc = tinterp.gather_corners(T(vattr), tw["vidx"])
    for a, b in zip(jinterp.interp_from_corners(jc, jw["lam"]),
                    tinterp.interp_from_corners(tc, tw["lam"])):
        close(b, a)
    for ja, ta in zip(jinterp.derivs_from_corners(jc, (3, 4), jw),
                      tinterp.derivs_from_corners(tc, (3, 4), tw)):
        for a, b in zip(ja, ta):
            close(b, a)


def _uv_inputs(rng, shape, n_tex):
    tex_id = rng.integers(0, n_tex, size=shape).astype(np.int32)
    u, v = rng.uniform(-2, 3, size=(2,) + shape).astype(np.float32)
    d = (10.0 ** rng.uniform(-4, -0.5, size=(4,) + shape)
         * rng.choice([-1, 1], size=(4,) + shape)).astype(np.float32)
    return tex_id, u, v, d


def test_trilinear_sampling_matches_jax(scenes):
    jscene, tscene = scenes
    rng = np.random.default_rng(1)
    n_tex = int(tscene.textures.n_mips.shape[0])
    tex_id, u, v, d = _uv_inputs(rng, (64, 48), n_tex)
    jl, jmax = jtex.compute_lod(jscene.textures, jnp.asarray(tex_id),
                                *map(jnp.asarray, d))
    tl, tmax = ttex.compute_lod(tscene.textures, T(tex_id), *map(T, d))
    close(tl, jl)
    close(tmax, jmax)
    want = jtex.sample_trilinear(jscene.textures, jnp.asarray(tex_id),
                                 jnp.asarray(u), jnp.asarray(v),
                                 *map(jnp.asarray, d))
    got = ttex.sample_trilinear(tscene.textures, T(tex_id), T(u), T(v),
                                *map(T, d))
    for a, b in zip(want, got):
        close(b, a)


def test_shadow_maps_pack_and_sample_match_jax():
    rng = np.random.default_rng(2)
    maps = rng.uniform(-0.1, 1.1, size=(4, 32, 32)).astype(np.float32)
    jp = jtex.pack_shadow_maps(jnp.asarray(maps))
    tp = ttex.pack_shadow_maps(T(maps))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    close(ttex.quantize_shadow(T(maps)), jtex.quantize_shadow(
        jnp.asarray(maps)), rtol=0, atol=0)
    u, v = rng.uniform(-0.2, 1.2, size=(2, 40, 30)).astype(np.float32)
    layer = rng.integers(0, 4, size=(40, 30)).astype(np.int32)
    close(ttex.sample_shadow(tp, T(u), T(v), T(layer)),
          jtex.sample_shadow(jp, jnp.asarray(u), jnp.asarray(v),
                             jnp.asarray(layer)))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_shadow_filters_match_jax(mode):
    rng = np.random.default_rng(3 + mode)
    jsd, tsd = _scene_data(mode)
    shape = (24, 32)
    w = rng.uniform(-8, 8, size=(3,) + shape).astype(np.float32)
    w[1] = rng.uniform(-1, 3, shape)
    # smooth maps around the receivers' own light depth, so every filter
    # sees both blockers and lit texels
    lvp = np.asarray(jsd["light_viewproj"])[0]
    z_mid = float(np.median(lvp[2, :3] @ w.reshape(3, -1) + lvp[2, 3]))
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    maps = np.stack([z_mid + 0.05 * np.sin(40 * xx + k) * np.cos(30 * yy)
                     for k in range(4)]).astype(np.float32)
    packed = ttex.pack_shadow_maps(T(maps))
    view = np.asarray(jsd["view"])
    view_z = (w[0] * view[2, 0] + w[1] * view[2, 1] + w[2] * view[2, 2]
              + view[2, 3]).astype(np.float32)
    want = jshade.compute_shadow_factor(
        jnp.asarray(packed.numpy()), *map(jnp.asarray, w),
        jnp.asarray(view_z), jsd, mode, True)
    got = tshade.compute_shadow_factor(packed, *map(T, w), T(view_z), tsd,
                                       mode, True)
    close(got, want)
    assert 0.0 < float(got.mean()) < 1.0


def test_cubemap_and_skybox_match_jax(scenes):
    jscene, tscene = scenes
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(3, 30, 20)).astype(np.float32)
    dirs[:, 0, :3] = [[1, -1, 0], [0, 0, 1], [0, 0, 0]]   # exact axes
    for a, b in zip(jtex.sample_cubemap(jscene.cubemap,
                                        *map(jnp.asarray, dirs)),
                    ttex.sample_cubemap(tscene.cubemap, *map(T, dirs))):
        close(b, a)
    jsd, tsd = _scene_data()
    h, w = 20, 36
    for a, b in zip(jsky.skybox_colors(jscene.cubemap, jsd["view"],
                                       jsd["proj"], h, w),
                    tsky.skybox_colors(tscene.cubemap, tsd["view"],
                                       tsd["proj"], h, w)):
        close(b, a)
    depth = np.where(rng.random((h, w)) < 0.4, 1.0,
                     rng.uniform(0, 1, (h, w))).astype(np.float32)
    color = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    want, _ = jsky.composite_skybox(tuple(jnp.asarray(c) for c in color),
                                    jnp.asarray(depth), jscene.cubemap,
                                    jsd["view"], jsd["proj"])
    got, ovf = tsky.composite_skybox(tuple(T(c) for c in color), T(depth),
                                     tscene.cubemap, tsd["view"], tsd["proj"])
    assert int(ovf) == 0
    for a, b in zip(want, got):
        close(b, a)


@pytest.mark.parametrize("mode", [0, 3])
def test_shade_pbr_matches_jax(scenes, mode):
    """shade_pbr over a random G-buffer (narrow material-row path), with
    shadows from random maps."""
    jscene, tscene = scenes
    rng = np.random.default_rng(5 + mode)
    shape = (20, 28)
    n_mat = int(tscene.mat_tex_ids.shape[0])
    _, u, v, d = _uv_inputs(rng, shape, 1)
    g = {"nx": rng.normal(size=shape), "ny": rng.normal(size=shape),
         "nz": rng.normal(size=shape),
         "cr": rng.uniform(0.5, 1, shape), "cg": rng.uniform(0.5, 1, shape),
         "cb": rng.uniform(0.5, 1, shape), "u": u, "v": v,
         "dudx": d[0], "dvdx": d[1], "dudy": d[2], "dvdy": d[3],
         "wx": rng.uniform(-5, 5, shape), "wy": rng.uniform(0, 3, shape),
         "wz": rng.uniform(-5, 5, shape),
         "view_z": -rng.uniform(0.5, 60, shape)}
    g = {k: np.asarray(x, np.float32) for k, x in g.items()}
    g["mat_id"] = rng.integers(0, n_mat, shape).astype(np.int32)
    g["covered"] = rng.random(shape) < 0.8
    maps = rng.uniform(0.2, 1.0, size=(4, 32, 32)).astype(np.float32)
    packed = ttex.pack_shadow_maps(T(maps))
    jsd, tsd = _scene_data(mode)
    (jr, jg, jb), ja = jshade.shade_pbr(
        {k: jnp.asarray(x) for k, x in g.items()}, jscene, jsd,
        jnp.asarray(packed.numpy()), mode, True)
    (tr, tg, tb), ta = tshade.shade_pbr(
        {k: T(x) for k, x in g.items()}, tscene, tsd, packed, mode, True)
    for a, b in ((jr, tr), (jg, tg), (jb, tb), (ja, ta)):
        close(b, a)


def test_post_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 8, size=(3, 10, 12)).astype(np.float32)
    img[0, 0, 0] = 0.0
    close(tpost.tonemap_xla(T(img)), jpost.tonemap_xla(jnp.asarray(img)))
    top = np.array([1, 0.5, 0, 1], np.float32)
    bottom = np.array([0, 0.25, 1, 1], np.float32)
    close(tpost.gradient_xla(10, 12, T(top), T(bottom)),
          jpost.gradient_xla(10, 12, jnp.asarray(top), jnp.asarray(bottom)))


def _random_gbuffer(rng, shape, n_mat):
    _, u, v, d = _uv_inputs(rng, shape, 1)
    g = {"nx": rng.normal(size=shape), "ny": rng.normal(size=shape),
         "nz": rng.normal(size=shape),
         "cr": rng.uniform(0.5, 1, shape), "cg": rng.uniform(0.5, 1, shape),
         "cb": rng.uniform(0.5, 1, shape), "u": u, "v": v,
         "dudx": d[0], "dvdx": d[1], "dudy": d[2], "dvdy": d[3],
         "wx": rng.uniform(-5, 5, shape), "wy": rng.uniform(0, 3, shape),
         "wz": rng.uniform(-5, 5, shape),
         "view_z": -rng.uniform(0.5, 60, shape)}
    g = {k: np.asarray(x, np.float32) for k, x in g.items()}
    g["mat_id"] = rng.integers(0, n_mat, shape).astype(np.int32)
    g["covered"] = rng.random(shape) < 0.8
    return g


@pytest.mark.parametrize("mode", [0, 3])
def test_shade_flat_matches_jax(scenes, mode):
    """shade_flat (mesh.frag) over a random G-buffer, with shadows from
    random maps, against the JAX package's dense-filter branch."""
    jscene, tscene = scenes
    rng = np.random.default_rng(11 + mode)
    g = _random_gbuffer(rng, (20, 28), int(tscene.mat_tex_ids.shape[0]))
    maps = rng.uniform(0.2, 1.0, size=(4, 32, 32)).astype(np.float32)
    packed = ttex.pack_shadow_maps(T(maps))
    jsd, tsd = _scene_data(mode)
    (jr, jg, jb), ja = jshade.shade_flat(
        {k: jnp.asarray(x) for k, x in g.items()}, jscene, jsd,
        jnp.asarray(packed.numpy()), mode, True)
    (tr, tg, tb), ta = tshade.shade_flat(
        {k: T(x) for k, x in g.items()}, tscene, tsd, packed, mode, True)
    for a, b in ((jr, tr), (jg, tg), (jb, tb), (ja, ta)):
        close(b, a)


SAMPLER_MODES = {                # tests/test_samplers.py MODES
    "nearest": 1 | 2,
    "nearest_mip": 1 | 2 | 4,
    "clamp": (1 << 3) | (1 << 5),
    "mirror": (2 << 3) | (2 << 5),
    "mixed": 1 | (1 << 3) | (2 << 5),
}


@pytest.mark.parametrize("name", sorted(SAMPLER_MODES))
def test_sample_general_matches_jax(name):
    """The per-sampler path (filters, mip modes, wrap modes) against the
    JAX package's _sample_general on one heap holding a custom-sampler and
    a default-sampler texture; UVs cross the wrap boundaries, LODs span
    magnification to level 3."""
    from vk_renderer_tpu.scene.textures import TextureHeapBuilder
    from vk_renderer_tpu.scene.types import TextureTable
    from vk_renderer_tpu_torch.scene.types import textures_to_torch
    rng = np.random.default_rng(len(name))
    img = rng.integers(0, 256, size=(32, 32, 4), dtype=np.uint8)
    b = TextureHeapBuilder()
    b.add(img, srgb=True, mipmapped=True, sampler_mode=SAMPLER_MODES[name])
    b.add(img[::-1], srgb=False, mipmapped=True)
    table = b.build()
    assert table.has_custom_samplers
    jtable = TextureTable(**{
        k: (jnp.asarray(getattr(table, k)) if k != "has_custom_samplers"
            else table.has_custom_samplers)
        for k in ("texels", "mip_offsets", "mip_sizes", "n_mips",
                  "srgb_flags", "sampler_modes", "has_custom_samplers")})
    ttable = textures_to_torch(table, "cpu")
    shape = (40, 48)
    tex_id = rng.integers(0, 2, size=shape).astype(np.int32)
    u = rng.uniform(-1.4, 2.4, shape).astype(np.float32)
    v = rng.uniform(-0.8, 1.9, shape).astype(np.float32)
    lod = rng.uniform(-1.0, 3.0, shape)
    d = np.stack([2.0 ** lod / 32.0 * rng.choice([-1, 1], shape),
                  rng.uniform(-1e-3, 1e-3, shape),
                  rng.uniform(-1e-3, 1e-3, shape),
                  2.0 ** lod / 32.0]).astype(np.float32)
    want = jtex.sample_trilinear(jtable, jnp.asarray(tex_id), jnp.asarray(u),
                                 jnp.asarray(v), *map(jnp.asarray, d))
    got = ttex.sample_trilinear(ttable, T(tex_id), T(u), T(v), *map(T, d))
    for a, b in zip(want, got):
        close(b, a)
    for c in (0, 3):                     # the general path itself
        (g,) = ttex._sample_general(ttable, T(tex_id), T(u), T(v),
                                    *map(T, d), channels=(c,))
        close(g, want[c])
