"""Port host side: PNG decoding, loaders and the scene bridge, against the
JAX package's loaders (PIL-decoded) on the same files.

Every comparison here is exact: the loaders are NumPy code in both
packages, and the device arrays are the host arrays moved."""

import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import torch_threads  # noqa: F401  (bounds torch's threads)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "textured_box",
                       "scene.gltf")
REPLICA_GLB = os.path.join(ROOT, "assets", "sponza_replica", "Sponza.glb")
REPLICA_KTX = os.path.join(ROOT, "assets", "sponza_replica",
                           "pisa_cube.ktx")


def _pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "tests", "fixtures", "textured_box", "*.png"))),
    ids=os.path.basename)
def test_png_decoder_matches_pil_on_fixture(path):
    from vk_renderer_tpu_torch.utils.image import decode_png
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(decode_png(data), _pil_rgba(data))


def test_png_decoder_matches_pil_on_replica_texture():
    """One of the replica GLB's embedded 512^2 RGBA PNGs (Paeth-heavy)."""
    from vk_renderer_tpu_torch.scene.gltf import GltfAsset
    asset = GltfAsset.load(REPLICA_GLB)
    sizes = []
    for i, img in enumerate(asset.json["images"]):
        bv = asset.json["bufferViews"][img["bufferView"]]
        sizes.append((bv["byteLength"], i))
    idx = max(sizes)[1]
    img = asset.json["images"][idx]
    bv = asset.json["bufferViews"][img["bufferView"]]
    start = bv.get("byteOffset", 0)
    raw = bytes(asset.buffers[bv["buffer"]][start:start + bv["byteLength"]])
    got = asset.decode_image(idx)
    assert got.shape[2] == 4 and got.shape[0] >= 256
    np.testing.assert_array_equal(got, _pil_rgba(raw))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "P"])
def test_png_decoder_color_types(mode, tmp_path):
    """Gray, gray+alpha, RGB and palette PNGs (every 8-bit color type)
    decode to the RGBA PIL gives."""
    from vk_renderer_tpu_torch.utils.image import load_png
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, size=(9, 13, 4), dtype=np.uint8)
    img = Image.fromarray(rgba, "RGBA").convert(mode)
    path = tmp_path / f"img_{mode}.png"
    img.save(path)
    np.testing.assert_array_equal(load_png(str(path)),
                                  np.asarray(Image.open(path)
                                             .convert("RGBA")))


def test_png_roundtrip(tmp_path):
    from vk_renderer_tpu_torch.utils.image import load_png, save_png
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(7, 11, 3), dtype=np.uint8)
    path = tmp_path / "rt.png"
    save_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(load_png(str(path))[..., :3], img)


def _heap_words(texels):
    """JAX host heap (4 words per texel, corner 0 = the texel) -> one
    word per texel."""
    return np.asarray(texels).reshape(-1, 4)[:, 0]


def _assert_host_scenes_equal(port, ref):
    for name in ("positions", "normals", "uvs", "colors", "vert_obj",
                 "tris", "tri_material", "obj_world", "obj_bounds",
                 "mat_color_factors", "mat_metal_rough", "mat_tex_ids"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    for name in ("n_opaque", "n_masked", "n_transparent",
                 "n_masked_raster"):
        assert getattr(port, name) == getattr(ref, name), name
    pt, rt = port.textures, ref.textures
    for name in ("mip_offsets", "mip_sizes", "n_mips", "srgb_flags",
                 "sampler_modes"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(rt, name),
                                      err_msg=name)
    np.testing.assert_array_equal(pt.texels, _heap_words(rt.texels))


def test_gltf_fixture_loads_like_jax_package():
    from vk_renderer_tpu.scene.assembly import SceneBuilder as RefBuilder
    from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
    a = SceneBuilder()
    a.load_gltf(FIXTURE, "fixture")
    b = RefBuilder()
    b.load_gltf(FIXTURE, "fixture")
    port, ref = a.build(), b.build()
    assert port.n_masked > 0          # the fixture's MASK material
    _assert_host_scenes_equal(port, ref)


def test_ktx_cubemap_loads_like_jax_package():
    from vk_renderer_tpu.scene import ktx as ref_ktx
    from vk_renderer_tpu_torch.scene import ktx
    np.testing.assert_array_equal(ktx.load_cubemap(REPLICA_KTX),
                                  ref_ktx.load_cubemap(REPLICA_KTX))


@pytest.fixture(scope="module")
def procedural_pairs():
    """(port host scene, JAX host scene) per procedural builder; the
    Sponza-class scene at the goldens' 40k-triangle build."""
    from vk_renderer_tpu.scene import procedural as ref
    from vk_renderer_tpu_torch.scene import procedural
    return {
        "cube": (procedural.build_cube_scene().build(),
                 ref.build_cube_scene().build()),
        "sponza_like": (procedural.build_sponza_like(40_000).build(),
                        ref.build_sponza_like(40_000).build()),
    }


@pytest.mark.parametrize("name", ["cube", "sponza_like"])
def test_procedural_builders_match_jax_package(procedural_pairs, name):
    """The port's procedural builders give the JAX builders' host scene
    array by array, exactly (heap words, cubemap and counts included)."""
    port, ref = procedural_pairs[name]
    _assert_host_scenes_equal(port, ref)
    np.testing.assert_array_equal(port.cubemap, ref.cubemap)
    if name == "sponza_like":
        assert port.n_masked > 0 and port.n_transparent > 0


def test_procedural_primitives_match_jax_package():
    from vk_renderer_tpu.scene import procedural as ref
    from vk_renderer_tpu_torch.scene import procedural
    for a, b in zip(procedural.box_mesh((0.5, 1.0, 2.0), (1, 2, 3), 2.0),
                    ref.box_mesh((0.5, 1.0, 2.0), (1, 2, 3), 2.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        procedural.checker_texture(64, (1, 2, 3, 255), (9, 8, 7, 255), 4),
        ref.checker_texture(64, (1, 2, 3, 255), (9, 8, 7, 255), 4))
    np.testing.assert_array_equal(
        procedural.noise_texture(64, (0.2, 0.7, 0.2), 4, alpha_holes=True),
        ref.noise_texture(64, (0.2, 0.7, 0.2), 4, alpha_holes=True))
    np.testing.assert_array_equal(procedural.make_sky_cubemap(16),
                                  ref.make_sky_cubemap(16))


def _cube_host():
    from vk_renderer_tpu.scene import procedural
    b = procedural.build_cube_scene()
    b.cubemap = procedural.make_sky_cubemap(16)
    return b.build()


def _fixture_host():
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu.scene.assembly import SceneBuilder
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(8)
    return b.build()


@pytest.mark.parametrize("make", [_cube_host, _fixture_host],
                         ids=["cube", "gltf_fixture"])
def test_scene_bridge_matches_device_put(make):
    """scene_to_torch of a JAX-built host scene holds the same values as
    the JAX package's device_put, array by array (the JAX heap and
    cubemap quad interleaves undone)."""
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    host = make()
    assert_scene_matches_device_put(host.device_put(),
                                    scene_to_torch(host, "cpu"))


def assert_scene_matches_device_put(ref, got):
    """A port scene (``got``, torch tensors) holds the values of a JAX
    ``device_put`` scene (``ref``), array by array, with the JAX heap and
    cubemap quad interleaves undone."""
    def same(a, b, name):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)

    for name in ("positions", "normals", "uvs", "tris"):
        for a, b in zip(getattr(ref, name), getattr(got, name)):
            same(a, b, name)
    assert (ref.colors is None) == (got.colors is None)
    if ref.colors is not None:
        for a, b in zip(ref.colors, got.colors):
            same(a, b, "colors")
    for name in ("vert_obj", "tri_material", "obj_world", "obj_bounds",
                 "mat_color_factors", "mat_metal_rough", "mat_tex_ids"):
        same(getattr(ref, name), getattr(got, name), name)
    for name in ("n_opaque", "n_masked", "n_transparent",
                 "n_masked_raster"):
        assert getattr(ref, name) == getattr(got, name)
    rt, gt = ref.textures, got.textures
    same(np.asarray(rt.texels)[:, 0].view(np.int32), gt.texels, "texels")
    for name in ("mip_offsets", "mip_sizes", "n_mips", "srgb_flags",
                 "sampler_modes"):
        same(getattr(rt, name), getattr(gt, name), name)
    f = got.cubemap.shape[1]
    same(np.asarray(ref.cubemap)[:, 0].reshape(6, f, f), got.cubemap,
         "cubemap")
    assert got.positions[0].dtype == torch.float32
    assert got.tris[0].dtype == torch.int32


def test_port_imports_no_jax():
    """The port never imports JAX (it must run where JAX is absent)."""
    code = ("import sys, vk_renderer_tpu_torch.graph.driver, "
            "vk_renderer_tpu_torch.ops.raster_kernels, "
            "vk_renderer_tpu_torch.ops.post, "
            "vk_renderer_tpu_torch.scene.procedural, "
            "vk_renderer_tpu_torch.app.headless, "
            "vk_renderer_tpu_torch.scene.assembly; "
            "print(any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_viewer_imports_neither_jax_nor_cv2():
    """Importing the port's viewer loads no JAX and no OpenCV: only its
    window shell (main) imports cv2, so the window-free core runs where
    there is no OpenCV, as on the GPU machine."""
    code = ("import sys, vk_renderer_tpu_torch.app.viewer; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'cv2', 'vk_renderer_tpu'}))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
