"""The port's host modules against the JAX package's and their NumPy forms:

- scene/sponza_replica.py writes the JAX writer's GLB and KTX bytes
  (tests/test_sponza_replica.py's reduced sizes), with its own PNG
  encoder in place of PIL's;
- native_bridge.py (native/texops.cpp built with g++ into the package's
  build directory) against the NumPy forms of scene/textures.py on
  tests/test_native.py's inputs.  The C++ decode multiplies by 1/255
  where NumPy divides, and its blit lerps where NumPy sums four
  weighted corners, so floats agree within 1 ulp (decode) and 2^-22
  absolute, two ulp of 1.0 (resize, mips), not bit for bit;
- the texel heap built through the bridge (opt-in) against the
  NumPy-built heap: the stored RGBA8 bytes are equal on those inputs;
  on a larger random heap a few texels (a rounding tie of the 8-bit
  store) differ by one.  The heap builders never call the bridge
  unless asked.

The bridge's tests skip only where g++ is absent."""

import filecmp
import shutil

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch import native_bridge
from vk_renderer_tpu_torch.ops.common import max_ulp
from vk_renderer_tpu_torch.scene import sponza_replica, textures
from vk_renderer_tpu_torch.utils.image import srgb_to_linear

import torch_threads  # noqa: F401  (bounds torch's threads)

needs_gpp = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ unavailable")


def test_replica_writer_is_byte_equal_to_jax(tmp_path):
    from vk_renderer_tpu.scene import sponza_replica as jreplica
    got = sponza_replica.write_glb(str(tmp_path / "p.glb"), tex_size=64,
                                   aux_size=32, scale=0.6)
    want = jreplica.write_glb(str(tmp_path / "j.glb"), tex_size=64,
                              aux_size=32, scale=0.6)
    assert got == want and got[1] == 70
    assert filecmp.cmp(tmp_path / "p.glb", tmp_path / "j.glb", shallow=False)
    sponza_replica.write_pisa_cubemap(str(tmp_path / "p.ktx"), face=32)
    jreplica.write_pisa_cubemap(str(tmp_path / "j.ktx"), face=32)
    assert filecmp.cmp(tmp_path / "p.ktx", tmp_path / "j.ktx", shallow=False)


@pytest.mark.parametrize("kind", ["random", "flat", "gradient"])
def test_png_encoder_is_pil_byte_for_byte(kind):
    """The replica's PNG bytes equal PIL's for noise (Paeth and sub
    rows), flat rows (filter none / up) and ramps."""
    import io
    from PIL import Image
    rng = np.random.default_rng(3)
    if kind == "random":
        img = rng.integers(0, 256, (70, 33, 4), dtype=np.uint8)
    elif kind == "flat":
        img = np.full((40, 300, 4), 77, np.uint8)
        img[20:] = 200
    else:
        x = np.arange(256, dtype=np.uint8)
        img = np.stack(np.broadcast_arrays(x[None], x[:, None], 255 - x[None],
                                           x[:, None] // 2), -1)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="PNG")
    assert sponza_replica._png_bytes(img) == bio.getvalue()


@needs_gpp
def test_native_bridge_matches_numpy_forms():
    assert native_bridge.available()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(33, 17, 4), dtype=np.uint8)
    for srgb in (False, True):
        got = native_bridge.decode_rgba8(img, srgb)
        want = img.astype(np.float32) / 255.0
        if srgb:
            want = np.concatenate([srgb_to_linear(want[..., :3]),
                                   want[..., 3:]], axis=-1)
        assert max_ulp(torch.from_numpy(got), torch.from_numpy(want)) <= 1
    img = np.random.default_rng(1).uniform(
        0, 1, size=(37, 53, 4)).astype(np.float32)
    got = native_bridge.blit_resize_bilinear(img, 26, 18)
    want = textures.blit_resize_bilinear(img, 26, 18)
    assert np.abs(got - want).max() <= 2.0 ** -22
    img = np.random.default_rng(2).uniform(
        0, 1, size=(64, 32, 4)).astype(np.float32)
    got = native_bridge.generate_mips(img)
    want = textures.generate_mips(img)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2.0 ** -22


def _heap(images, native: bool):
    b = textures.TextureHeapBuilder(native)
    ids = [b.add(img, srgb=srgb, mipmapped=True) for img, srgb in images]
    return b.build(), ids


def test_heap_builders_keep_the_numpy_forms_unless_asked(monkeypatch):
    """The default heap (the one the goldens hold) never reaches the
    bridge, through the heap builder or the scene builder."""
    from vk_renderer_tpu_torch.scene.assembly import SceneBuilder

    def refuse(*a, **kw):
        raise AssertionError("the native bridge was called")
    for name in ("decode_rgba8", "generate_mips", "blit_resize_bilinear"):
        monkeypatch.setattr(native_bridge, name, refuse)
    img = np.random.default_rng(4).integers(0, 256, size=(16, 8, 4),
                                            dtype=np.uint8)
    heap, ids = _heap([(img, True), (img, False)], native=False)
    assert heap.n_mips[ids[0]] == 5
    sb = SceneBuilder()
    assert not sb.heap.native
    sb.heap.add(img, srgb=True, mipmapped=True)
    assert SceneBuilder(native_textures=True).heap.native


@needs_gpp
def test_heap_built_both_ways():
    """tests/test_native.py's heap input (16x16, sRGB, mipmapped) gives
    the same heap bytes both ways; a random 256x256 heap differs by at
    most one in a channel, in a few texels."""
    rng = np.random.default_rng(3)
    small = [(rng.integers(0, 256, size=(16, 16, 4), dtype=np.uint8), True)]
    (nat, ids), (ref, _) = _heap(small, True), _heap(small, False)
    assert nat.n_mips[ids[0]] == 5
    np.testing.assert_array_equal(nat.texels, ref.texels)
    big = [(rng.integers(0, 256, size=(256, 256, 4), dtype=np.uint8), s)
           for s in (True, False)]
    (nat, _), (ref, _) = _heap(big, True), _heap(big, False)
    for name in ("mip_offsets", "mip_sizes", "n_mips", "srgb_flags"):
        np.testing.assert_array_equal(getattr(nat, name), getattr(ref, name))
    a = nat.texels.view(np.uint8).reshape(-1, 4).astype(np.int16)
    b = ref.texels.view(np.uint8).reshape(-1, 4).astype(np.int16)
    assert np.abs(a - b).max() <= 1
    assert (a != b).any(-1).mean() < 1e-3
