"""KTX cubemap loader (SURVEY C13).

The reference delegates to libktx (`VulkanEngine::load_cubemap`,
src/vk_loader.cpp:521-558: ktxTexture_CreateFromNamedFile +
ktxTexture_VkUploadEx, then a CUBE image view over 6 layers).  This module
parses the two container formats directly — KTX1 (identifier "KTX 11") and
KTX2 ("KTX 20") — for the uncompressed texel formats a skybox cubemap
actually uses:

- 8-bit RGBA8/RGB8 (UNORM or SRGB),
- 16-bit half-float RGBA16F/RGB16F — the actual ``pisa_cube.ktx`` asset is
  VK_FORMAT_R16G16B16A16_SFLOAT (loaded via libktx in the reference),
- 32-bit float RGBA32F/RGB32F,

and returns the base mip as the builder's cubemap layout: f32[6, F, F, 3]
in Vulkan face order (+X, -X, +Y, -Y, +Z, -Z — the KTX face order is
identical, KTX spec 4.3).

KTX2 supercompression: Zstandard (scheme 2, via the ``zstandard`` module
when available) and ZLIB (scheme 3, stdlib) payloads are inflated before
parsing; BasisLZ (scheme 1) requires a transcoder and raises ValueError.
Block-compressed GPU formats (BCn/ETC) are out of scope and raise.

sRGB-format texels are decoded to linear before return, matching what
sampling an _SRGB image does in hardware; float formats are already linear
radiance.  The render path's cubemap planes hold linear radiance
(scene/procedural.py:124).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_KTX1_ID = b"\xabKTX 11\xbb\r\n\x1a\n"
_KTX2_ID = b"\xabKTX 20\xbb\r\n\x1a\n"

# Vulkan formats accepted for KTX2 (vkFormat field):
# vkFormat: (channels, srgb, numpy dtype)
_VK_R8G8B8_UNORM = 23
_VK_R8G8B8_SRGB = 29
_VK_R8G8B8A8_UNORM = 37
_VK_R8G8B8A8_SRGB = 43
_VK_R16G16B16_SFLOAT = 90
_VK_R16G16B16A16_SFLOAT = 97
_VK_R32G32B32_SFLOAT = 106
_VK_R32G32B32A32_SFLOAT = 109
_VK2_FORMATS = {
    _VK_R8G8B8A8_UNORM: (4, False, np.uint8),
    _VK_R8G8B8A8_SRGB: (4, True, np.uint8),
    _VK_R8G8B8_UNORM: (3, False, np.uint8),
    _VK_R8G8B8_SRGB: (3, True, np.uint8),
    _VK_R16G16B16A16_SFLOAT: (4, False, np.float16),
    _VK_R16G16B16_SFLOAT: (3, False, np.float16),
    _VK_R32G32B32A32_SFLOAT: (4, False, np.float32),
    _VK_R32G32B32_SFLOAT: (3, False, np.float32),
}

# KTX2 supercompressionScheme values (KTX2 spec 3.12.2)
_SC_NONE = 0
_SC_BASISLZ = 1
_SC_ZSTD = 2
_SC_ZLIB = 3

# GL enums for KTX1
_GL_UNSIGNED_BYTE = 0x1401
_GL_FLOAT = 0x1406
_GL_HALF_FLOAT = 0x140B
_GL_RGB = 0x1907
_GL_RGBA = 0x1908
_GL_SRGB8 = 0x8C41
_GL_SRGB8_ALPHA8 = 0x8C43
_GL_TYPES = {_GL_UNSIGNED_BYTE: np.uint8, _GL_HALF_FLOAT: np.float16,
             _GL_FLOAT: np.float32}


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _faces_to_cubemap(raw: bytes, face: int, nchan: int, srgb: bool,
                      dtype=np.uint8,
                      face_stride: int | None = None) -> np.ndarray:
    """Six tightly packed faces of ``face``x``face`` texels -> f32 cubemap."""
    itemsize = np.dtype(dtype).itemsize
    fs = face * face * nchan * itemsize if face_stride is None else face_stride
    out = np.zeros((6, face, face, 3), np.float32)
    for f in range(6):
        img = np.frombuffer(raw, dtype, count=face * face * nchan,
                            offset=f * fs)
        img = img.reshape(face, face, nchan)[..., :3].astype(np.float32)
        if dtype == np.uint8:
            img = img / 255.0
            out[f] = _srgb_to_linear(img) if srgb else img
        else:
            # float payloads are linear radiance already (HDR allowed;
            # negative/NaN texels are clamped like libktx's upload would
            # leave them to the sampler — keep them finite here)
            out[f] = np.nan_to_num(img, nan=0.0, posinf=65504.0, neginf=0.0)
    return out


def _load_ktx1(data: bytes) -> np.ndarray:
    (endianness, gl_type, _gl_type_size, gl_format, gl_internal, _gl_base,
     width, height, depth, n_array, n_faces, _n_mips,
     kv_bytes) = struct.unpack_from("<13I", data, 12)
    if endianness != 0x04030201:
        raise ValueError("big-endian KTX1 not supported")
    if gl_type not in _GL_TYPES:
        raise ValueError(f"KTX1 glType 0x{gl_type:x} not supported "
                         "(uncompressed 8-bit / 16F / 32F only)")
    dtype = _GL_TYPES[gl_type]
    if n_faces != 6 or depth not in (0, 1) or n_array not in (0, 1):
        raise ValueError("not a non-array cubemap KTX1")
    if width != height:
        raise ValueError("cubemap faces must be square")
    if gl_format == _GL_RGBA:
        nchan = 4
    elif gl_format == _GL_RGB:
        nchan = 3
    else:
        raise ValueError(f"KTX1 glFormat 0x{gl_format:x} not supported")
    srgb = gl_internal in (_GL_SRGB8, _GL_SRGB8_ALPHA8)

    off = 12 + 13 * 4 + kv_bytes
    # mip 0: u32 imageSize, then 6 faces each padded to 4 bytes
    (image_size,) = struct.unpack_from("<I", data, off)
    off += 4
    face_bytes = width * height * nchan * np.dtype(dtype).itemsize
    pad = (4 - face_bytes % 4) % 4
    del image_size  # per KTX1: size of ONE face for cubemaps
    return _faces_to_cubemap(data[off:], width, nchan, srgb, dtype=dtype,
                             face_stride=face_bytes + pad)


def _inflate(payload: bytes, supercomp: int, expect_len: int) -> bytes:
    """Undo KTX2 level supercompression (Zstd via the ``zstandard`` module,
    ZLIB via stdlib)."""
    if supercomp == _SC_NONE:
        return payload
    if supercomp == _SC_ZSTD:
        try:
            import zstandard
        except ImportError as e:           # pragma: no cover - env-dependent
            raise ValueError(
                "Zstandard-supercompressed KTX2 needs the 'zstandard' "
                "module") from e
        out = zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=expect_len)
        if len(out) != expect_len:
            raise ValueError(
                f"KTX2 Zstd level expanded to {len(out)} bytes, "
                f"header declares {expect_len}")
        return out
    if supercomp == _SC_ZLIB:
        # bounded, like the Zstd path: a corrupt/hostile stream must not
        # expand past the declared uncompressedByteLength
        out = zlib.decompressobj().decompress(payload, expect_len)
        if len(out) != expect_len:
            raise ValueError(
                f"KTX2 ZLIB level expanded to {len(out)} bytes, "
                f"header declares {expect_len}")
        return out
    raise ValueError(f"KTX2 supercompression scheme {supercomp} not "
                     "supported (BasisLZ needs a transcoder)")


def _load_ktx2(data: bytes) -> np.ndarray:
    (vk_format, _type_size, width, height, depth, layers, n_faces,
     level_count, supercomp) = struct.unpack_from("<9I", data, 12)
    if n_faces != 6 or depth not in (0, 1) or layers not in (0, 1):
        raise ValueError("not a non-array cubemap KTX2")
    if width != height:
        raise ValueError("cubemap faces must be square")
    if vk_format not in _VK2_FORMATS:
        raise ValueError(f"KTX2 vkFormat {vk_format} not supported "
                         "(RGBA8/RGB8 8-bit, 16F, 32F only)")
    nchan, srgb, dtype = _VK2_FORMATS[vk_format]

    # fixed header (80 bytes) is followed by the level index
    level_index_off = 80
    byte_off, byte_len, unc_len = struct.unpack_from(
        "<3Q", data, level_index_off)  # level 0 (largest mip is level 0)
    payload = _inflate(data[byte_off:byte_off + byte_len], supercomp,
                       unc_len or width * width * nchan
                       * np.dtype(dtype).itemsize * 6)
    return _faces_to_cubemap(payload, width, nchan, srgb, dtype=dtype)


def load_cubemap(path: str) -> np.ndarray:
    """KTX1/KTX2 cubemap file -> f32[6, F, F, 3] linear, Vulkan face order.
    Drop-in for SceneBuilder.cubemap (scene/assembly.py:106)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:12] == _KTX1_ID:
        return _load_ktx1(data)
    if data[:12] == _KTX2_ID:
        return _load_ktx2(data)
    raise ValueError(f"{path}: not a KTX1/KTX2 file")


