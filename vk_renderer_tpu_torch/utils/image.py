"""Host-side image utilities: framebuffer readback, PNG I/O, PSNR.

The reference blits its RGBA16F draw image to a BGRA8-unorm swapchain
(src/vk_engine_run.cpp:159-161, format at src/vk_engine.cpp:47-51) — a plain
format conversion with clamping, no colorspace math.  ``to_u8`` replicates
that: clamp to [0,1] and quantize.  PSNR is the integration-gate metric from
BASELINE.md (>=40 dB vs reference framebuffers).

PNG is decoded and encoded here without an imaging library: zlib from the
standard library inflates/deflates, and the row unfilter — a byte-serial
recurrence — runs in a small C function (csrc/png_unfilter.c) built with
the host C compiler at first use.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_u8(color_chw: np.ndarray) -> np.ndarray:
    """f32[3, H, W] -> u8[H, W, 3] (the swapchain blit)."""
    img = np.asarray(color_chw)
    img = np.clip(img, 0.0, 1.0)
    img = np.transpose(img, (1, 2, 0))
    return (img * 255.0 + 0.5).astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode — what R8G8B8A8_SRGB sampling does in hardware
    before filtering (textures created at src/vk_loader.cpp:283,296)."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.power(np.maximum(c, 1e-12), 1 / 2.4) - 0.055).astype(np.float32)


@functools.cache
def _unfilter_lib():
    from .build import load_library
    lib = load_library("png_unfilter.c",
                       ["cc", "-O2", "-shared", "-fPIC", "-std=c99"])
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64]
    return lib


def is_png(data: bytes) -> bool:
    return data[:8] == _PNG_SIG


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> u8[H, W, 4] RGBA, the same pixels PIL's
    ``Image.open(...).convert("RGBA")`` gives for 8-bit non-interlaced
    images of every color type (gray, RGB, palette with optional tRNS,
    gray+alpha, RGBA).  Raises ValueError on a corrupt stream and
    NotImplementedError on 16-bit, sub-byte or interlaced images."""
    if not is_png(data):
        raise ValueError("not a PNG stream")
    pos = 8
    ihdr = None
    palette = trns = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, color, _comp, _filt, interlace = ihdr
    if color not in _PNG_CHANNELS:
        raise ValueError(f"bad PNG color type {color}")
    if depth != 8 or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth} / interlace {interlace}: only 8-bit "
            "non-interlaced images are decoded")
    nch = _PNG_CHANNELS[color]
    stride = width * nch
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG IDAT: {e}") from e
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG IDAT shorter than the image")
    src = np.frombuffer(raw, np.uint8, count=height * (stride + 1))
    out = np.empty(height * stride, np.uint8)
    bad = _unfilter_lib().png_unfilter(src.ctypes.data, out.ctypes.data,
                                       height, stride, nch)
    if bad:
        raise ValueError(f"bad PNG filter type in row {bad - 1}")
    px = out.reshape(height, width, nch)
    rgba = np.empty((height, width, 4), np.uint8)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        lut = np.zeros((256, 4), np.uint8)
        lut[:len(palette), :3] = palette
        lut[:, 3] = alpha
        return lut[px[..., 0]]
    if color in (0, 4):
        rgba[..., :3] = px[..., :1]
        rgba[..., 3] = px[..., 1] if color == 4 else 255
        if color == 0 and trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            rgba[..., 3] = np.where(px[..., 0] == key, 0, 255)
        return rgba
    rgba[..., :3] = px[..., :3]
    rgba[..., 3] = px[..., 3] if color == 6 else 255
    if color == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        rgba[..., 3] = np.where((px[..., :3] == key).all(-1), 0, 255)
    return rgba


def load_png(path: str) -> np.ndarray:
    """PNG file -> u8[H, W, 4]."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def save_png(path: str, img: np.ndarray) -> None:
    """Accepts f32[3, H, W] (converted via to_u8) or ready u8[H, W, 3|4]
    (the render graph's ``color_u8`` output).  Unfiltered 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, c = img.shape
    color = {3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
