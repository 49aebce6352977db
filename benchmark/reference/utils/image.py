"""Host-side image utilities: framebuffer readback, PNG I/O, PSNR.

The reference blits its RGBA16F draw image to a BGRA8-unorm swapchain
(src/vk_engine_run.cpp:159-161, format at src/vk_engine.cpp:47-51) — a plain
format conversion with clamping, no colorspace math.  ``to_u8`` replicates
that: clamp to [0,1] and quantize.  PSNR is the integration-gate metric from
BASELINE.md (>=40 dB vs reference framebuffers).

PNG is decoded and encoded here without an imaging library: zlib from the
standard library inflates/deflates, and the row unfilter runs in NumPy
along the image's anti-diagonals (``_unfilter``): a pixel depends only on
its left, upper and upper-left neighbours, so every pixel of one
anti-diagonal can be reconstructed at once.
"""

from __future__ import annotations

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


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode — what R8G8B8A8_SRGB sampling does in hardware
    before filtering (textures created at src/vk_loader.cpp:283,296)."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.power(np.maximum(c, 1e-12), 1 / 2.4) - 0.055).astype(np.float32)


def _unfilter(rows: np.ndarray, width: int, nch: int) -> np.ndarray:
    """Undo the PNG row filters (PNG spec 9.2-9.4) of u8[H, 1 + W * nch]
    rows (filter byte first) -> u8[H, W, nch].  Pixel (y, x) needs the
    reconstructed (y, x-1), (y-1, x) and (y-1, x-1), all on earlier
    anti-diagonals y + x, so each anti-diagonal is one vector step."""
    height = rows.shape[0]
    ftype = rows[:, 0].astype(np.int16)
    if ftype.size and int(ftype.max()) > 4:
        bad = int(np.argmax(ftype > 4))
        raise ValueError(f"bad PNG filter type in row {bad}")
    filt = rows[:, 1:].reshape(height, width, nch).astype(np.int16)
    rec = np.zeros((height + 1, width + 1, nch), np.int16)  # zero border
    for d in range(height + width - 1):
        y = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        x = d - y
        a = rec[y + 1, x]             # left
        b = rec[y, x + 1]             # up
        c = rec[y, x]                 # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y][:, None].clip(0, 4),
                         [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        rec[y + 1, x + 1] = (filt[y, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


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
    px = _unfilter(src.reshape(height, stride + 1), width, nch)
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


