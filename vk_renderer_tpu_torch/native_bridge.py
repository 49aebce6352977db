"""ctypes bridge to the native C++ texture pipeline (native/texops.cpp).

Port of vk_renderer_tpu/native_bridge.py.  The repository's
``native/texops.cpp`` is built unedited at first use with
``g++ -O2 -shared -fPIC`` into the package's ignored ``build/``
directory (utils/build.py; nothing is written into ``native/``) and
loaded with ctypes.  It is an opt-in host-side speed path for scene
loading (``SceneBuilder(native_textures=True)``); each entry point
returns None when the library is unavailable (no compiler or no
source), and the callers then take the NumPy forms of
scene/textures.py.  The two do not give the same bytes: the C++ decode
multiplies by 1/255 where NumPy divides (<= 1 ulp) and its blit lerps
where NumPy weights four corners (<= 2^-22), so a stored u8 or
8-bit-quantised texel can differ by one (one of the Sponza replica's
12,670,272 texels).  The heap builders therefore keep the NumPy forms
unless asked.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .utils.build import PKG_DIR, load_library

NATIVE_DIR = PKG_DIR.parent / "native"
COMMAND = ["g++", "-O2", "-shared", "-fPIC"]


@functools.cache
def _load():
    if not (NATIVE_DIR / "texops.cpp").exists():
        return None
    try:
        lib = load_library("texops.cpp", COMMAND, NATIVE_DIR)
    except (OSError, RuntimeError):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.decode_rgba8.argtypes = [ctypes.POINTER(ctypes.c_uint8), f32p,
                                 ctypes.c_int64, ctypes.c_int]
    lib.decode_rgba8.restype = None
    lib.blit_resize_bilinear.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                         f32p, ctypes.c_int, ctypes.c_int]
    lib.blit_resize_bilinear.restype = None
    lib.generate_mips.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int]
    lib.generate_mips.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_rgba8(rgba_u8: np.ndarray, srgb: bool) -> np.ndarray | None:
    """u8[H, W, 4] -> f32[H, W, 4] (sRGB decode on RGB when requested)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(rgba_u8, dtype=np.uint8)
    dst = np.empty(src.shape, dtype=np.float32)
    lib.decode_rgba8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     _f32p(dst), src.shape[0] * src.shape[1], int(srgb))
    return dst


def blit_resize_bilinear(img: np.ndarray, dst_w: int,
                         dst_h: int) -> np.ndarray | None:
    """f32[H, W, 4] -> f32[dst_h, dst_w, 4], the vkCmdBlitImage linear
    rule (scene/textures.blit_resize_bilinear)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(img, dtype=np.float32)
    h, w = src.shape[:2]
    dst = np.empty((dst_h, dst_w, 4), dtype=np.float32)
    lib.blit_resize_bilinear(_f32p(src), w, h, _f32p(dst), dst_w, dst_h)
    return dst


def generate_mips(level0: np.ndarray) -> list[np.ndarray] | None:
    """f32[H, W, 4] -> list of mip levels (blit-chain semantics)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(level0, dtype=np.float32)
    h, w = src.shape[:2]
    n_levels = int(np.floor(np.log2(max(w, h)))) + 1
    sizes = []
    pw, ph = w, h
    for _ in range(n_levels):
        sizes.append((pw, ph))
        pw, ph = max(pw // 2, 1), max(ph // 2, 1)
    out = np.empty((sum(a * b for a, b in sizes) * 4,), dtype=np.float32)
    offsets = np.empty((n_levels,), dtype=np.int64)
    got = lib.generate_mips(_f32p(src), w, h, _f32p(out),
                            offsets.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_int64)), n_levels)
    mips = []
    for m in range(got):
        mw, mh = sizes[m]
        start = int(offsets[m]) * 4
        mips.append(out[start:start + mw * mh * 4].reshape(mh, mw, 4).copy())
    return mips
