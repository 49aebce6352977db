"""Post/background: gradient clear and Reinhard tonemap.

Counterpart of vk_renderer_tpu/ops/post.py, which replaces the reference's
two compute shaders:
- shaders/gradient_color.comp:16-31 — vertical ``mix(top, bottom, y/H)``,
- shaders/tonemap.comp:9-22 — Reinhard ``c/(c+1)`` then ``x^(1/2.2)``.

Its two Pallas kernels become hand-written CUDA kernels for Hopper
(csrc/post.cu), behind the same dispatchers the JAX package has:

- ``tonemap`` replaces ``_tonemap_kernel`` (post.py:101, ``pl.pallas_call``
  at :112); its plain version is ``tonemap_plain``,
- ``gradient`` replaces ``_gradient_kernel`` (post.py:47, ``pl.pallas_call``
  at :73); its plain version is ``gradient_plain``.

Each dispatcher launches its kernel for CUDA tensors (and counts the launch
in its ``launches`` attribute) and runs its plain version for CPU tensors;
any other device raises.  The XLA forms (``tonemap_xla``'s ``pow``,
``gradient_xla``'s divide) stay as the JAX package's references.  Images
are planar ``f32[3, H, W]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

INV_GAMMA = 1.0 / 2.2  # tonemap.comp:18


def gradient_xla(h: int, w: int, top: torch.Tensor, bottom: torch.Tensor,
                 extent_h: int | None = None) -> torch.Tensor:
    """Vertical gradient image, f32[3, h, w]; ``blend = y / extent_h``
    (gradient_color.comp:27 divides by the full image height, not
    height-1).  ``extent_h`` defaults to ``h`` — pass the unpadded height
    when the framebuffer is padded."""
    extent_h = h if extent_h is None else extent_h
    blend = (torch.arange(h, dtype=torch.float32, device=top.device)
             / extent_h)[None, :, None]
    top = top[:3].to(torch.float32).reshape(3, 1, 1)
    bottom = bottom[:3].to(torch.float32).reshape(3, 1, 1)
    return (top * (1.0 - blend) + bottom * blend).expand(3, h, w)


def tonemap_xla(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma 2.2 (tonemap.comp:16-19), the pow form."""
    mapped = color / (color + 1.0)
    return torch.pow(mapped, INV_GAMMA)


def gradient_plain(h: int, w: int, top: torch.Tensor, bottom: torch.Tensor,
                   extent_h: int | None = None,
                   row0: int = 0) -> torch.Tensor:
    """Plain version of ``gradient``: the kernel's own form
    ``top * (1 - y * inv_h) + bottom * (y * inv_h)`` with
    ``inv_h = f32(1 / extent_h)`` (post.py:53-58 multiplies by the
    reciprocal where gradient_xla divides) and ``y`` the frame row,
    ``row0`` plus the image row.  Returns a contiguous f32[3, h, w]."""
    extent_h = h if extent_h is None else extent_h
    inv_h = torch.tensor(1.0 / extent_h, dtype=torch.float32)
    blend = (torch.arange(row0, row0 + h, dtype=torch.float32,
                          device=top.device) * inv_h)[None, :, None]
    top = top[:3].to(torch.float32).reshape(3, 1, 1)
    bottom = bottom[:3].to(torch.float32).reshape(3, 1, 1)
    return (top * (1.0 - blend) + bottom * blend).expand(3, h, w) \
        .contiguous()


def tonemap_plain(color: torch.Tensor) -> torch.Tensor:
    """Plain version of ``tonemap``: the kernel's own form
    ``exp(log(c / (c + 1)) * INV_GAMMA)`` (post.py:102-104), which differs
    from tonemap_xla's pow by up to ~4e-5.  Zero maps to 0."""
    mapped = color / (color + 1.0)
    return torch.exp(torch.log(mapped) * INV_GAMMA)


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from ..utils.build import load_library
    from .raster_kernels import nvcc_command
    lib = load_library("post.cu", nvcc_command())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vkr_tonemap.restype = i
    lib.vkr_tonemap.argtypes = [p, p, ctypes.c_int64, p]
    lib.vkr_gradient.restype = i
    lib.vkr_gradient.argtypes = [p, p, ctypes.c_float, p, i, i, i, p]
    return lib


def build_kernels() -> str:
    """Build (or find) and load the CUDA library; returns its path."""
    from ..utils.build import build_library
    from .raster_kernels import nvcc_command
    _lib()
    return str(build_library("post.cu", nvcc_command()))


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"post kernels run on cpu or cuda, not {t.device}")
    return t.device.type == "cpu"


def _check_f32(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# kernel 3: tonemap (post.py::_tonemap_kernel)
# ---------------------------------------------------------------------------

def tonemap(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma 2.2 of a planar f32[3, H, W] image (any shape on
    the card: the kernel is elementwise)."""
    if _on_cpu(color):
        return tonemap_plain(color)
    _check_f32("color", color, color.device)
    out = torch.empty_like(color)
    with torch.cuda.device(color.device):
        err = _lib().vkr_tonemap(ctypes.c_void_p(color.data_ptr()),
                                 ctypes.c_void_p(out.data_ptr()),
                                 color.numel(), _stream(color.device))
    _raise_on(err, "tonemap")
    _TONEMAP.launches += 1
    return out


tonemap.launches = 0
# the counter lives on this function object even while a caller has
# rebound the module attribute (chip_smoke.py records calls that way)
_TONEMAP = tonemap


# ---------------------------------------------------------------------------
# kernel 4: gradient (post.py::_gradient_kernel)
# ---------------------------------------------------------------------------

def gradient(h: int, w: int, top: torch.Tensor, bottom: torch.Tensor,
             extent_h: int | None = None, row0: int = 0) -> torch.Tensor:
    """Vertical gradient image f32[3, h, w] from the rgb of ``top`` and
    ``bottom`` (f32[>=3], the settings' colours): rows ``row0`` to
    ``row0 + h`` of an ``extent_h``-tall gradient (a frame's strip; the
    single frame has ``row0 = 0``).  On the card the kernel reads both
    colours from device memory — no host round trip per frame."""
    if _on_cpu(top):
        return gradient_plain(h, w, top, bottom, extent_h, row0)
    extent_h = h if extent_h is None else extent_h
    dev = top.device
    for name, t in (("top", top), ("bottom", bottom)):
        _check_f32(name, t, dev)
        if t.dim() != 1 or t.shape[0] < 3:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(>=3,)")
    if 3 * h * w >= 1 << 31:
        raise ValueError(f"{h}x{w}: the gradient kernel indexes 3*h*w "
                         f"outputs with 32-bit ints")
    if not 0 <= row0 <= (1 << 24) - h:
        raise ValueError(f"row0={row0}: the kernel's rows are exact f32 "
                         f"integers below 2^24")
    out = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().vkr_gradient(ctypes.c_void_p(top.data_ptr()),
                                  ctypes.c_void_p(bottom.data_ptr()),
                                  1.0 / extent_h,
                                  ctypes.c_void_p(out.data_ptr()), h, w,
                                  row0, _stream(dev))
    _raise_on(err, "gradient")
    _GRADIENT.launches += 1
    return out


gradient.launches = 0
_GRADIENT = gradient
