"""The masked pass's resolve: one k-buffer round's layers walked front to
back per pixel, each winner alpha-tested (mesh_pbr.frag:192-193).

``masked_resolve`` takes a round's layers (``d`` f32 / ``i`` i32
``[K, G, th, tw]``, nearest first, id -1 where a layer is empty) and the
pass's state (depth, triangle id, pending, deepest rejected depth; each
``[G, th, tw]``) and, for every tile pixel still pending, walks its
first ``n_walk`` layers as the JAX frame's accept does (frame.py:579-777):

    dom      = pending & (lt >= 0)
    acc      = dom & (trilinear albedo alpha of lt at the pixel centre
                      >= 0.5)
    depth    = acc ? ld : depth;   tid = acc ? lt : tid
    pending  = dom & ~acc;         deepest = dom ? ld : deepest

A round that ends the pass (``probe``) also counts the pending pixels
that its extra last layer still covers (the peel overflow).  In round 0
``pending`` and ``deepest`` are None: every pixel inside the
``width`` x ``height`` frame is pending and ``deepest`` is 0.

For CUDA tensors it launches ``masked_resolve_kernel`` (csrc/masked.cu,
one thread per tile pixel, one launch a round; counted in
``masked_resolve.launches``); for CPU tensors it runs the plain version,
``masked_resolve_plain``: per layer a ``nonzero`` of the accept domain,
the alpha of its pixels (``winner_alpha``, the interpolation and
trilinear sample of ops/interp.py and ops/texture.py) and a scatter
back.  The kernel mirrors that arithmetic operation for operation, the
default sampler's and, for textures with ``has_custom_samplers``, the
per-sampler path's, so the two agree bit for bit.  The kernel replaces
no ``pl.pallas_call``: the JAX package does this work with XLA gathers
over 32-pixel cell ladders (frame.py:579-777).

``tested`` (an i64 scalar on the layers' device, or None) receives the
number of pixels alpha-tested, the pixels the ``nonzero``s select: the
frame passes ``tracing.device_counter("masked.alpha_px", ...)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..scene.types import MAX_MIPS
from . import interp
from . import texture as tex
from .common import to_tiles


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def uv_columns(scene) -> tuple[int, int]:
    """The UV channels of the frame's vattr rows (frame._build_vertex_rows:
    nx ny nz u v wx wy wz, or nx ny nz cr cg cb u v with vertex
    colours)."""
    return (3, 4) if scene.colors is None else (6, 7)


def winner_alpha(scene, tid, rows, vattr, px, py):
    """Trilinear albedo-alpha of the given triangle at the given pixel
    centers (the mesh_pbr.frag:192-193 discard operand) — narrow-row
    path (frame.py:396-404)."""
    weights = interp.interpolation_weights_rows(tid, rows[0], rows[1],
                                                px, py)
    corners = interp.gather_corners(vattr, weights["vidx"])
    (u, dudx, dudy), (v, dvdx, dvdy) = interp.derivs_from_corners(
        corners, uv_columns(scene), weights)
    aid = scene.mat_tex_ids[:, 0][weights["mat_id"].long()]
    (alpha,) = tex.sample_trilinear(scene.textures, aid, u, v,
                                    dudx, dvdx, dudy, dvdy, channels=(3,))
    return alpha


def _tile_geometry(n_tile: int, th: int, tw: int, cols: int, width: int,
                   height: int, dev):
    """The frame-extent mask and the absolute pixel centres (flat) of
    every tile pixel."""
    rows_t = n_tile // cols
    valid_t = to_tiles(torch.ones((height, width), dtype=torch.bool,
                                  device=dev), rows_t, cols, th, tw, False)
    g = torch.arange(n_tile, device=dev)[:, None, None]
    yy = torch.arange(th, device=dev)[None, :, None]
    xx = torch.arange(tw, device=dev)[None, None, :]
    px_t = ((g % cols) * tw + xx).expand(n_tile, th, tw) \
        .to(torch.float32).reshape(-1) + 0.5
    py_t = ((g // cols) * th + yy).expand(n_tile, th, tw) \
        .to(torch.float32).reshape(-1) + 0.5
    return valid_t, px_t, py_t


def masked_resolve_plain(d, i, n_walk: int, probe: bool, state, scene,
                         rows, vattr, cols: int, width: int, height: int,
                         tested=None):
    """Plain PyTorch version of ``masked_resolve``: the layers one at a
    time, the alpha test on each layer's (pending, found) pixels only.
    Returns ((depth, tid, pending, deepest), probe count i32 scalar or
    None)."""
    _, n_tile, th, tw = d.shape
    dev = d.device
    depth_t, tid_t, pending, deepest = state
    valid_t, px_t, py_t = _tile_geometry(n_tile, th, tw, cols, width,
                                         height, dev)
    if pending is None:
        pending = valid_t
    if deepest is None:
        deepest = torch.zeros((n_tile, th, tw), dtype=torch.float32,
                              device=dev)

    def accept(lt, dom):
        sel = torch.nonzero(dom.reshape(-1)).squeeze(1)
        if tested is not None:
            tested.add_(sel.numel())
        acc = torch.zeros(dom.numel(), dtype=torch.bool, device=dev)
        if sel.numel():
            alpha = winner_alpha(scene, lt.reshape(-1)[sel], rows, vattr,
                                 px_t[sel], py_t[sel])
            acc[sel] = alpha >= 0.5
        return acc.reshape(dom.shape)

    for k in range(n_walk):
        ld, lt = d[k], i[k]
        dom = pending & (lt >= 0)
        acc = accept(lt, dom)
        depth_t = torch.where(acc, ld, depth_t)
        tid_t = torch.where(acc, lt, tid_t)
        pending = dom & ~acc
        deepest = torch.where(dom, ld, deepest)
    p = (pending & (i[-1] >= 0)).sum(dtype=torch.int32) if probe else None
    return (depth_t, tid_t, pending, deepest), p


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from ..utils.build import load_library
    from .raster_kernels import nvcc_command
    lib = load_library("masked.cu", nvcc_command())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vkr_masked_resolve.restype = i
    lib.vkr_masked_resolve.argtypes = (
        [p, p, i, i, i]              # layers, n_layers, n_walk, probe
        + [p] * 8                    # state in (4), state out (4)
        + [i] * 6                    # n_tiles, tile_h, tile_w, cols, w, h
        + [p, p, p, i, i, p]         # row1, row2, vattr, u, v, mat_tex
        + [p] * 5 + [i, i]           # texture heap, max_mips, general
        + [p, p, p])                 # probe count, tested, stream
    return lib


def build_kernels() -> str:
    """Build (or find) and load the CUDA library; returns its path."""
    from ..utils.build import build_library
    from .raster_kernels import nvcc_command
    _lib()
    return str(build_library("masked.cu", nvcc_command()))


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def masked_resolve(d: torch.Tensor, i: torch.Tensor, n_walk: int,
                   probe: bool, state, scene, rows, vattr, cols: int,
                   width: int, height: int, tested=None):
    """One round's resolve (module docstring): the layers ``d``/``i``
    ``[K, G, th, tw]``, the first ``n_walk`` of them walked, the last one
    the probe when ``probe``; ``state`` = (depth f32, tid i32, pending
    bool or None, deepest f32 or None) ``[G, th, tw]``; ``rows`` the
    frame's two [T+1, 8] triangle row tables, ``vattr`` its [V, 8]
    vertex rows; ``cols`` tiles per tile row of the ``width`` x
    ``height`` frame.  Returns ((depth, tid, pending, deepest), the
    probe count as an i32 scalar, or None without ``probe``)."""
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the masked resolve runs on cpu or cuda, not "
                         f"{d.device}")
    if d.device.type == "cpu":
        return masked_resolve_plain(d, i, n_walk, probe, state, scene,
                                    rows, vattr, cols, width, height,
                                    tested)
    dev = d.device
    if d.dim() != 4:
        raise ValueError(f"d: shape {tuple(d.shape)}, expected "
                         f"[K, G, th, tw]")
    k_layers, n_tile, th, tw = d.shape
    plane = (n_tile, th, tw)
    _check("d", d, torch.float32, None, dev)
    _check("i", i, torch.int32, d.shape, dev)
    if not 1 <= n_walk <= k_layers:
        raise ValueError(f"n_walk={n_walk} outside 1..{k_layers}")
    if d.numel() >= 1 << 31:
        raise ValueError(f"{tuple(d.shape)}: the kernel indexes the layers "
                         f"with 32-bit products")
    if n_tile % cols or not (0 < width <= cols * tw
                             and 0 < height <= (n_tile // cols) * th):
        raise ValueError(f"{n_tile} tiles of {th}x{tw} in {cols} columns "
                         f"do not hold a {width}x{height} frame")
    depth_t, tid_t, pending, deepest = state
    _check("depth", depth_t, torch.float32, plane, dev)
    _check("tid", tid_t, torch.int32, plane, dev)
    if pending is not None:
        _check("pending", pending, torch.bool, plane, dev)
    if deepest is not None:
        _check("deepest", deepest, torch.float32, plane, dev)
    row1, row2 = rows
    for name, t in (("row1", row1), ("row2", row2)):
        _check(name, t, torch.float32, (row1.shape[0], 8), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's row loads need a "
                             f"16-byte aligned start")
    _check("vattr", vattr, torch.float32, (vattr.shape[0], 8), dev)
    mat_tex = scene.mat_tex_ids
    _check("mat_tex_ids", mat_tex, torch.int32, (mat_tex.shape[0], 3), dev)
    texs = scene.textures
    n_tex = texs.n_mips.shape[0]
    _check("texels", texs.texels, torch.int32, (texs.texels.shape[0],),
           dev)
    _check("mip_offsets", texs.mip_offsets, torch.int32, (n_tex, MAX_MIPS),
           dev)
    _check("mip_sizes", texs.mip_sizes, torch.int32, (n_tex, MAX_MIPS, 2),
           dev)
    _check("n_mips", texs.n_mips, torch.int32, (n_tex,), dev)
    _check("sampler_modes", texs.sampler_modes, torch.int32, (n_tex,), dev)
    if tested is not None:
        _check("tested", tested, torch.int64, (), dev)
    u_col, v_col = uv_columns(scene)

    out_d = torch.empty(plane, dtype=torch.float32, device=dev)
    out_i = torch.empty(plane, dtype=torch.int32, device=dev)
    out_p = torch.empty(plane, dtype=torch.bool, device=dev)
    out_deep = torch.empty(plane, dtype=torch.float32, device=dev)
    count = (torch.zeros((), dtype=torch.int32, device=dev) if probe
             else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().vkr_masked_resolve(
            _ptr(d), _ptr(i), k_layers, n_walk, int(probe),
            _ptr(depth_t), _ptr(tid_t), _ptr(pending), _ptr(deepest),
            _ptr(out_d), _ptr(out_i), _ptr(out_p), _ptr(out_deep),
            n_tile, th, tw, cols, width, height,
            _ptr(row1), _ptr(row2), _ptr(vattr), u_col, v_col,
            _ptr(mat_tex), _ptr(texs.texels), _ptr(texs.mip_offsets),
            _ptr(texs.mip_sizes), _ptr(texs.n_mips),
            _ptr(texs.sampler_modes), MAX_MIPS,
            int(bool(texs.has_custom_samplers)), _ptr(count), _ptr(tested),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"masked resolve kernel launch failed: CUDA "
                           f"error {err}")
    _RESOLVE.launches += 1
    return (out_d, out_i, out_p, out_deep), count


masked_resolve.launches = 0
# the counter lives on this function object even while a caller has
# rebound the module attribute
_RESOLVE = masked_resolve
