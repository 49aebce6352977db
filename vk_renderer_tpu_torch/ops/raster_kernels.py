"""The raster kernels: records, CUDA wrappers and their plain versions.

Counterpart of vk_renderer_tpu/ops/raster_pallas.py.  Its two Pallas
kernels become hand-written CUDA kernels for Hopper (csrc/raster.cu):

- ``rasterize_depth_grid`` replaces ``_kernel`` (raster_pallas.py:50,
  ``pl.pallas_call`` at :409): depth + triangle-id raster of each 128x32
  tile over its occupancy-packed record stream,
- ``rasterize_layers_grid`` replaces ``_kernel_k`` (raster_pallas.py:147,
  ``pl.pallas_call`` at :509): the k-buffer over an explicit tile list.

Each wrapper launches its kernel for CUDA tensors (and counts the launch
in its ``launches`` attribute) and runs its plain PyTorch version for CPU
tensors; any other device raises.  The plain versions consume the same
records with the same semantics and are chunked over tiles and records so
they fit at 1080p and at 2048^2:

- coverage: all three edges pass the top-left rule
  ``(e > 0) | (e == 0 & top_left)``, ``e0 + e1 + e2 > 0`` (interpolated
  1/w > 0) and the near clip ``z >= 0`` — the explicit forms of the
  Pallas kernels' FTZ-dependent ``> -FLT_MIN`` compares,
- a record only touches the 8-row sub-blocks inside its row range,
- ``_kernel``: LEQUAL z-test, the later record wins a tie,
- ``_kernel_k``: ``z <= bound`` (and ``z > floor``); a tie replaces the
  layer, a strictly nearer fragment shifts the deeper layers down; empty
  layers are (2.0, sentinel).

The CUDA kernels cull (record, pixel footprint) pairs exactly and cut the
heaviest tiles' streams into segments whose results they merge exactly;
``footprint_may_cover``, ``merge_depth_segments`` and
``merge_layer_segments`` at the end of this module are the plain mirrors
of those rules, which the CPU tests hold against the plain versions.
The frame's CPU depth raster, ``rasterize_depth_grid_culled``, applies the
same footprint cull to the plain walk (bit-equal to the unculled plain
version, which stays the kernel's reference).

The CUDA library builds at first use (nvcc, sm_90a) into the package's
ignored build directory and loads with ctypes; nothing CUDA-specific runs
at import.
"""

from __future__ import annotations

import ctypes
import functools
import shutil

import torch
import torch.nn.functional as F

from .common import from_tiles, to_tiles

F_FIELDS = 16   # a,b,k x3 edges | a,b,k z | tri*8+tl_bits | rowrange | pad x2
MAX_TRI = 1 << 21          # tri*8 + tl bits must stay exact in f32 (< 2^24)
CHUNK = 64                 # records per staged chunk (one 4 KB row)
KERNEL_TILE_W = 128
# the plain versions evaluate at most this many (record x pixel) values at
# once, which bounds their memory at 1080p and at 2048^2
PLAIN_ELEMS = 1 << 24


def build_records(setup_padded: dict, bbox, rec_tri: torch.Tensor,
                  rec_tile: torch.Tensor, cols: int, tile_w: int,
                  tile_h: int) -> torch.Tensor:
    """Gather + tile-fold the per-slot triangle records
    (raster_pallas.py:284-351, bit for bit).

    setup_padded: planar setup with the zero sentinel row (raster.pad_setup)
    bbox: the UNPADDED planar bbox from triangle_setup (y0/y1 used)
    rec_tri/rec_tile: from binning.bin_buckets_packed
    Planes [T] with rec_tri [S] give f32[rec_cap, (CHUNK*F_FIELDS)//128,
    128]; planes [L, T] with rec_tri [L, S] give L views' records at once,
    f32[L, rec_cap, ...], each slot carrying its view-local triangle id
    and folded against its view-local tile origin."""
    e = setup_padded["edge"]
    zl = setup_padded["zlin"]
    anc = setup_padded["anchor"]
    f32 = torch.float32
    n_pad = e[0].shape[-1]
    if n_pad - 1 > MAX_TRI:
        raise ValueError(f"{n_pad - 1} triangles exceed the records' "
                         f"packed-id range ({MAX_TRI})")
    idx = rec_tri.long()

    def g(plane):
        return torch.gather(plane, -1, idx)

    a0, b0, c0 = g(e[0]), g(e[1]), g(e[2])
    a1, b1, c1 = g(e[3]), g(e[4]), g(e[5])
    a2, b2, c2 = g(e[6]), g(e[7]), g(e[8])
    za, zbp, zc = g(zl[0]), g(zl[1]), g(zl[2])
    ax, ay = g(anc[0]), g(anc[1])
    y0, y1 = g(F.pad(bbox[1], (0, 1))), g(F.pad(bbox[3], (0, 1)))

    slot_tile = rec_tile[..., None].expand(*rec_tile.shape, CHUNK).reshape(
        idx.shape)
    ty0i = (slot_tile // cols) * tile_h
    tx0 = ((slot_tile % cols) * tile_w).to(f32)
    ty0 = ty0i.to(f32)

    ox = tx0 - ax
    oy = ty0 - ay
    k0 = c0 + a0 * ox + b0 * oy
    k1 = c1 + a1 * ox + b1 * oy
    k2 = c2 + a2 * ox + b2 * oy
    kz = zc + za * ox + zbp * oy

    def tl(a, b):
        return ((a > 0.0) | ((a == 0.0) & (b > 0.0))).to(f32)

    bits = tl(a0, b0) + 2.0 * tl(a1, b1) + 4.0 * tl(a2, b2)
    f12 = rec_tri.to(f32) * 8.0 + bits

    r0 = torch.clamp(torch.floor(y0).to(torch.int32) - ty0i, 0, tile_h)
    r1 = torch.clamp(torch.ceil(y1).to(torch.int32) - ty0i, 0, tile_h)
    f13 = (r0 * 256 + r1).to(f32)

    pad = torch.zeros_like(k0)
    rec = torch.stack([a0, b0, k0, a1, b1, k1, a2, b2, k2, za, zbp, kz,
                       f12, f13, pad, pad], dim=-1)
    return rec.reshape(*idx.shape[:-1], -1, (CHUNK * F_FIELDS) // 128, 128)


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

def nvcc_command() -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    # --fmad=false: plane evaluation must round like the plain versions
    # (the source also spells the order with __fmul_rn/__fadd_rn);
    # never --use_fast_math (it enables flush-to-zero)
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
            "-std=c++17", "--fmad=false", "-Xptxas", "-v", "-shared",
            "-Xcompiler", "-fPIC"]


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..utils.build import load_library
    lib = load_library("raster.cu", nvcc_command())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vkr_raster_depth.restype = i
    lib.vkr_raster_depth.argtypes = [p, p, p, p, p, p, p, p, i, i, p, p, p]
    lib.vkr_raster_layers.restype = i
    lib.vkr_raster_layers.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, p,
                                      p]
    lib.vkr_raster_workspace.restype = ctypes.c_longlong
    lib.vkr_raster_workspace.argtypes = [i, i, i]
    lib.vkr_max_layers.restype = i
    lib.vkr_raster_blocks.restype = i
    lib.vkr_raster_blocks.argtypes = [i, i, i]
    return lib


def build_kernels() -> str:
    """Build (or find) and load the CUDA library; returns its path."""
    from ..utils.build import build_library
    _lib()
    return str(build_library("raster.cu", nvcc_command()))


def _ptr(t: torch.Tensor | None):
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_stream_args(records, rec_start, counts, tile_w, tile_h):
    if tile_w != KERNEL_TILE_W or tile_h % 8:
        raise ValueError(f"the CUDA raster kernels take 128-wide tiles of "
                         f"a multiple of 8 rows (got {tile_w}x{tile_h})")
    dev = records.device
    n = rec_start.shape[0]
    _check("records", records, torch.float32,
           (records.shape[0], (CHUNK * F_FIELDS) // 128, 128), dev)
    _check("rec_start", rec_start, torch.int32, (n,), dev)
    _check("counts", counts, torch.int32, (n,), dev)
    if records.data_ptr() % 16:
        raise ValueError("records: the kernels' bulk copies need a 16-byte "
                         "aligned start")
    return dev, n


def _workspace(lib, n_tiles: int, tile_h: int, k_layers: int, dev):
    """The kernels' scratch: the segment plan of the heavy tiles and the
    partial results of their segments (k_layers = 0: the depth raster).
    Dropping it after the launch is safe: the caching allocator hands the
    memory only to work queued after the kernel on the same stream."""
    return torch.empty(lib.vkr_raster_workspace(n_tiles, tile_h, k_layers),
                       dtype=torch.uint8, device=dev)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster kernels run on cpu or cuda, not "
                         f"{t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# kernel 1: depth + id raster (raster_pallas.py::_kernel)
# ---------------------------------------------------------------------------

def rasterize_depth_grid(records: torch.Tensor, rec_start: torch.Tensor,
                         counts: torch.Tensor, init_d: torch.Tensor,
                         init_i: torch.Tensor,
                         floor_t: torch.Tensor | None = None,
                         tile_w: int = 128, tile_h: int = 32):
    """Depth raster over an explicit tile list: ``rec_start``/``counts``
    i32[G], ``init_d`` f32 / ``init_i`` i32 [G, th, tw] (the z-buffer's
    starting state; empty = sentinel id), optional ``floor_t`` f32
    [G, th, tw] (coverage additionally needs z > floor).  Returns
    (depth f32, id i32) [G, th, tw]."""
    if _device_kind(records) == "cpu":
        return rasterize_depth_grid_plain(records, rec_start, counts, init_d,
                                          init_i, floor_t, tile_w=tile_w,
                                          tile_h=tile_h)
    out = _launch_depth(records, rec_start, counts, init_d, init_i, floor_t,
                        tile_w, tile_h, None)
    if counts.shape[0]:
        _DEPTH_WRAPPER.launches += 1
    return out


def _launch_depth(records, rec_start, counts, init_d, init_i, floor_t,
                  tile_w, tile_h, block_ns):
    dev, n = _check_stream_args(records, rec_start, counts, tile_w, tile_h)
    shape = (n, tile_h, tile_w)
    _check("init_d", init_d, torch.float32, shape, dev)
    _check("init_i", init_i, torch.int32, shape, dev)
    if floor_t is not None:
        _check("floor_t", floor_t, torch.float32, shape, dev)
    out_d = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    if n == 0:
        return out_d, out_i
    lib = _lib()
    ws = _workspace(lib, n, tile_h, 0, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkr_raster_depth(
            _ptr(records), _ptr(rec_start), _ptr(counts), _ptr(init_d),
            _ptr(init_i), _ptr(floor_t), _ptr(out_d), _ptr(out_i), n, tile_h,
            _ptr(ws), _ptr(block_ns), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"raster depth kernel launch failed: CUDA error "
                           f"{err}")
    return out_d, out_i


rasterize_depth_grid.launches = 0
# the counter lives on this function object even while a caller has
# rebound the module attribute (chip_smoke.py records calls that way)
_DEPTH_WRAPPER = rasterize_depth_grid


def _pixel_grid(tile_h: int, tile_w: int, device):
    p = torch.arange(tile_h * tile_w, device=device)
    px = (p % tile_w).to(torch.float32) + 0.5
    row = p // tile_w
    py = row.to(torch.float32) + 0.5
    band_lo = (row // 8) * 8
    return px, py, band_lo


def _eval_records(rec: torch.Tensor, px, py, band_lo):
    """rec f32[..., 16] -> (cov, z, tri, hit) over [..., P]: coverage
    (edges, sum, near clip), depth, triangle id, and the sub-block row
    guard.  Same expressions and rounding order as csrc/raster.cu."""
    f = [rec[..., i:i + 1] for i in range(14)]
    tb = f[12].to(torch.int32)
    tri = tb >> 3
    e0 = f[0] * px + f[1] * py + f[2]
    e1 = f[3] * px + f[4] * py + f[5]
    e2 = f[6] * px + f[7] * py + f[8]
    z = f[9] * px + f[10] * py + f[11]

    def inside(e, bit):
        return (e > 0.0) | ((e == 0.0) & ((tb & bit) != 0))

    cov = (inside(e0, 1) & inside(e1, 2) & inside(e2, 4)
           & ((e0 + e1 + e2) > 0.0) & (z >= 0.0))
    rr = f[13].to(torch.int32)
    hit = ((rr & 255) > band_lo) & ((rr >> 8) < band_lo + 8)
    return cov, z, tri, hit


def _by_work(counts: torch.Tensor):
    """Tiles ordered by descending chunk count, plus the host-side chunk
    counts in that order (one transfer), so 'tiles still streaming at
    chunk k' is always a prefix."""
    nk = (counts.long() + CHUNK - 1) // CHUNK
    nk_s, order = torch.sort(nk, descending=True, stable=True)
    return order, nk_s.cpu().tolist()


def rasterize_depth_grid_plain(records, rec_start, counts, init_d, init_i,
                               floor_t=None, tile_w: int = 128,
                               tile_h: int = 32):
    """Plain PyTorch version of rasterize_depth_grid.  Per record chunk it
    evaluates all of the chunk's records at every pixel of a group of
    tiles and keeps the nearest (the LAST record among exact ties), then
    applies the LEQUAL test against the running z-buffer — equal to the
    kernel's per-record sequence.  Tiles are processed in groups of at
    most PLAIN_ELEMS (record x pixel) values at a time."""
    g_tiles = counts.shape[0]
    p = tile_h * tile_w
    zbuf = init_d.reshape(g_tiles, p).clone()
    ibuf = init_i.reshape(g_tiles, p).clone()
    flo = floor_t.reshape(g_tiles, p) if floor_t is not None else None
    _depth_walk(records.reshape(records.shape[0], CHUNK, F_FIELDS),
                rec_start, counts, zbuf, ibuf, flo,
                _pixel_grid(tile_h, tile_w, records.device))
    return (zbuf.reshape(g_tiles, tile_h, tile_w),
            ibuf.reshape(g_tiles, tile_h, tile_w))


def _depth_walk(rec, rec_start, counts, zbuf, ibuf, flo, grid):
    """The depth raster's chunk walk, in place on zbuf / ibuf [G, P]:
    ``rec`` f32[chunks, CHUNK, 16], ``grid`` the (px, py, band_lo) pixel
    tensors, each [P] (shared by every tile) or [G, P] (one row each)."""
    dev = zbuf.device
    p = zbuf.shape[1]
    order, nk_s = _by_work(counts)
    start_s = rec_start.long()[order]
    group = max(1, PLAIN_ELEMS // (CHUNK * p))
    inf = torch.tensor(float("inf"), device=dev)
    two = torch.tensor(2.0, device=dev)
    n_active = len(nk_s)
    for k in range(nk_s[0] if nk_s else 0):
        while n_active and nk_s[n_active - 1] <= k:
            n_active -= 1
        for g0 in range(0, n_active, group):
            tiles = order[g0:min(g0 + group, n_active)]
            r = rec[start_s[g0:g0 + tiles.shape[0]] + k]      # [g, C, 16]
            px, py, band_lo = (t if t.dim() == 1 else t[tiles][:, None, :]
                               for t in grid)
            cov, z, tri, hit = _eval_records(r, px, py, band_lo)
            if flo is not None:
                cov = cov & (z > flo[tiles][:, None, :])
            zc = torch.where(hit, torch.where(cov, z, two), inf)  # [g,C,P]
            best, _ = zc.min(dim=1)
            last = CHUNK - 1 - torch.argmin(zc.flip(1), dim=1)     # [g, P]
            win = torch.gather(tri[..., 0], 1, last)
            zb = zbuf[tiles]
            take = best <= zb
            zbuf[tiles] = torch.where(take, best, zb)
            ibuf[tiles] = torch.where(take, win, ibuf[tiles])


def rasterize_depth_grid_culled(records, rec_start, counts, init_d, init_i,
                                floor_t=None, tile_w: int = 128,
                                tile_h: int = 32):
    """rasterize_depth_grid_plain with the kernel's footprint cull, for
    the CPU frame: the same result bit for bit at a fraction of the work.

    Each tile is cut into DEPTH_FOOTPRINT blocks (8 x 8 pixels, one 8-row
    band tall), and every block walks its own stream: the tile's records
    that hit the block's band and that ``footprint_may_cover`` does not
    cull, in stream order, plus the latest culled record that hits the
    band.  That one stands for all culled ones: a culled record covers no
    pixel of the block, so it offers (2.0, its id) at every pixel; the
    result is the lexicographic minimum of (depth, -stream index) over the
    init value and the offers, so of the culled offers only the latest
    can win, and it still wins against an init depth of 2.0 as the kernel
    makes it.  Records missing the band offer nothing.  The whole tile as
    the footprint culls ~3% of the records of a small shadow map; 8 x 8
    blocks take ~97% of the (record x pixel) work away.

    Tiles whose sides are not multiples of 8 take the plain version."""
    fw, fh = DEPTH_FOOTPRINT
    if tile_w % fw or tile_h % fh or not int(counts.sum()):
        return rasterize_depth_grid_plain(records, rec_start, counts, init_d,
                                          init_i, floor_t, tile_w=tile_w,
                                          tile_h=tile_h)
    dev = records.device
    g_tiles = counts.shape[0]
    nbx, nby = tile_w // fw, tile_h // fh
    n_blk = nbx * nby
    # every record slot of every tile's chunks, in stream order
    n_slots = (counts.long() + CHUNK - 1) // CHUNK * CHUNK
    tile_of = torch.repeat_interleave(torch.arange(g_tiles, device=dev),
                                      n_slots)
    local = (torch.arange(tile_of.shape[0], device=dev)
             - (torch.cumsum(n_slots, 0) - n_slots)[tile_of])
    rec = records.reshape(-1, F_FIELDS)[rec_start.long()[tile_of] * CHUNK
                                        + local]               # [S, 16]
    rr = rec[:, 13].to(torch.int32)
    r0, r1 = rr >> 8, rr & 255
    blk = torch.arange(n_blk, device=dev)
    bx0, by0 = (blk % nbx) * fw, (blk // nbx) * fh             # [B]
    units, slots = [], []
    step = max(1, PLAIN_ELEMS // (16 * n_blk))
    for s0 in range(0, rec.shape[0], step):
        sl = slice(s0, s0 + step)
        hit = (r1[sl, None] > by0) & (r0[sl, None] < by0 + fh)  # [s, B]
        may = footprint_may_cover(rec[sl, None, :], bx0, by0, fw, fh)
        unit = tile_of[sl, None] * n_blk + blk                  # [s, B]
        slot = torch.arange(s0, s0 + hit.shape[0], device=dev)[:, None]
        keep = hit & may
        units.append(unit[keep])
        slots.append(slot.expand_as(unit)[keep])
        cull = hit & ~may
        units.append(unit[cull])
        slots.append(-1 - slot.expand_as(unit)[cull])
    unit = torch.cat(units)
    slot = torch.cat(slots)
    culled = slot < 0
    # the latest culled record of each (tile, block)
    latest = torch.full((g_tiles * n_blk,), -1, dtype=torch.long, device=dev)
    latest.scatter_reduce_(0, unit[culled], -1 - slot[culled], "amax")
    has = latest >= 0
    unit = torch.cat([unit[~culled], torch.nonzero(has).squeeze(1)])
    slot = torch.cat([slot[~culled], latest[has]])
    order = torch.argsort(unit * rec.shape[0] + slot)
    unit, slot = unit[order], slot[order]
    # the blocks' streams, each padded to whole chunks with zero records
    # (an empty row range: they hit no band)
    cnt = torch.bincount(unit, minlength=g_tiles * n_blk)
    nk = (cnt + CHUNK - 1) // CHUNK
    start = torch.cumsum(nk, 0) - nk
    rank = torch.arange(unit.shape[0], device=dev) - (torch.cumsum(cnt, 0)
                                                      - cnt)[unit]
    stream = torch.zeros((int(nk.sum()) * CHUNK, F_FIELDS),
                         dtype=records.dtype, device=dev)
    stream[start[unit] * CHUNK + rank] = rec[slot]

    def blocks(t):
        # [G, th, tw] -> [G * n_blk, fh * fw], block-major
        return t.reshape(g_tiles, nby, fh, nbx, fw).permute(0, 1, 3, 2, 4) \
            .reshape(g_tiles * n_blk, fh * fw)

    zbuf = blocks(init_d).clone()
    ibuf = blocks(init_i).clone()
    flo = blocks(floor_t) if floor_t is not None else None
    q = torch.arange(fh * fw, device=dev)
    px = ((bx0[:, None] + q % fw).to(torch.float32) + 0.5).repeat(g_tiles, 1)
    py = ((by0[:, None] + q // fw).to(torch.float32) + 0.5).repeat(g_tiles, 1)
    band_lo = by0[:, None].expand(n_blk, fh * fw).repeat(g_tiles, 1)
    _depth_walk(stream.reshape(-1, CHUNK, F_FIELDS), start, cnt, zbuf, ibuf,
                flo, (px, py, band_lo))

    def tiles(t):
        return t.reshape(g_tiles, nby, nbx, fh, fw).permute(0, 1, 3, 2, 4) \
            .reshape(g_tiles, tile_h, tile_w)

    return tiles(zbuf), tiles(ibuf)


def rasterize_depth_packed(records, rec_start, counts, width: int,
                           height: int, sentinel: int, tile_w: int = 128,
                           tile_h: int = 32, init_depth=None, init_id=None,
                           floor_depth=None):
    """Raster over an occupancy-packed record stream, full framebuffer
    (raster_pallas.rasterize_depth_packed): the kernel for CUDA tensors,
    rasterize_depth_grid_culled (the same bits) for CPU tensors.
    Returns (depth f32[H, W], tri_id i32[H, W], -1 empty)."""
    rows, cols = counts.shape
    n_tiles = rows * cols
    dev = records.device
    if init_depth is None:
        initd = torch.ones((n_tiles, tile_h, tile_w), dtype=torch.float32,
                           device=dev)
        initi = torch.full((n_tiles, tile_h, tile_w), sentinel,
                           dtype=torch.int32, device=dev)
    else:
        initd = to_tiles(init_depth, rows, cols, tile_h, tile_w, 1.0)
        initi = to_tiles(torch.where(init_id < 0, sentinel, init_id),
                         rows, cols, tile_h, tile_w, sentinel)
    floor_t = None
    if floor_depth is not None:
        floor_t = to_tiles(floor_depth, rows, cols, tile_h, tile_w, 2.0)
    grid = (rasterize_depth_grid_culled if _device_kind(records) == "cpu"
            else rasterize_depth_grid)
    outd, outi = grid(
        records, rec_start, counts.reshape(-1).contiguous(),
        initd.contiguous(), initi.contiguous(), floor_t, tile_w=tile_w,
        tile_h=tile_h)
    depth = from_tiles(outd, rows, cols)
    tri_id = from_tiles(outi, rows, cols)
    tri_id = torch.where(tri_id == sentinel, -1, tri_id)
    return depth[:height, :width], tri_id[:height, :width]


# ---------------------------------------------------------------------------
# kernel 2: the k-buffer (raster_pallas.py::_kernel_k)
# ---------------------------------------------------------------------------

def rasterize_layers_grid(records: torch.Tensor, rec_start: torch.Tensor,
                          counts: torch.Tensor, bound_t: torch.Tensor,
                          floor_t: torch.Tensor | None, sentinel: int,
                          k_layers: int, tile_w: int = 128,
                          tile_h: int = 32):
    """The k-layer peel over an EXPLICIT tile list: ``rec_start``/
    ``counts`` i32[G], ``bound_t`` (``floor_t``) f32[G, th, tw].  Records'
    tile-folded coefficients are slot-independent, so slot j may be any
    tile t as long as rec_start[j]/counts[j]/bound_t[j] are tile t's.
    Returns (depth f32[K, G, th, tw], id i32[K, G, th, tw]), nearest layer
    first; (2.0, sentinel) where a layer is empty."""
    if _device_kind(records) == "cpu":
        return rasterize_layers_grid_plain(records, rec_start, counts,
                                           bound_t, floor_t, sentinel,
                                           k_layers, tile_w=tile_w,
                                           tile_h=tile_h)
    out = _launch_layers(records, rec_start, counts, bound_t, floor_t,
                         sentinel, k_layers, tile_w, tile_h, None)
    if counts.shape[0]:
        _LAYERS_WRAPPER.launches += 1
    return out


def _launch_layers(records, rec_start, counts, bound_t, floor_t, sentinel,
                   k_layers, tile_w, tile_h, block_ns):
    dev, n = _check_stream_args(records, rec_start, counts, tile_w, tile_h)
    lib = _lib()
    if not 1 <= k_layers <= lib.vkr_max_layers():
        raise ValueError(f"k_layers={k_layers} outside the kernel's "
                         f"1..{lib.vkr_max_layers()}")
    shape = (n, tile_h, tile_w)
    _check("bound_t", bound_t, torch.float32, shape, dev)
    if floor_t is not None:
        _check("floor_t", floor_t, torch.float32, shape, dev)
    out_d = torch.empty((k_layers,) + shape, dtype=torch.float32, device=dev)
    out_i = torch.empty((k_layers,) + shape, dtype=torch.int32, device=dev)
    if n == 0:
        return out_d, out_i
    ws = _workspace(lib, n, tile_h, k_layers, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vkr_raster_layers(
            _ptr(records), _ptr(rec_start), _ptr(counts), _ptr(bound_t),
            _ptr(floor_t), _ptr(out_d), _ptr(out_i), n, tile_h, k_layers,
            sentinel, _ptr(ws), _ptr(block_ns), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"raster layers kernel launch failed: CUDA error "
                           f"{err}")
    return out_d, out_i


rasterize_layers_grid.launches = 0
_LAYERS_WRAPPER = rasterize_layers_grid


def rasterize_layers_grid_plain(records, rec_start, counts, bound_t,
                                floor_t, sentinel: int, k_layers: int,
                                tile_w: int = 128, tile_h: int = 32):
    """Plain PyTorch version of rasterize_layers_grid: the records are
    applied one at a time (record j of every tile still streaming at
    once), each inserted into the K-layer stack with the kernel's
    replace-on-tie / shift-on-strict rule.  Only records below a tile's
    count are applied — the padding slots of its last chunk are sentinel
    records whose empty row range the kernel skips anyway."""
    g_tiles = counts.shape[0]
    p = tile_h * tile_w
    dev = records.device
    rec = records.reshape(-1, F_FIELDS)
    d_s = torch.full((k_layers, g_tiles, p), 2.0, dtype=torch.float32,
                     device=dev)
    i_s = torch.full((k_layers, g_tiles, p), sentinel, dtype=torch.int32,
                     device=dev)
    cnt_s, order = torch.sort(counts.long(), descending=True, stable=True)
    cnt_s = cnt_s.cpu().tolist()
    first_s = rec_start.long()[order] * CHUNK
    bnd = bound_t.reshape(g_tiles, p)[order]
    flo = floor_t.reshape(g_tiles, p)[order] if floor_t is not None else None
    px, py, band_lo = _pixel_grid(tile_h, tile_w, dev)
    group = max(1, PLAIN_ELEMS // (p * (k_layers + 8)))
    n_active = len(cnt_s)
    for j in range(cnt_s[0] if cnt_s else 0):
        while n_active and cnt_s[n_active - 1] <= j:
            n_active -= 1
        for g0 in range(0, n_active, group):
            g1 = min(g0 + group, n_active)
            r = rec[first_s[g0:g1] + j]                        # [g, 16]
            cov, z, tri, hit = _eval_records(r, px, py, band_lo)
            cov = cov & hit & (z <= bnd[g0:g1])
            if flo is not None:
                cov = cov & (z > flo[g0:g1])
            d_s[:, g0:g1], i_s[:, g0:g1] = _insert_layer(
                d_s[:, g0:g1], i_s[:, g0:g1], z, tri, cov)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(g_tiles, device=dev)
    return (d_s[:, inv].reshape(k_layers, g_tiles, tile_h, tile_w),
            i_s[:, inv].reshape(k_layers, g_tiles, tile_h, tile_w))


def _insert_layer(d, i, z, tri, cov):
    """One fragment per pixel into K-layer stacks d/i [K, ...] (z, tri,
    cov [...]): at the first layer with z <= d[j], a tie replaces the
    layer and a strictly nearer fragment shifts the deeper layers down.
    A stack's depths never decrease with j (empty layers are 2.0 and
    every insert keeps the order), so ``z <= d[j]`` holds from the first
    such layer on."""
    le = cov[None] & (z[None] <= d)                            # [K, ...]
    before = torch.cat([torch.zeros_like(le[:1]), le[:-1]], 0)
    rep = le & ~before
    pushed = before & (rep & (z[None] < d)).any(0, keepdim=True)
    d_up = torch.cat([d[:1], d[:-1]], 0)
    i_up = torch.cat([i[:1], i[:-1]], 0)
    return (torch.where(pushed, d_up, torch.where(rep, z[None].expand_as(d),
                                                  d)),
            torch.where(pushed, i_up, torch.where(rep,
                                                  tri[None].expand_as(i), i)))


def kernel_block_ns(wrapper, *args, **kw) -> torch.Tensor:
    """One launch of a raster kernel on CUDA tensors (``wrapper`` is
    rasterize_depth_grid or rasterize_layers_grid, the arguments are
    theirs) that also records every block's start and end on the
    device's ``%globaltimer``.  Returns i64[blocks, 2] in nanoseconds,
    block b = blockIdx.y * gridDim.x + blockIdx.x.  For measuring the
    spread of block times; not counted in ``launches`` and on no frame
    path."""
    names = {rasterize_depth_grid: ("init_d", "init_i", "floor_t"),
             rasterize_layers_grid: ("bound_t", "floor_t", "sentinel",
                                     "k_layers")}[wrapper]
    records, rec_start, counts = args[:3]
    rest = dict(zip(names, args[3:]))
    rest.update(kw)
    tile_w, tile_h = rest.pop("tile_w", 128), rest.pop("tile_h", 32)
    n_blocks = _lib().vkr_raster_blocks(counts.shape[0], tile_h,
                                        rest.get("k_layers", 0))
    block_ns = torch.zeros((n_blocks, 2), dtype=torch.int64,
                           device=records.device)
    if wrapper is rasterize_depth_grid:
        _launch_depth(records, rec_start, counts, rest["init_d"],
                      rest["init_i"], rest.get("floor_t"), tile_w, tile_h,
                      block_ns)
    else:
        _launch_layers(records, rec_start, counts, rest["bound_t"],
                       rest["floor_t"], rest["sentinel"], rest["k_layers"],
                       tile_w, tile_h, block_ns)
    return block_ns


# ---------------------------------------------------------------------------
# the kernels' exactness rules in plain PyTorch (csrc/raster.cu follows
# these; no frame path calls them, tests/test_torch_raster_design.py
# holds them against the plain versions)
# ---------------------------------------------------------------------------

# a warp's pixel footprint (width, height) in csrc/raster.cu
DEPTH_FOOTPRINT = (8, 8)
LAYERS_FOOTPRINT = (8, 4)
SEGMENT_EMPTY = -1         # id of a depth segment that no record hit


def footprint_may_cover(rec: torch.Tensor, x0, y0, foot_w: int,
                        foot_h: int, bound_max=None,
                        floor_min=None) -> torch.Tensor:
    """The kernels' footprint test: rec f32[..., 16] against the
    foot_w x foot_h pixels at tile-local (x0, y0) (ints, or integer
    tensors that broadcast against rec's leading dims).  False only where
    no pixel of the footprint can be covered.

    Each rounded step of e = (a*px + b*py) + k is monotone in the one
    operand that changes, so e is monotone in px for a fixed py and in py
    for a fixed px: its maximum over the pixel centres is at the corner
    picked by the signs of a and b, its minimum at the opposite one.  An
    edge or depth plane whose maximum is < 0 covers no pixel (a NaN corner
    keeps the record).  The k-buffer also drops a record whose depth
    minimum exceeds ``bound_max`` (the footprint's largest bound) or whose
    maximum is at most ``floor_min`` (its smallest floor)."""
    f = [rec[..., i] for i in range(12)]
    x0 = torch.as_tensor(x0, device=rec.device).to(torch.float32)
    y0 = torch.as_tensor(y0, device=rec.device).to(torch.float32)
    xlo, xhi = x0 + 0.5, x0 + (foot_w - 0.5)
    ylo, yhi = y0 + 0.5, y0 + (foot_h - 0.5)

    def corner(a, b, k, high):
        px = torch.where((a >= 0.0) == high, xhi, xlo)
        py = torch.where((b >= 0.0) == high, yhi, ylo)
        return a * px + b * py + k

    e0 = corner(f[0], f[1], f[2], True)
    e1 = corner(f[3], f[4], f[5], True)
    e2 = corner(f[6], f[7], f[8], True)
    zmax = corner(f[9], f[10], f[11], True)
    zmin = corner(f[9], f[10], f[11], False)
    may = ~(e0 < 0.0) & ~(e1 < 0.0) & ~(e2 < 0.0) & ~(zmax < 0.0)
    if bound_max is not None:
        may = may & ~(zmin > bound_max)
    if floor_min is not None:
        may = may & ~(zmax <= floor_min)
    return may


def merge_depth_segments(init_d, init_i, parts):
    """Merge the depth raster of consecutive stream segments.  Each part
    is (depth, id) of one segment run from (+inf, SEGMENT_EMPTY); its id
    stays SEGMENT_EMPTY only where no record of the segment hit the band.
    The whole stream's result is the lexicographic minimum of
    (zc, -stream index) over the init value and every band-hitting record,
    so segments fold in stream order, a later one winning a tie."""
    d, i = init_d, init_i
    for pd, pi in parts:
        take = (pi != SEGMENT_EMPTY) & (pd <= d)
        d = torch.where(take, pd, d)
        i = torch.where(take, pi, i)
    return d, i


def merge_layer_segments(parts, sentinel: int):
    """Merge the k-buffers (depth f32[K, ...], id i32[K, ...]) of
    consecutive stream segments.  A k-buffer holds the K smallest distinct
    covered depths, each with the id of the latest fragment at that depth,
    so the segments' entries are inserted again in stream order with the
    k-buffer's own rule (a tie replaces, a later segment winning; the K
    smallest stay).  An empty slot is (2.0, sentinel); a real entry at
    depth 2.0 is told from it by its id."""
    d = torch.full_like(parts[0][0], 2.0)
    i = torch.full_like(parts[0][1], sentinel)
    for pd, pi in parts:
        for j in range(pd.shape[0]):
            d, i = _insert_layer(d, i, pd[j], pi[j], pi[j] != sentinel)
    return d, i
