"""The least time the card could take for one launch of a hand kernel.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): HBM3 at 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor
cores.  A launch's bound is max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s),
where the bytes count each input read once and each output written once,
and the operations are what these inputs need:

- raster kernels: per live record, RASTER_OPS at each pixel of the part
  of the tile that its triangle's bounding box and its row range share
  (the vertices are the pairwise intersections of the record's three
  edge lines);
- tonemap: TONEMAP_OPS per element; gradient: a blend per row.

Everything is computed on the device from the launch's own arguments,
without a host synchronisation, as float64 sums.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations of one record at one pixel: three edge planes and the
# depth plane (2 multiplies + 2 adds each) and the edge sum (2 adds)
RASTER_OPS = 4 * 4 + 2
# per tonemap element: add, divide, log, multiply, exp
TONEMAP_OPS = 5
CHUNK = 64        # records per chunk of a tile's stream
F_FIELDS = 16     # f32 fields of one record


def bound_s(n_bytes, n_ops):
    """Seconds: the larger of the byte and the operation bound."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def raster_bound_s(records, rec_start, counts, planes,
                   outputs_per_px: int, tile_h: int, tile_w: int):
    """bound_s of one raster launch as a float64 device scalar."""
    import torch
    n_bytes, n_ops = raster_work(records, rec_start, counts, planes,
                                 outputs_per_px, tile_h, tile_w)
    return torch.maximum(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def raster_work(records, rec_start, counts, planes, outputs_per_px: int,
                tile_h: int, tile_w: int):
    """(bytes, ops) float64 device scalars of one raster launch over the
    stream ``records`` f32[rec_cap, 8, 128] with per-tile ``rec_start`` /
    ``counts`` i32[G]; ``planes`` are the per-pixel inputs it reads."""
    import torch
    dev = counts.device
    n_tiles = counts.shape[0]
    cnt = counts.long()
    nk = (cnt + CHUNK - 1) // CHUNK
    # tiles that own chunks, by their first chunk; tiles own the chunks
    # [rec_start, rec_start + ceil(count / CHUNK))
    key = torch.where(nk > 0, rec_start.long(), torch.iinfo(torch.int64).max)
    order = torch.argsort(key)
    first = key[order]
    rec = records.reshape(-1, F_FIELDS)
    n_chunk = records.shape[0]
    chunk = torch.arange(n_chunk, device=dev)
    # the tile that owns each chunk: the last tile whose first chunk is at
    # or before it, if the chunk lies inside that tile's run
    pos = torch.searchsorted(first, chunk, right=True) - 1
    tile = order[pos.clamp(min=0)]
    local_chunk = chunk - rec_start.long()[tile]
    owned = (pos >= 0) & (local_chunk >= 0) & (local_chunk < nk[tile])
    slot = (local_chunk[:, None] * CHUNK
            + torch.arange(CHUNK, device=dev)[None, :])           # [C, 64]
    live = owned[:, None] & (slot < cnt[tile][:, None])
    live = live.reshape(-1)
    rr = rec[:, 13].to(torch.int64)
    rows = torch.clamp((rr & 255) - (rr >> 8), min=0)
    cols = _bbox_cols(rec, tile_w)
    px_rec = torch.where(live, rows * cols, 0)
    ops = px_rec.sum(dtype=torch.float64) * RASTER_OPS
    px = n_tiles * tile_h * tile_w
    plane_bytes = sum(4 * px for p in planes if p is not None)
    n_bytes = (nk.sum(dtype=torch.float64) * CHUNK * F_FIELDS * 4
               + (8 * n_tiles + plane_bytes + outputs_per_px * px))
    return n_bytes, ops


def _bbox_cols(rec, tile_w: int):
    """Columns of the tile inside each record's triangle bounding box.
    The edge lines a_i x + b_i y + k_i = 0 are in tile-local pixel
    coordinates; each vertex is where two of them meet.  A degenerate
    pair (parallel edges) leaves the whole tile width."""
    import torch
    a = rec[:, [0, 3, 6]].double()
    b = rec[:, [1, 4, 7]].double()
    k = rec[:, [2, 5, 8]].double()
    xs = []
    ok = torch.ones(rec.shape[0], dtype=torch.bool, device=rec.device)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        det = a[:, i] * b[:, j] - a[:, j] * b[:, i]
        ok &= det != 0
        xs.append((b[:, i] * k[:, j] - b[:, j] * k[:, i])
                  / torch.where(det == 0, 1.0, det))
    xs = torch.stack(xs, 1)
    lo = torch.floor(xs.min(1).values).clamp(0, tile_w)
    hi = torch.ceil(xs.max(1).values).clamp(0, tile_w)
    cols = torch.where(ok, hi - lo, float(tile_w))
    return torch.nan_to_num(cols, nan=float(tile_w)).to(torch.int64)


def tonemap_work(n_elems: int):
    return 8.0 * n_elems, float(TONEMAP_OPS * n_elems)


def gradient_work(h: int, w: int):
    return 4.0 * 3 * h * w + 32, 5.0 * 3 * h
