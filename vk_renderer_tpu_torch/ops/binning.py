"""Triangle -> screen-tile binning (the occupancy-packed form).

Port of the packed path of vk_renderer_tpu/ops/binning.py
(``bin_buckets_packed``, ``binning.py:401``): sort-based, one sort serving
every material bucket of a view (buckets are contiguous triangle-id
ranges of the scene):

1. every small triangle emits up to ``max_span`` (tile, tri) pairs from
   its tile bbox, packed into ONE int32 key ``tile << ceil(log2 T) | tri``,
2. triangles spanning more than ``max_span`` tiles get EXACT per-tile
   coverage tests against their edge functions (conservative tile-corner
   test) and emit keys into the SAME sort,
3. sort ascending: pairs group by tile, and within a tile by triangle id
   == the reference's submission draw order,
4. per-(tile, bucket) offsets via searchsorted, then each bucket's
   per-tile lists are packed back-to-back into ``rec_cap`` chunk-aligned
   records of ``chunk`` slots.

Every step runs per view over a leading axis, so the four shadow
cascades bin in one chain of launches (keys stay view-local int32) and
the camera view is the case L = 1; no step waits for the device.
Overflow beyond the caps is counted and surfaced, never silent.  The JAX
package's compact-before-sort (``pair_cap``) and legacy front-of-tile
big list are not ported: the frame always supplies edge planes and sorts
the full emission.
"""

from __future__ import annotations

import torch

from .common import cdiv


def _big_exact_keys(edge, anchor, bbox, big, tri_ids, rows: int, cols: int,
                    tile_w: int, tile_h: int, big_cap: int, log2p: int,
                    n_tiles: int):
    """EXACT (tile, tri) keys for up to ``big_cap`` big triangles of each
    view: for each (big triangle, tile) pair, an edge excludes the tile
    iff its maximum over the tile rectangle is negative (maximizing corner
    picked by the coefficient signs), and the tile's bbox overlap prunes
    further.  The big triangles take their slots by a scatter that sends
    every other triangle (and every big one past ``big_cap``) to a dump
    slot, so the host never waits for a count.  Returns (keys
    i32[L, big_cap * n_tiles], big triangle count i32[L])."""
    dev = tri_ids.device
    n_views = big.shape[0]
    bigi = big.to(torch.int32)
    big_idx = torch.cumsum(bigi, -1, dtype=torch.int32) - 1
    big_total = bigi.sum(-1, dtype=torch.int32)
    sel = big & (big_idx < big_cap)
    slot_tri = torch.full((n_views, big_cap + 1), -1, dtype=torch.int32,
                          device=dev)
    slot_tri.scatter_(1, torch.where(sel, big_idx, big_cap).long(),
                      tri_ids.expand(n_views, -1))
    slot_tri = slot_tri[:, :big_cap]
    ok = slot_tri >= 0
    st = torch.clamp(slot_tri, min=0)
    st_idx = st.long()

    def g(plane):
        return torch.gather(plane, 1, st_idx)[..., None]  # [L, big_cap, 1]

    ax, ay = g(anchor[0]), g(anchor[1])
    tile = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    tx = (tile % cols).to(torch.float32)
    ty = (tile // cols).to(torch.float32)
    x0 = tx * tile_w                                      # [n_tiles]
    x1 = x0 + tile_w
    y0 = ty * tile_h
    y1 = y0 + tile_h

    covered = ok[..., None]
    for i in range(3):
        a, b, c = g(edge[3 * i]), g(edge[3 * i + 1]), g(edge[3 * i + 2])
        mx = (a * (torch.where(a > 0, x1, x0) - ax)
              + b * (torch.where(b > 0, y1, y0) - ay) + c)
        covered = covered & (mx >= 0.0)
    bx0, by0, bx1, by1 = (g(p) for p in bbox)
    covered = covered & (x1 > bx0) & (x0 < bx1) & (y1 > by0) & (y0 < by1)

    keys = torch.where(covered, (tile << log2p) | st[..., None],
                       n_tiles << log2p)
    return keys.reshape(n_views, -1), big_total


def _emit_pairs(bbox, valid, width: int, height: int, tile_w: int,
                tile_h: int, max_span: int, edge, anchor, big_cap: int):
    """The UNSORTED (tile, tri) int32 keys of each view, [L, N] (small
    triangles' bbox pairs + big triangles' exact pairs; sentinel key on
    unused slots)."""
    bx0, by0, bx1, by1 = bbox
    n_views, n_tris = bx0.shape
    dev = bx0.device
    rows = cdiv(height, tile_h)
    cols = cdiv(width, tile_w)
    n_tiles = rows * cols

    # packed key layout: tile in the high bits, triangle in the low bits;
    # both are local to the view, so L views never widen the key
    log2p = max(1, int(n_tris + 1).bit_length())
    if (n_tiles + 1) << log2p >= 2**31:
        raise ValueError(f"{n_tiles} tiles x {n_tris} triangles exceed the "
                         "int32 (tile, tri) sort key")

    tx0 = torch.clamp(torch.floor(bx0 / tile_w), 0, cols - 1).to(torch.int32)
    ty0 = torch.clamp(torch.floor(by0 / tile_h), 0, rows - 1).to(torch.int32)
    tx1 = torch.clamp(torch.ceil(bx1 / tile_w) - 1, 0, cols - 1
                      ).to(torch.int32)
    ty1 = torch.clamp(torch.ceil(by1 / tile_h) - 1, 0, rows - 1
                      ).to(torch.int32)
    nx = tx1 - tx0 + 1
    ny = ty1 - ty0 + 1
    span = nx * ny

    small = valid & (span <= max_span)
    big = valid & (span > max_span)

    tri_ids = torch.arange(n_tris, dtype=torch.int32, device=dev)
    k = torch.arange(max_span, dtype=torch.int32, device=dev)
    dx = k % nx[..., None]                                # [L, T, span]
    dy = k // nx[..., None]
    tile_id = (ty0[..., None] + dy) * cols + (tx0[..., None] + dx)
    pair_ok = small[..., None] & (k < span[..., None])
    keys = torch.where(pair_ok, (tile_id << log2p) | tri_ids[:, None],
                       n_tiles << log2p).reshape(n_views, -1)
    big_keys, big_total = _big_exact_keys(
        edge, anchor, bbox, big, tri_ids, rows, cols, tile_w, tile_h,
        big_cap, log2p, n_tiles)
    keys = torch.cat([keys, big_keys], dim=-1)
    return keys, log2p, rows, cols, n_tiles, big_total


def _pair_sort(bbox, valid, width: int, height: int, tile_w: int,
               tile_h: int, max_span: int, edge, anchor, big_cap: int):
    """_emit_pairs + an ascending sort of each view's keys."""
    keys, log2p, rows, cols, n_tiles, big_total = _emit_pairs(
        bbox, valid, width, height, tile_w, tile_h, max_span, edge, anchor,
        big_cap)
    keys_s, _ = torch.sort(keys, dim=-1, stable=True)
    return keys_s, log2p, rows, cols, n_tiles, big_total


def _build_packed_plans(keys_s, log2p, bounds, caps, rec_caps, chunk,
                        big_cap, big_exact_total, sentinel, n_tiles, rows,
                        cols):
    """Per-bucket occupancy-packed plans from each view's SORTED keys
    (``keys_s`` [L, N]); every search, scan and gather runs per view."""
    dev = keys_s.device
    n_views = keys_s.shape[0]
    keys64 = keys_s.to(torch.int64)
    tris_s = keys_s & ((1 << log2p) - 1)
    tile_keys = (torch.arange(n_tiles, dtype=torch.int64, device=dev)
                 << log2p).repeat(n_views, 1)
    # exact mode: big pairs already merged into the sorted keys
    big_drop = torch.clamp(big_exact_total - big_cap, min=0) * n_tiles
    out = []
    for (lo, hi), cap, rec_cap in zip(bounds, caps, rec_caps):
        offsets = torch.searchsorted(keys64, tile_keys + lo,
                                     right=False).to(torch.int32)
        ends = torch.searchsorted(keys64, tile_keys + hi,
                                  right=False).to(torch.int32)
        counts = ends - offsets

        cap_eff = cap + big_cap
        counts_cap = torch.clamp(counts, max=cap_eff)
        nk = (counts_cap + chunk - 1) // chunk
        rec_start = torch.cumsum(nk, -1, dtype=torch.int32) - nk
        # tiles whose record range spills past rec_cap are truncated
        nk_fit = torch.clamp(torch.minimum(nk, rec_cap - rec_start), min=0)
        counts_fit = torch.minimum(counts_cap, nk_fit * chunk)

        # per-record owning tile: rec_start is nondecreasing and empty
        # tiles contribute no records, so the last tile starting <= r owns r
        rec_idx = torch.arange(rec_cap, dtype=torch.int32,
                               device=dev).repeat(n_views, 1)
        rec_tile = (torch.searchsorted(rec_start, rec_idx, right=True)
                    .to(torch.int32) - 1)
        rec_tile = torch.clamp(rec_tile, 0, n_tiles - 1)

        # slot -> source triangle (the sorted pairs)
        slot_tile = rec_tile[..., None].expand(-1, -1, chunk).reshape(
            n_views, -1).long()

        def at(t):
            return torch.gather(t, 1, slot_tile)

        local = (torch.arange(rec_cap * chunk, dtype=torch.int32, device=dev)
                 - at(rec_start) * chunk)
        in_range = local < at(counts_fit)
        src = torch.clamp(at(offsets) + local, 0,
                          keys_s.shape[-1] - 1).long()
        tri = torch.where(in_range, torch.gather(tris_s, 1, src), sentinel)

        overflow = (torch.clamp(counts - cap_eff, min=0).sum(
            -1, dtype=torch.int32) + big_drop
            + (counts_cap - counts_fit).sum(-1, dtype=torch.int32))
        out.append({"rec_tri": tri, "rec_tile": rec_tile,
                    "rec_start": rec_start.to(torch.int32),
                    "counts": counts_fit.reshape(n_views, rows, cols),
                    "overflow": overflow.to(torch.int32)})
    return tuple(out)


def bin_buckets_packed(bbox, valid: torch.Tensor, bounds, width: int,
                       height: int, tile_w: int = 128, tile_h: int = 32,
                       caps=(2048,), rec_caps=(4096,), chunk: int = 64,
                       max_span: int = 16, big_cap: int = 512, *, edge,
                       anchor):
    """Occupancy-packed per-bucket raster work lists.

    Each bucket's per-tile candidate lists are packed back-to-back into
    ``rec_cap`` chunk-aligned records of ``chunk`` slots; the raster
    kernels read records ``rec_start[tile] + k``.  ``rec_cap`` is a
    safety cap (truncation is counted in ``overflow``).  ``edge``/
    ``anchor`` (the triangle_setup planes) are required: big triangles
    are binned EXACTLY into only the tiles they touch.

    The planes are [T] (one view) or [L, T]: L views of the same
    triangles (the shadow cascades), binned at once with no host sync,
    each exactly as alone.

    Returns per bucket a dict (with the leading L for [L, T] planes):
      rec_tri   i32[rec_cap * chunk]  triangle id per slot (sentinel pad)
      rec_tile  i32[rec_cap]          owning tile per record
      rec_start i32[n_tiles]          first record of each tile
      counts    i32[rows, cols]       per-tile candidate count (clamped)
      overflow  i32                   dropped candidates (cap + rec_cap)
    """
    one = valid.dim() == 1
    if one:
        bbox, edge, anchor = ([p[None] for p in planes]
                              for planes in (bbox, edge, anchor))
        valid = valid[None]
    n_tris = valid.shape[-1]
    keys_s, log2p, rows, cols, n_tiles, big_total = _pair_sort(
        tuple(bbox), valid, width, height, tile_w, tile_h, max_span,
        tuple(edge), tuple(anchor), big_cap)
    plans = _build_packed_plans(keys_s, log2p, tuple(bounds), tuple(caps),
                                tuple(rec_caps), chunk, big_cap, big_total,
                                n_tris, n_tiles, rows, cols)
    if one:
        plans = tuple({k: v[0] for k, v in plan.items()} for plan in plans)
    return plans
