"""The exactness rules of the CUDA raster kernels' design, on the CPU.

csrc/raster.cu culls (record, warp footprint) pairs with an exact corner
test, folds the culled records of the depth raster into its minimum at
the end, and the split-stream merge rules say how partial results of
stream segments combine.  Their plain mirrors live in
vk_renderer_tpu_torch/ops/raster_kernels.py; this file holds them against
the plain versions of the two kernels, bit for bit (depths compared as
int32 bits, so -0.0 and +0.0 differ):

- the footprint test never rejects a pair in which some pixel is covered
  (seeded random records, edges exactly zero on pixel centres, depth
  planes crossing 0, bounds and floors),
- the kernels' culled walk (emulated here per record) equals the plain
  versions,
- a long stream split into segments, each run by the plain version and
  merged, equals the whole stream's plain result.

NumPy and the port only (no JAX)."""

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch.ops import raster_kernels as rk

import torch_threads  # noqa: F401  (bounds torch's threads)
from raster_streams import (heavy_stream, pack_tiles, random_records,
                            synthetic_stream, whole_and_tiny_stream)

TW = 128
TH = 16                      # two 8-row bands
THK = 8                      # the k-buffer's long streams: one band
SENT = 1 << 20               # sentinel id (> every test id)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _grid():
    p = torch.arange(TH * TW)
    px = (p % TW).to(torch.float32) + 0.5
    row = p // TW
    return px, row.to(torch.float32) + 0.5, (row // 8) * 8


def _footprints(shape):
    """Footprint origins over the tile and a [F, P] pixel mask of each."""
    fw, fh = shape
    p = torch.arange(TH * TW)
    x, y = p % TW, p // TW
    origins = [(x0, y0) for y0 in range(0, TH, fh) for x0 in range(0, TW, fw)]
    mask = torch.stack([(x >= x0) & (x < x0 + fw) & (y >= y0) & (y < y0 + fh)
                        for x0, y0 in origins])
    return origins, mask


def _cover(rec, px, py, band_lo):
    cov, z, tri, hit = rk._eval_records(torch.from_numpy(rec), px, py,
                                        band_lo)
    return cov, z, tri[..., 0], hit


def _may(rec, origins, shape):
    r = torch.from_numpy(rec)
    return torch.stack([rk.footprint_may_cover(r, x0, y0, *shape)
                        for x0, y0 in origins], 1)             # [n, F]


def _synthetic_records():
    recs, _, counts = synthetic_stream()
    recs = recs.reshape(-1, 64, 16)
    return np.concatenate([recs[t, :c] for t, c in enumerate(counts)])


@pytest.mark.parametrize("shape", [rk.DEPTH_FOOTPRINT, rk.LAYERS_FOOTPRINT],
                         ids=["depth_8x8", "kbuffer_8x4"])
@pytest.mark.parametrize("source", ["random", "synthetic", "crossing_zero"])
def test_footprint_test_never_rejects_a_covered_pixel(source, shape):
    if source == "random":
        rec = random_records(1, 1500, TH, x_max=TW + 8)
    elif source == "synthetic":
        # edges exactly zero on pixel centres, z exactly 0, full tiles
        rec = _synthetic_records()
    else:
        # depth planes crossing z = 0 inside the tile, some exactly on a
        # pixel-centre column
        rec = random_records(2, 600, TH, x_max=TW + 8)
        rng = np.random.default_rng(3)
        rec[:, 9] = rng.choice(np.array([1.0, -1.0, 0.5, -0.25],
                                        np.float32), 600)
        rec[:, 10] = rng.choice(np.array([0.0, 0.5, -0.5], np.float32), 600)
        rec[:, 11] = -(rec[:, 9] * (rng.integers(0, TW, 600) + 0.5)
                       + rec[:, 10] * (rng.integers(0, TH, 600) + 0.5))
    px, py, band_lo = _grid()
    cov, z, _, _ = _cover(rec, px, py, band_lo)              # [n, P]
    origins, fmask = _footprints(shape)
    covered = (cov[:, None, :] & fmask[None]).any(-1)         # [n, F]
    may = _may(rec, origins, shape)
    assert not bool((covered & ~may).any())
    # the test culls: most footprints of a small triangle are rejected
    if source == "random":
        assert float((~may).float().mean()) > 0.5

    # the k-buffer's bound and floor culls, per-pixel values
    rng = np.random.default_rng(4)
    bound = torch.from_numpy(rng.choice(np.array(
        [0.3, 0.65, 1.0, 2.0, -0.0], np.float32), TH * TW))
    floor = torch.from_numpy(rng.choice(np.array(
        [-1.0, 0.0, 0.15, 0.5, 2.0], np.float32), TH * TW))
    bmax = torch.stack([bound[m].max() for m in fmask])
    fmin = torch.stack([floor[m].min() for m in fmask])
    may_k = torch.stack([rk.footprint_may_cover(
        torch.from_numpy(rec), x0, y0, *shape, bound_max=bmax[f],
        floor_min=fmin[f]) for f, (x0, y0) in enumerate(origins)], 1)
    cov_k = cov & (z <= bound) & (z > floor)
    covered_k = (cov_k[:, None, :] & fmask[None]).any(-1)
    assert not bool((covered_k & ~may_k).any())
    assert bool((may & ~may_k).any()) or source == "synthetic"


def _segment_slots(rec_start, counts, seg_chunks):
    """Every (segment, tile) pair of seg_chunks chunks as one slot of an
    explicit tile list (the kernels take any slot order): the number of
    segments S and the slots' rec_start / counts, segment-major."""
    n_seg = -(-int(counts.max()) // (64 * seg_chunks))
    first = torch.arange(n_seg)[:, None] * seg_chunks
    s_start = (rec_start[None] + first).reshape(-1).to(torch.int32)
    s_counts = torch.clamp(counts[None] - 64 * first, 0,
                           64 * seg_chunks).reshape(-1).to(torch.int32)
    return n_seg, s_start, s_counts


@pytest.mark.parametrize("case", ["init1", "init2", "floor"])
def test_depth_segments_merge_to_the_whole_stream(case):
    rec, start, counts = (torch.from_numpy(x) for x in
                          heavy_stream(5, TH, seg_chunks=4))
    g = counts.shape[0]
    rng = np.random.default_rng(6)
    init_d = torch.full((g, TH, TW), 2.0 if case == "init2" else 1.0)
    init_i = torch.full((g, TH, TW), SENT, dtype=torch.int32)
    floor = (torch.from_numpy(rng.choice(np.array(
        [-1.0, 0.0, 0.25, 0.5, 2.0], np.float32), (g, TH, TW)))
        if case == "floor" else None)
    want_d, want_i = rk.rasterize_depth_grid_plain(
        rec, start, counts, init_d, init_i, floor, tile_h=TH)
    n_seg, s_start, s_counts = _segment_slots(start, counts, 4)
    pd, pi = rk.rasterize_depth_grid_plain(
        rec, s_start, s_counts, torch.full((n_seg * g, TH, TW), float("inf")),
        torch.full((n_seg * g, TH, TW), rk.SEGMENT_EMPTY, dtype=torch.int32),
        None if floor is None else floor.repeat(n_seg, 1, 1), tile_h=TH)
    assert n_seg >= 12
    parts = list(zip(pd.reshape(n_seg, g, TH, TW),
                     pi.reshape(n_seg, g, TH, TW)))
    got_d, got_i = rk.merge_depth_segments(init_d, init_i, parts)
    assert torch.equal(_bits(got_d), _bits(want_d))
    assert torch.equal(got_i, want_i)
    # the ties decide ids, and 2.0 (uncovered, band-hitting) shows up
    assert int((want_i != SENT).sum()) > 1000
    if case == "init2":
        assert bool(((want_d == 2.0) & (want_i != SENT)).any())


@pytest.mark.parametrize("k_layers", [1, 3, 10, 16])
def test_kbuffer_segments_merge_to_the_whole_stream(k_layers):
    rec, start, counts = (torch.from_numpy(x) for x in
                          heavy_stream(7, THK, n=3000, seg_chunks=8))
    g = counts.shape[0]
    rng = np.random.default_rng(8)
    bound = torch.from_numpy(rng.choice(np.array([0.65, 1.0, 2.0],
                                                 np.float32), (g, THK, TW)))
    floor = torch.from_numpy(rng.choice(np.array([-1.0, 0.0, 0.25],
                                                 np.float32), (g, THK, TW)))
    # the whole tiles and every segment as slots of one explicit tile list
    n_seg, s_start, s_counts = _segment_slots(start, counts, 8)
    d, i = rk.rasterize_layers_grid_plain(
        rec, torch.cat([start, s_start]), torch.cat([counts, s_counts]),
        bound.repeat(n_seg + 1, 1, 1), floor.repeat(n_seg + 1, 1, 1), SENT,
        k_layers, tile_h=THK)
    d = d.reshape(k_layers, n_seg + 1, g, THK, TW)
    i = i.reshape(k_layers, n_seg + 1, g, THK, TW)
    want_d, want_i = d[:, 0], i[:, 0]
    parts = [(d[:, s], i[:, s]) for s in range(1, n_seg + 1)]
    got_d, got_i = rk.merge_layer_segments(parts, SENT)
    assert torch.equal(_bits(got_d), _bits(want_d))
    assert torch.equal(got_i, want_i)
    # real entries at depth 2.0 (bound 2.0) are kept apart from empty slots
    assert bool(((want_d == 2.0) & (want_i != SENT)).any())
    assert int((want_i[min(k_layers, 4) - 1] != SENT).sum()) > 100


def _culled_walk(rec, init_d, init_i, floor=None, bound=None, k_layers=0):
    """The kernels' per-warp walk over one 128 x 16 tile, emulated one
    record at a time: a footprint whose band the record hits either walks
    it (pixel test, LEQUAL or k-buffer insert) or, if the footprint test
    culls it, skips it — the depth raster folding the latest culled
    record's (2.0, id) into its minimum at the end."""
    px, py, band_lo = _grid()
    shape = rk.LAYERS_FOOTPRINT if k_layers else rk.DEPTH_FOOTPRINT
    origins, fmask = _footprints(shape)
    foot = torch.argmax(fmask.to(torch.int8), 0)             # pixel -> F
    n = rec.shape[0]
    cov, z, tri, hit = _cover(rec, px, py, band_lo)
    if k_layers:
        bmax = torch.stack([bound[m].max() for m in fmask])
        fmin = (torch.stack([floor[m].min() for m in fmask])
                if floor is not None else None)
        may = torch.stack([rk.footprint_may_cover(
            torch.from_numpy(rec), x0, y0, *shape, bound_max=bmax[f],
            floor_min=None if fmin is None else fmin[f])
            for f, (x0, y0) in enumerate(origins)], 1)[:, foot]
        d = torch.full((k_layers, TH * TW), 2.0)
        i = torch.full((k_layers, TH * TW), SENT, dtype=torch.int32)
        for j in range(n):
            walk = hit[j] & may[j]
            c = walk & cov[j] & (z[j] <= bound)
            if floor is not None:
                c = c & (z[j] > floor)
            d, i = rk._insert_layer(d, i, z[j], tri[j].expand_as(z[j]), c)
        return d, i
    may = _may(rec, origins, shape)[:, foot]                  # [n, P]
    zbuf, ibuf = init_d.clone(), init_i.clone()
    widx = torch.full_like(ibuf, -1)
    jcull = torch.full_like(ibuf, -1)
    jtri = torch.zeros_like(ibuf)
    for j in range(n):
        c = cov[j] if floor is None else cov[j] & (z[j] > floor)
        zc = torch.where(c, z[j], torch.tensor(2.0))
        take = hit[j] & may[j] & (zc <= zbuf)
        zbuf = torch.where(take, zc, zbuf)
        ibuf = torch.where(take, tri[j], ibuf)
        widx = torch.where(take, j, widx)
        culled = hit[j] & ~may[j]
        jcull = torch.where(culled, j, jcull)
        jtri = torch.where(culled, tri[j], jtri)
    fold = (jcull >= 0) & ((2.0 < zbuf) | ((zbuf == 2.0) & (jcull > widx)))
    return torch.where(fold, 2.0, zbuf), torch.where(fold, jtri, ibuf)


@pytest.mark.parametrize("case", ["init1", "init2", "floor", "k3", "k10"])
def test_culled_walk_equals_the_plain_versions(case):
    """The cull and the fold change no bit: init 2.0 (where uncovered
    band-hitting records win), a floor, and the k-buffer's bound and
    floor culls."""
    n = 640
    rec = random_records(9, n, TH, x_max=TW + 8)
    stream = torch.from_numpy(rec.reshape(-1, 8, 128))
    start = torch.zeros(1, dtype=torch.int32)
    counts = torch.tensor([n], dtype=torch.int32)
    rng = np.random.default_rng(10)
    floor = torch.from_numpy(rng.choice(np.array(
        [-1.0, 0.0, 0.25, 0.5], np.float32), TH * TW))
    if case.startswith("k"):
        k = int(case[1:])
        bound = torch.from_numpy(rng.choice(np.array(
            [0.3, 0.65, 1.0, 2.0], np.float32), TH * TW))
        fl = floor if k == 3 else None
        want_d, want_i = rk.rasterize_layers_grid_plain(
            stream, start, counts, bound.reshape(1, TH, TW),
            None if fl is None else fl.reshape(1, TH, TW), SENT, k,
            tile_h=TH)
        got_d, got_i = _culled_walk(rec, None, None, floor=fl, bound=bound,
                                    k_layers=k)
        assert torch.equal(_bits(got_d), _bits(want_d.reshape(k, -1)))
        assert torch.equal(got_i, want_i.reshape(k, -1))
        return
    init_d = torch.full((TH * TW,), 2.0 if case == "init2" else 1.0)
    init_i = torch.full((TH * TW,), SENT, dtype=torch.int32)
    fl = floor if case == "floor" else None
    want_d, want_i = rk.rasterize_depth_grid_plain(
        stream, start, counts, init_d.reshape(1, TH, TW),
        init_i.reshape(1, TH, TW),
        None if fl is None else fl.reshape(1, TH, TW), tile_h=TH)
    got_d, got_i = _culled_walk(rec, init_d, init_i, floor=fl)
    assert torch.equal(_bits(got_d), _bits(want_d.reshape(-1)))
    assert torch.equal(got_i, want_i.reshape(-1))
    if case == "init2":
        # culled band-hitting records do win here (the fold matters)
        assert bool(((want_d == 2.0) & (want_i != SENT)).any())


CULL_STREAMS = {
    "random": lambda: pack_tiles([random_records(21, 640, TH, x_max=TW + 8),
                                  random_records(22, 90, TH)]),
    "heavy": lambda: heavy_stream(23, TH),
    "whole_and_tiny": lambda: whole_and_tiny_stream(24, TH),
}


@pytest.mark.parametrize("case", ["init1", "init2", "floor"])
@pytest.mark.parametrize("source", list(CULL_STREAMS))
def test_culled_cpu_depth_path_equals_the_plain_version(source, case):
    """rasterize_depth_grid_culled (the frame's CPU path: per 8x8 block,
    the records its footprint test keeps plus the latest culled one)
    equals the unculled plain version bit for bit."""
    rec, start, counts = (torch.from_numpy(x) for x in
                          CULL_STREAMS[source]())
    g = counts.shape[0]
    rng = np.random.default_rng(25)
    init_d = torch.full((g, TH, TW), 2.0 if case == "init2" else 1.0)
    init_i = torch.full((g, TH, TW), SENT, dtype=torch.int32)
    floor = (torch.from_numpy(rng.choice(np.array(
        [-1.0, 0.0, 0.25, 0.5, 2.0], np.float32), (g, TH, TW)))
        if case == "floor" else None)
    want_d, want_i = rk.rasterize_depth_grid_plain(
        rec, start, counts, init_d, init_i, floor, tile_h=TH)
    got_d, got_i = rk.rasterize_depth_grid_culled(
        rec, start, counts, init_d, init_i, floor, tile_h=TH)
    assert torch.equal(_bits(got_d), _bits(want_d))
    assert torch.equal(got_i, want_i)
    if case == "init2":
        # culled band-hitting records win at 2.0 (the kept latest matters)
        assert bool(((want_d == 2.0) & (want_i != SENT)).any())
