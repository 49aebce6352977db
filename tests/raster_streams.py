"""Record streams shared by the port's raster kernel tests.

A 2 x 2 grid of 128 x 8 tiles (8-row tiles keep Pallas interpret mode
cheap), every stream padded to R record chunks.  NumPy only, so the tests
that run on the card (where JAX is absent) can use it too."""

import numpy as np

W, H, TW, TH = 256, 16, 128, 8          # 2 x 2 tiles of 128 x 8
ROWS, COLS = H // TH, W // TW
N_TILES = ROWS * COLS
R = 8                                    # record chunks in every stream
SENT = 60                                # sentinel id (no test triangle's)


def clip_scene(seed, n, w=W, h=H, w_cross=0):
    """n random triangles as clip coords f32[3n, 4] (w = 1, except the
    first ``w_cross`` vertices, whose w may cross 0) and tris i32[n, 3]."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-10, -4], [w + 10, h + 4], size=(3 * n, 2))
    z = rng.uniform(0.05, 0.95, size=3 * n)
    clip = np.stack([pts[:, 0] / w * 2 - 1, pts[:, 1] / h * 2 - 1, z,
                     np.ones(3 * n)], axis=1).astype(np.float32)
    if w_cross:
        clip[:w_cross, 3] = rng.uniform(-0.5, 1.5, w_cross)
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return clip, tris


def pad_records(rec):
    """f32[r, 8, 128] records -> f32[R, 8, 128] (zero records appended)."""
    rec = np.asarray(rec)
    assert rec.shape[0] <= R
    return np.concatenate([rec, np.zeros((R - rec.shape[0], 8, 128),
                                         np.float32)])


def _rec(a=(0, 0, 1), b=(0, 0, 1), c=(0, 0, 1), z=(0, 0, 0.5), tri=0,
         tl=7, r0=0, r1=8):
    return [*a, *b, *c, *z, tri * 8 + tl, r0 * 256 + r1, 0, 0]


def synthetic_stream():
    """Hand-built records: exact LEQUAL ties (the later record wins),
    edges exactly zero on pixel centers (top-left vs not), a depth
    plane crossing exactly z = 0 (near clip) and going negative, row-range
    gating, a deep stack of coplanar-tied and distinct layers (more than
    k), and an empty tile.  Returns (records, rec_start, counts)."""
    recs = np.zeros((R, 64, 16), np.float32)
    t0 = [
        _rec(z=(0, 0, 0.5), tri=5),                    # full tile
        _rec(z=(0, 0, 0.5), tri=7),                    # exact tie: 7 wins
        # e0 = px - 10.5: zero at x=10, a left edge (a > 0) -> covered
        _rec(a=(1, 0, -10.5), z=(0, 0, 0.25), tri=11),
        # e0 = 20.5 - px: zero at x=20, not top-left -> not covered;
        # e1 = 1.5 - py: zero on row 1, a bottom edge -> row 0 only
        _rec(a=(-1, 0, 20.5), b=(0, -1, 1.5), z=(0, 0, 0.2), tri=12, tl=4),
        # z = 2*px - 129: exactly 0 at x=64 (near clip passes), < 0 left
        _rec(z=(2.0, 0, -129.0), tri=13),
        # e1 = py - 3.5: zero on row 3, a top edge (a=0, b>0) -> covered
        _rec(b=(0, 1, -3.5), z=(0, 0, 0.1), tri=14),
        # covers everything, but its row range misses the band
        _rec(z=(0, 0, 0.05), tri=15, r0=0, r1=0),
        _rec(z=(0, 0, 0.05), tri=16, r0=8, r1=8),
    ]
    recs[0, :len(t0)] = t0
    # tile 1: twelve full-tile layers, shuffled, with duplicate depths
    zs = [0.7, 0.3, 0.9, 0.3, 0.1, 0.5, 0.5, 0.8, 0.2, 0.6, 0.4, 0.1]
    recs[1, :12] = [_rec(z=(0.001, -0.002, zv), tri=20 + i)
                    for i, zv in enumerate(zs)]
    # tile 2: records whose depth varies over the tile, crossing
    recs[2, :3] = [_rec(z=(0.004, 0, 0.1), tri=40),
                   _rec(z=(-0.004, 0, 0.6), tri=41),
                   _rec(z=(0, 0.05, 0.2), tri=42)]
    # tile 3: empty
    rec_start = np.array([0, 1, 2, 3], np.int32)
    counts = np.array([len(t0), 12, 3, 0], np.int32)
    return recs.reshape(R, 8, 128), rec_start, counts


def random_records(seed, n, th, x_max=W // 2 + 8, size=(0.5, 24.0)):
    """n records of random triangles over a 128 x th tile, centred left
    of x_max (so the tile's right end can stay uncovered), of sizes
    log-uniform in ``size`` pixels: vertices on a 1/2-pixel lattice (so
    edges run exactly through pixel centres), inside-positive edges, depth
    planes that are flat (from a few values, for ties: -0.0, 0.0 and 2.0
    among them) or sloped (some crossing 0), random top-left bits and row
    ranges, ids SENT + 1 .. SENT + n (never the sentinel, which marks an
    empty k-buffer layer).  Returns f32[n, 16]."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((n, 16), np.float32)
    centre = np.stack([rng.uniform(-8, x_max, n),
                       rng.uniform(-4, th + 4, n)], 1)
    scale = np.exp(rng.uniform(np.log(size[0]), np.log(size[1]), n))
    v = np.round(2 * (centre[:, None, :] + scale[:, None, None]
                      * rng.uniform(-1, 1, (n, 3, 2)))) / 2      # [n, 3, 2]
    area = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
            - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    sign = np.where(area >= 0, 1.0, -1.0)
    for e in range(3):
        p0, p1 = v[:, e], v[:, (e + 1) % 3]
        a = (-(p1[:, 1] - p0[:, 1]) * sign).astype(np.float32)
        b = ((p1[:, 0] - p0[:, 0]) * sign).astype(np.float32)
        k = (-(a * p0[:, 0] + b * p0[:, 1])).astype(np.float32)
        rec[:, 3 * e:3 * e + 3] = np.stack([a, b, k], 1)
    flat = rng.random(n) < 0.6
    zvals = np.array([-0.0, 0.0, 0.25, 0.5, 0.5, 0.75, 1.0, 2.0], np.float32)
    rec[:, 9] = np.where(flat, 0.0, rng.uniform(-0.02, 0.02, n))
    rec[:, 10] = np.where(flat, 0.0, rng.uniform(-0.05, 0.05, n))
    rec[:, 11] = np.where(flat, rng.choice(zvals, n),
                          rng.uniform(-0.5, 1.5, n))
    tri = rng.permutation(n) + SENT + 1
    rec[:, 12] = tri * 8 + rng.integers(0, 8, n)
    r0 = rng.integers(0, th + 1, n)
    r1 = np.clip(r0 + rng.integers(0, th + 1, n), 0, th)
    full = rng.random(n) < 0.2
    r0[full], r1[full] = 0, th
    rec[:, 13] = r0 * 256 + r1
    return rec


def whole_tile_record(z, tri, th):
    """A record covering every pixel of the tile at flat depth z."""
    return np.array([0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, z, tri * 8 + 7, th,
                     0, 0], np.float32)


def pack_tiles(tiles):
    """Per-tile record lists f32[n_t, 16] -> (records f32[chunks, 8, 128],
    rec_start i32, counts i32), each tile's last chunk zero-padded."""
    starts, chunks = [], []
    for rec in tiles:
        starts.append(sum(c.shape[0] for c in chunks))
        nc = -(-rec.shape[0] // 64)
        out = np.zeros((nc, 64, 16), np.float32)
        out.reshape(-1, 16)[:rec.shape[0]] = rec
        chunks.append(out)
    rec = np.concatenate(chunks) if chunks else np.zeros((0, 64, 16))
    return (rec.reshape(-1, 8, 128).astype(np.float32),
            np.array(starts, np.int32),
            np.array([t.shape[0] for t in tiles], np.int32))


def heavy_stream(seed, th, n=3100, seg_chunks=4, light=40):
    """Four tiles: a heavy one of n records whose ties straddle every
    boundary of seg_chunks chunks (copies of one record with new ids at
    boundary - 2 .. boundary + 1, so also chunk boundaries; every third
    group a whole-tile record at depth 2.0), a light one, an empty one and
    another light one."""
    rec = random_records(seed, n, th, x_max=96)
    seg = seg_chunks * 64
    for i, b in enumerate(range(seg, n, seg)):
        base = rec[b - 2].copy()
        if i % 3 == 0:
            base = whole_tile_record(2.0, 0, th)
        for j, at in enumerate(range(b - 2, b + 2)):
            rec[at] = base
            rec[at, 12] = (SENT + n + 4 * i + j + 1) * 8 + int(base[12]) % 8
    lights = [random_records(seed + s, light, th) for s in (1, 2)]
    for s, lt in enumerate(lights):
        lt[:, 12] += 8 * 100000 * (s + 1)
    return pack_tiles([rec, lights[0], np.zeros((0, 16), np.float32),
                       lights[1]])


def whole_and_tiny_stream(seed, th):
    """Four tiles: whole-tile records (nothing can be culled) interleaved
    with sub-pixel to 2-pixel triangles (nearly every footprint culled),
    only tiny ones, only whole-tile ones (ties among them), and empty."""
    rng = np.random.default_rng(seed)
    tiny = random_records(seed, 400, th, x_max=W // 2, size=(0.25, 2.0))
    whole = np.stack([whole_tile_record(z, 5000 + i, th) for i, z in
                      enumerate(rng.choice(np.array(
                          [-0.0, 0.0, 0.3, 0.6, 0.9, 2.0], np.float32),
                          90))])
    whole[::7, 9] = 0.003           # some sloped whole-tile depths
    mixed = np.concatenate([tiny[:200], whole[:60]])
    mixed = mixed[rng.permutation(mixed.shape[0])]
    return pack_tiles([mixed, tiny[200:], whole[60:],
                       np.zeros((0, 16), np.float32)])
