"""Record streams shared by the port's raster kernel tests.

A 2 x 2 grid of 128 x 8 tiles (8-row tiles keep Pallas interpret mode
cheap), every stream padded to R record chunks.  NumPy only, so the tests
that run on the card (where JAX is absent) can use it too."""

import numpy as np

W, H, TW, TH = 256, 16, 128, 8          # 2 x 2 tiles of 128 x 8
ROWS, COLS = H // TH, W // TW
N_TILES = ROWS * COLS
R = 8                                    # record chunks in every stream
SENT = 60                                # sentinel id (> every test id)


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
