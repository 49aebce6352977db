"""Port raster front end and raster kernels against the JAX package.

- triangle setup: planes to rtol=1e-5, atol=1e-6 (f32 sums may round in
  another order), validity exact,
- binning and records: exact (integers, and records bit for bit),
- the two raster kernels' plain PyTorch versions (the port's CPU path)
  against the JAX package's Pallas kernels run in interpret mode on the
  same records: triangle ids exact, depth to rtol=1e-6, atol=1e-6 — the
  interpreter's XLA CPU program may contract the plane evaluation into
  FMAs, which moves depth by a few ulp (never an id).

Each stage is fed the JAX output of the previous stage, converted.  The
interpret-mode cases share one record-array shape (tests/raster_streams.py)
so each kernel compiles once.  The CUDA kernels are held against these
plain versions on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_renderer_tpu.ops import binning as jbin
from vk_renderer_tpu.ops import raster as jraster
from vk_renderer_tpu.ops import raster_pallas as jpallas
from vk_renderer_tpu.ops import setup as jsetup
from vk_renderer_tpu_torch.ops import binning as tbin
from vk_renderer_tpu_torch.ops import raster as traster
from vk_renderer_tpu_torch.ops import raster_kernels as rk
from vk_renderer_tpu_torch.ops import setup as tsetup

import torch_threads  # noqa: F401  (bounds torch's threads)
from raster_streams import (COLS, H, N_TILES, R, ROWS, SENT, TH, TW,
                            W, clip_scene, pad_records, synthetic_stream)


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Interpret-mode pallas executables embed host callbacks that the
    persistent compilation cache cannot (de)serialize (see
    tests/test_raster_pallas.py)."""
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


def _interpret(fn, *args, **kw):
    import unittest.mock as mock
    from jax.experimental import pallas as pl
    real_call = pl.pallas_call

    def fake_call(*a, **k):
        k["interpret"] = True
        return real_call(*a, **k)

    with mock.patch.object(jpallas.pl, "pallas_call", fake_call):
        return fn(*args, **kw)


def T(x):
    """jax/numpy array -> torch tensor (CPU)."""
    return torch.from_numpy(np.array(x))


def _planes(st):
    return {k: ([T(p) for p in v] if isinstance(v, list) else T(v))
            for k, v in st.items()}


@pytest.mark.parametrize("cull", [jsetup.CULL_NONE, jsetup.CULL_BACK,
                                  jsetup.CULL_FRONT])
def test_triangle_setup_matches_jax(cull):
    clip, tris = clip_scene(1, 50, w=320, h=96, w_cross=9)
    valid = np.ones(50, bool)
    valid[3] = False
    ref = jsetup.triangle_setup(
        tuple(jnp.asarray(clip[:, c]) for c in range(4)),
        tuple(jnp.asarray(tris[:, c]) for c in range(3)),
        jnp.asarray(valid), 320, 96, cull=cull)
    got = tsetup.triangle_setup(
        tuple(T(clip[:, c]) for c in range(4)),
        tuple(T(tris[:, c]) for c in range(3)), T(valid), 320, 96,
        cull=cull)
    np.testing.assert_array_equal(np.asarray(ref["valid"]),
                                  got["valid"].numpy())
    for key in ("edge", "zlin", "bbox", "anchor"):
        for a, b in zip(ref[key], got[key]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_transforms_and_cull_match_jax():
    rng = np.random.default_rng(2)
    v, o = 40, 3
    pos = rng.normal(size=(v, 3)).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    vert_obj = rng.integers(0, o, v).astype(np.int32)
    world = np.tile(np.eye(4, dtype=np.float32), (o, 1, 1))
    world[:, :3, :3] += rng.normal(scale=0.3, size=(o, 3, 3))
    world[:, :3, 3] = rng.normal(scale=3, size=(o, 3))
    vp = rng.normal(size=(4, 4)).astype(np.float32)
    bounds = np.concatenate([rng.normal(size=(o, 3)),
                             rng.uniform(0.5, 2, (o, 1))], 1
                            ).astype(np.float32)
    planes = rng.normal(size=(6, 4)).astype(np.float32)
    jw, jc = jsetup.transform_vertices(
        tuple(jnp.asarray(pos[:, c]) for c in range(3)),
        jnp.asarray(vert_obj), jnp.asarray(world), jnp.asarray(vp))
    tw_, tc = tsetup.transform_vertices(
        tuple(T(pos[:, c]) for c in range(3)), T(vert_obj), T(world), T(vp))
    jn = jsetup.transform_normals(
        tuple(jnp.asarray(nrm[:, c]) for c in range(3)),
        jnp.asarray(vert_obj), jnp.asarray(world))
    tn = tsetup.transform_normals(tuple(T(nrm[:, c]) for c in range(3)),
                                  T(vert_obj), T(world))
    for a, b in zip(jw + jc + jn, tw_ + tc + tn):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jsetup.cull_objects(jnp.asarray(world),
                                       jnp.asarray(bounds),
                                       jnp.asarray(planes))),
        tsetup.cull_objects(T(world), T(bounds), T(planes)).numpy())


def _jax_setup(seed, n, w=W, h=H, w_cross=0):
    clip, tris = clip_scene(seed, n, w, h, w_cross)
    return jsetup.triangle_setup(
        tuple(jnp.asarray(clip[:, c]) for c in range(4)),
        tuple(jnp.asarray(tris[:, c]) for c in range(3)),
        jnp.ones(n, bool), w, h, cull=jsetup.CULL_NONE)


@pytest.mark.parametrize("tile_h", [8, 32])
def test_binning_and_records_match_jax_exactly(tile_h):
    """Two buckets, tight caps (so cap and rec_cap overflow are counted)
    and a low max_span (so big triangles take the exact-coverage path)."""
    w, h, n = 384, 64, 60
    st = _jax_setup(4, n, w, h, w_cross=6)
    stt = _planes(st)
    bounds = ((0, 35), (35, n))
    kw = dict(tile_w=128, tile_h=tile_h, caps=(6, 40), rec_caps=(9, 64),
              max_span=2, big_cap=8)
    ref = jbin.bin_buckets_packed(st["bbox"], st["valid"], bounds, w, h,
                                  edge=st["edge"], anchor=st["anchor"], **kw)
    got = tbin.bin_buckets_packed(stt["bbox"], stt["valid"], bounds, w, h,
                                  edge=stt["edge"], anchor=stt["anchor"],
                                  **kw)
    assert int(ref[0]["overflow"]) > 0      # the tight caps bite
    for rp, gp in zip(ref, got):
        for key in ("rec_tri", "rec_tile", "rec_start", "counts",
                    "overflow"):
            np.testing.assert_array_equal(gp[key].numpy(),
                                          np.asarray(rp[key]), err_msg=key)
    jpad = jraster.pad_setup(st)
    tpad = _planes(jpad)
    cols = w // 128
    for rp in ref:
        want = jpallas.build_records(jpad, st["bbox"], rp["rec_tri"],
                                     rp["rec_tile"], cols, 128, tile_h)
        have = rk.build_records(tpad, stt["bbox"], T(rp["rec_tri"]),
                                T(rp["rec_tile"]), cols, 128, tile_h)
        np.testing.assert_array_equal(have.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_plan_view_buckets_shrinks_record_caps_like_jax():
    st = _jax_setup(5, 30)
    stt = _planes(st)
    got = traster.plan_view_buckets(stt, ((0, 30),), W, H, TW, TH, (64,),
                                    (4096,), max_span=4, big_cap=8)
    # raster.py:84-86: cdiv(30*4 + 8*4, 64) + 4 + 1
    assert got[0]["rec_tile"].shape[0] == 3 + N_TILES + 1


# ---------------------------------------------------------------------------
# the kernels' plain versions vs Pallas interpret mode
# ---------------------------------------------------------------------------

def _scene_stream():
    """Records of a random 40-triangle scene over the 2 x 2 tile grid,
    padded to R chunks."""
    st = _jax_setup(7, 40, w_cross=3)
    (plan,) = jbin.bin_buckets_packed(
        st["bbox"], st["valid"], ((0, 40),), W, H, tile_w=TW, tile_h=TH,
        caps=(64,), rec_caps=(R,), max_span=4, big_cap=8,
        edge=st["edge"], anchor=st["anchor"])
    assert int(plan["overflow"]) == 0
    rec = jpallas.build_records(jraster.pad_setup(st), st["bbox"],
                                plan["rec_tri"], plan["rec_tile"], COLS, TW,
                                TH)
    return (pad_records(rec), np.asarray(plan["rec_start"]),
            np.asarray(plan["counts"]).reshape(-1))


def _streams():
    return {"scene": _scene_stream(), "synthetic": synthetic_stream()}


def _tiles_np(img, fill):
    return np.asarray(jpallas._to_tiles(jnp.asarray(img), ROWS, COLS, TH, TW,
                                        fill))


def test_depth_raster_plain_matches_pallas_interpret():
    """rasterize_depth_packed on both sides, seeded with an init depth /
    id (partial), one Pallas compile for both streams."""
    rng = np.random.default_rng(9)
    # a partial init depth / id outside tile 0 (tile 0 starts cleared)
    init_d = np.where(rng.random((H, W)) < 0.3, 0.35, 1.0).astype(np.float32)
    init_d[:TH, :TW] = 1.0
    init_i = np.where(init_d < 1.0, 59, -1).astype(np.int32)
    for name, (rec, start, counts) in _streams().items():
        jd, ji = _interpret(
            jpallas.rasterize_depth_packed, jnp.asarray(rec),
            jnp.asarray(start), jnp.asarray(counts).reshape(ROWS, COLS), W,
            H, SENT, tile_w=TW, tile_h=TH, init_depth=jnp.asarray(init_d),
            init_id=jnp.asarray(init_i))
        td, ti = rk.rasterize_depth_packed(
            T(rec), T(start), T(counts).reshape(ROWS, COLS), W, H, SENT,
            tile_w=TW, tile_h=TH, init_depth=T(init_d), init_id=T(init_i))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji),
                                      err_msg=name)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        assert (ti.numpy() >= 0).sum() > 100, name
    # the synthetic tile 0, spelled out (rows 0-7, x < 128)
    ids = ti.numpy()
    assert ids[1, 10] == 11 and ids[1, 9] == 7      # left edge e == 0; tie
    assert ids[0, 19] == 12 and ids[0, 20] == 11    # right edge e == 0
    assert ids[1, 19] == 11                         # bottom edge e == 0
    assert ids[3, 30] == 14 and ids[2, 30] == 11    # top edge e == 0
    assert ids[1, 64] == 13 and ids[1, 63] == 11    # z == 0 kept, z < 0 not
    assert not np.isin(ids, [15, 16]).any()         # row-range gated out


def test_kbuffer_plain_matches_pallas_interpret():
    """rasterize_layers_grid with a bound (z <= bound) and a floor
    (z > floor; 2.0 blanks a pixel), K=3 < the synthetic tile's 12
    stacked layers; one Pallas compile for both streams."""
    rng = np.random.default_rng(10)
    bound = np.where(rng.random((H, W)) < 0.5, 0.65, 1.0).astype(np.float32)
    floor = rng.choice(np.array([-1.0, 0.15, 0.3, 2.0], np.float32),
                       size=(H, W))
    bt, ft = _tiles_np(bound, 2.0), _tiles_np(floor, 2.0)
    for name, (rec, start, counts) in _streams().items():
        outs = _interpret(jpallas.rasterize_layers_grid, jnp.asarray(rec),
                          jnp.asarray(start), jnp.asarray(counts),
                          jnp.asarray(bt), jnp.asarray(ft), SENT, 3,
                          tile_w=TW, tile_h=TH)
        d, i = rk.rasterize_layers_grid(T(rec), T(start), T(counts), T(bt),
                                        T(ft), SENT, 3, tile_w=TW,
                                        tile_h=TH)
        for k in range(3):
            np.testing.assert_array_equal(i[k].numpy(),
                                          np.asarray(outs[2 * k + 1]),
                                          err_msg=f"{name} layer {k}")
            np.testing.assert_allclose(d[k].numpy(), np.asarray(outs[2 * k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} layer {k}")
        assert (i[2].numpy() != SENT).sum() > 50, name


def test_kbuffer_equals_iterated_strict_peeling():
    """Layer k of the k-buffer == the k-th strict depth peel of the
    single-layer raster over the same records (raster.py:160-172), incl.
    coplanar ties (the later record wins, the tied one is skipped)."""
    for rec, start, counts in _streams().values():
        bound = torch.full((N_TILES, TH, TW), 0.95)
        d, i = rk.rasterize_layers_grid(T(rec), T(start), T(counts), bound,
                                        None, SENT, 4, tile_w=TW, tile_h=TH)
        floor = None
        for k in range(4):
            pd, pi = rk.rasterize_depth_grid(
                T(rec), T(start), T(counts), bound.clone(),
                torch.full((N_TILES, TH, TW), SENT, dtype=torch.int32),
                floor, tile_w=TW, tile_h=TH)
            found = pi != SENT
            ld = torch.where(found, pd, torch.tensor(2.0))
            assert torch.equal(i[k], pi), f"layer {k}"
            assert torch.equal(d[k], ld), f"layer {k}"
            floor = ld


def test_empty_streams_and_zeroed_counts():
    rec, start, counts = synthetic_stream()
    zero = np.zeros_like(counts)
    d, i = rk.rasterize_depth_grid(
        T(rec), T(start), T(zero), torch.ones((N_TILES, TH, TW)),
        torch.full((N_TILES, TH, TW), SENT, dtype=torch.int32), tile_h=TH)
    assert torch.all(d == 1.0) and torch.all(i == SENT)
    d, i = rk.rasterize_layers_grid(T(rec), T(start), T(zero),
                                    torch.ones((N_TILES, TH, TW)), None,
                                    SENT, 2, tile_h=TH)
    assert torch.all(d == 2.0) and torch.all(i == SENT)


def test_wrappers_reject_other_devices():
    rec, start, counts = synthetic_stream()
    meta = torch.empty(rec.shape, device="meta")
    with pytest.raises(ValueError):
        rk.rasterize_depth_grid(meta, T(start), T(counts), None, None)
    with pytest.raises(ValueError):
        rk.rasterize_layers_grid(meta, T(start), T(counts), None, None,
                                 SENT, 2)
