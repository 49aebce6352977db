"""The masked pass's resolve (ops/masked.py) on the CPU: its plain
version, which the card's kernel is held to bit for bit
(tests/test_torch_cuda.py), against a frozen copy of the per-layer accept
loop that graph/frame._masked_pass ran before the resolve moved out of
it, on synthetic rounds (tests/masked_cases.py): random K with empty
layers anywhere in the stack, pixels that end pending, the frame-extent
mask over padded tiles, the probe layer, odd texture sizes with UVs
outside [0, 1), the custom-sampler path and the vertex-colour layout.
Imports no JAX."""

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch.ops import interp, masked
from vk_renderer_tpu_torch.ops import texture as tex
from vk_renderer_tpu_torch.ops.common import to_tiles

import masked_cases as mc
import torch_threads  # noqa: F401  (bounds torch's threads)


# ---- the frozen copy: graph/frame.py's _winner_alpha and the accept /
# accept_layers closures of _masked_pass as they were, with the tracing
# counter replaced by a list of the accept gathers' sizes
def _frozen_winner_alpha(scene, tid, rows, vattr, px, py):
    weights = interp.interpolation_weights_rows(tid, rows[0], rows[1],
                                                px, py)
    uvc = (3, 4) if scene.colors is None else (6, 7)   # vattr layout
    corners = interp.gather_corners(vattr, weights["vidx"])
    (u, dudx, dudy), (v, dvdx, dvdy) = interp.derivs_from_corners(
        corners, uvc, weights)
    aid = scene.mat_tex_ids[:, 0][weights["mat_id"].long()]
    (alpha,) = tex.sample_trilinear(scene.textures, aid, u, v,
                                    dudx, dvdx, dudy, dvdy, channels=(3,))
    return alpha


def _frozen_round(scene, rows, vattr, layers, peels_r, state, probe,
                  sizes):
    h, w = mc.HEIGHT, mc.WIDTH
    th, tw = mc.TH, mc.TW
    rows_t, cols_t = mc.ROWS, mc.COLS
    n_tile = rows_t * cols_t
    dev = layers[0][0].device
    valid_t = to_tiles(torch.ones((h, w), dtype=torch.bool, device=dev),
                       rows_t, cols_t, th, tw, False)
    g = torch.arange(n_tile, device=dev)[:, None, None]
    yy = torch.arange(th, device=dev)[None, :, None]
    xx = torch.arange(tw, device=dev)[None, None, :]
    px_t = ((g % cols_t) * tw + xx).expand(n_tile, th, tw) \
        .to(torch.float32).reshape(-1) + 0.5
    py_t = ((g // cols_t) * th + yy).expand(n_tile, th, tw) \
        .to(torch.float32).reshape(-1) + 0.5

    def accept(lt, dom):
        sel = torch.nonzero(dom.reshape(-1)).squeeze(1)
        sizes.append(sel.numel())
        acc = torch.zeros(dom.numel(), dtype=torch.bool, device=dev)
        if sel.numel():
            alpha = _frozen_winner_alpha(scene, lt.reshape(-1)[sel], rows,
                                         vattr, px_t[sel], py_t[sel])
            acc[sel] = alpha >= 0.5
        return acc.reshape(dom.shape)

    def accept_layers(layers, peels_r, state, probe):
        depth_t, tid_t, pending, deepest = state
        for k in range(peels_r):
            ld, lt = layers[k]
            dom = pending & (lt >= 0)
            acc = accept(lt, dom)
            depth_t = torch.where(acc, ld, depth_t)
            tid_t = torch.where(acc, lt, tid_t)
            pending = dom & ~acc
            deepest = torch.where(dom, ld, deepest)
        p = ((pending & (layers[-1][1] >= 0)).sum(dtype=torch.int32)
             if probe else torch.zeros((), dtype=torch.int32, device=dev))
        return (depth_t, tid_t, pending, deepest), p

    depth_t, tid_t, pending, deepest = state
    if pending is None:        # round 0
        pending = valid_t
        deepest = torch.zeros((n_tile, th, tw), dtype=torch.float32,
                              device=dev)
    return accept_layers(layers, peels_r, (depth_t, tid_t, pending,
                                           deepest), probe)


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


CASES = {   # id -> (seed, K, probe, custom samplers, vertex colours,
            #        continuation state, largest texel alpha)
    "k1": (1, 1, False, False, False, False, 255),
    "k4_probe": (2, 4, True, False, False, False, 255),
    "k10": (3, 10, False, False, False, False, 150),
    "k11_probe": (4, 11, True, False, False, True, 150),
    "k6_cont": (5, 6, False, False, False, True, 150),
    "k7_custom": (6, 7, True, True, False, False, 150),
    "k3_custom_cont": (7, 3, False, True, False, True, 255),
    "k5_colours": (8, 5, True, False, True, False, 255),
    "k9_custom_colours": (9, 9, True, True, True, True, 150),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_resolve_equals_the_frozen_accept_loop(case):
    seed, k_layers, probe, custom, colours, cont, max_alpha = CASES[case]
    scene, rows, vattr = mc.scene_and_rows(seed, custom, colours, max_alpha)
    d, i = mc.layers(seed, k_layers, empty_share=0.1)
    state = mc.state(seed, continuing=cont)
    n_walk = k_layers - 1 if probe and k_layers > 1 else k_layers
    sizes = []
    want, want_p = _frozen_round(scene, rows, vattr,
                                 [(d[k], i[k]) for k in range(k_layers)],
                                 n_walk, state, probe, sizes)
    tested = torch.zeros((), dtype=torch.int64)
    got, got_p = masked.masked_resolve(d, i, n_walk, probe, state, scene,
                                       rows, vattr, mc.COLS, mc.WIDTH,
                                       mc.HEIGHT, tested)
    for name, a, b in zip(("depth", "tid", "pending", "deepest"), got,
                          want):
        assert _bits_equal(a, b), name
    assert int(tested) == sum(sizes)
    if probe:
        assert int(got_p) == int(want_p)
    else:
        assert got_p is None and int(want_p) == 0
    # the case exercises what it is for: tests that pass and fail, pixels
    # still pending, pixels resolved at an empty layer, padding untouched
    acc = got[1] != state[1]
    assert bool(acc.any()) and sum(sizes) > int(acc.sum())
    assert bool(got[2].any())
    valid = masked._tile_geometry(mc.COLS * mc.ROWS, mc.TH, mc.TW, mc.COLS,
                                  mc.WIDTH, mc.HEIGHT, "cpu")[0]
    assert not bool((got[2] & ~valid).any())
    assert torch.equal(got[1][~valid], state[1][~valid])


def test_two_rounds_chain_like_the_frozen_loop():
    """Round 0 of K = 10 and a probe round of 6 + 1 on its state, as the
    pass chains them: state and the probe count equal the frozen loop's."""
    scene, rows, vattr = mc.scene_and_rows(11, max_alpha=140)
    d0, i0 = mc.layers(11, 10, empty_share=0.02)
    d1, i1 = mc.layers(12, 7, empty_share=0.1)
    st = mc.state(11)
    sizes = []
    want, _ = _frozen_round(scene, rows, vattr, list(zip(d0, i0)), 10, st,
                            False, sizes)
    want, want_p = _frozen_round(scene, rows, vattr, list(zip(d1, i1)), 6,
                                 want, True, sizes)
    tested = torch.zeros((), dtype=torch.int64)
    got, p0 = masked.masked_resolve(d0, i0, 10, False, st, scene, rows,
                                    vattr, mc.COLS, mc.WIDTH, mc.HEIGHT,
                                    tested)
    got, p1 = masked.masked_resolve(d1, i1, 6, True, got, scene, rows,
                                    vattr, mc.COLS, mc.WIDTH, mc.HEIGHT,
                                    tested)
    assert p0 is None and int(p1) == int(want_p) > 0
    assert int(tested) == sum(sizes)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)


def test_resolve_leaves_nothing_pending_behind_empty_layers():
    """Every layer empty: no pixel is tested, none stays pending, the
    state passes through."""
    scene, rows, vattr = mc.scene_and_rows(13)
    d, i = mc.layers(13, 3, empty_share=1.0)
    st = mc.state(13)
    tested = torch.zeros((), dtype=torch.int64)
    got, p = masked.masked_resolve(d, i, 2, True, st, scene, rows, vattr,
                                   mc.COLS, mc.WIDTH, mc.HEIGHT, tested)
    assert int(tested) == 0 and int(p) == 0
    assert not bool(got[2].any())
    assert torch.equal(got[0], st[0]) and torch.equal(got[1], st[1])
    assert torch.equal(got[3], torch.zeros_like(st[0]))


def test_resolve_rejects_a_device_it_has_no_path_for():
    scene, rows, vattr = mc.scene_and_rows(14)
    d, i = mc.layers(14, 2)
    with pytest.raises(ValueError):
        masked.masked_resolve(d.to("meta"), i.to("meta"), 2, False,
                              mc.state(14), scene, rows, vattr, mc.COLS,
                              mc.WIDTH, mc.HEIGHT)


def test_cases_reach_every_mip_and_both_sides_of_the_cutoff():
    """The synthetic rows spread the LOD over the heap's levels: the
    cases test what they claim to."""
    scene, rows, vattr = mc.scene_and_rows(1)
    n = mc.N_TRIS
    tid = torch.arange(n, dtype=torch.int32)
    px = torch.full((n,), 150.5)
    py = torch.full((n,), 35.5)
    w = interp.interpolation_weights_rows(tid, rows[0], rows[1], px, py)
    corners = interp.gather_corners(vattr, w["vidx"])
    (u, dudx, dudy), (v, dvdx, dvdy) = interp.derivs_from_corners(
        corners, (3, 4), w)
    aid = scene.mat_tex_ids[:, 0][w["mat_id"].long()]
    lod, _ = tex.compute_lod(scene.textures, aid, dudx, dvdx, dudy, dvdy)
    lod = lod.numpy()
    assert (lod == 0).any() and ((lod > 0) & (lod < 1)).any()
    assert (lod >= 3).any()
    assert ((u.numpy() < 0) | (u.numpy() >= 1)).any()
    alpha = masked.winner_alpha(scene, tid, rows, vattr, px, py).numpy()
    assert (alpha >= 0.5).any() and (alpha < 0.5).any()
    assert np.isfinite(alpha).mean() > 0.9
