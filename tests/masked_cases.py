"""Synthetic inputs of the masked pass's resolve (ops/masked.py): one
round's k-buffer layers over a padded tile grid, the frame's triangle and
vertex row tables, a material table and a texture heap of odd sizes.

The layers hold random triangles at increasing depths with empty layers
anywhere in the stack (the k-buffer leaves them only at the end; the
resolve's rule, that a pending pixel resolves at its first empty layer,
holds wherever they are).  The triangle rows are random planes whose
scales spread the UV derivatives over every mip of the heap; the UVs run
outside [0, 1) so that the wrap modes matter.  The heap holds non-square
and odd textures (their chains end at 1x1), a 1x1 solid and a 128-wide
strip; alphas are uniform bytes, so about half of the tests pass.

Imports neither JAX nor the benchmark: the CPU tests and the card's tests
(tests/test_torch_cuda.py) both build their cases here."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from vk_renderer_tpu_torch.scene.textures import (WRAP_CLAMP, WRAP_MIRROR,
                                                  WRAP_REPEAT,
                                                  TextureHeapBuilder)
from vk_renderer_tpu_torch.scene.types import (TextureTable,
                                               textures_to_torch)

TH, TW = 32, 128
# a 300 x 70 frame in 3 x 3 tiles: padding past the last row and column
WIDTH, HEIGHT = 300, 70
COLS, ROWS = 3, 3
N_TRIS, N_VERTS, N_MATS = 97, 61, 7
TEX_SIZES = ((37, 13), (64, 64), (5, 128), (1, 1), (128, 3), (16, 16))


def _heap(rng, custom: bool, max_alpha: int):
    b = TextureHeapBuilder()
    for k, (w, h) in enumerate(TEX_SIZES):
        img = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
        img[..., 3] = rng.integers(0, max_alpha + 1, size=(h, w))
        mode = 0
        if custom:
            # every filter / mip / wrap combination over the slots
            mode = ((k & 1) | (k & 2) | ((k >> 1) & 1) << 2
                    | (WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR)[k % 3] << 3
                    | (WRAP_MIRROR, WRAP_REPEAT, WRAP_CLAMP)[k % 3] << 5)
        b.add(img, srgb=bool(k % 2), mipmapped=(w, h) != (1, 1),
              sampler_mode=mode)
    b.add_solid((0.2, 0.4, 0.6, 0.5))
    table = b.build()
    if custom:
        assert table.has_custom_samplers
    return table


def _rows(rng):
    """[T+1, 8] row tables (ops/interp.build_tri_rows' layout): random
    edge planes scaled per triangle, anchors in the frame, material and
    vertex ids; the last row is the sentinel's zeros."""
    t = N_TRIS
    scale = 10.0 ** rng.uniform(-4.0, -0.5, size=(t, 1))
    abc = rng.normal(size=(t, 9)) * np.concatenate(
        [scale, scale, np.ones((t, 1))] * 3, axis=1)
    abc[:, 2::3] += 1.0                     # c: the edge sums stay off 0
    row1 = abc[:, :8]
    row2 = np.zeros((t, 8))
    row2[:, 0] = abc[:, 8]
    row2[:, 1] = rng.uniform(0, WIDTH, t)
    row2[:, 2] = rng.uniform(0, HEIGHT, t)
    row2[:, 3] = rng.integers(0, N_MATS, t)
    row2[:, 4:7] = rng.integers(0, N_VERTS, (t, 3))
    pad = np.zeros((1, 8))
    return (torch.from_numpy(np.concatenate([row1, pad]).astype(np.float32)),
            torch.from_numpy(np.concatenate([row2, pad]).astype(np.float32)))


def scene_and_rows(seed: int, custom: bool = False, colours: bool = False,
                   max_alpha: int = 255):
    """(scene, rows, vattr) on the CPU: ``scene`` has what the resolve
    reads (``colors``, ``mat_tex_ids``, ``textures``); with ``colours``
    the vattr rows take the vertex-colour layout (UV in channels 6, 7).
    Texel alphas are uniform bytes up to ``max_alpha``: 255 passes about
    half of the tests, 150 few (long reject chains)."""
    rng = np.random.default_rng(seed)
    textures = textures_to_torch(_heap(rng, custom, max_alpha), "cpu")
    n_tex = int(textures.n_mips.shape[0])
    mat = np.stack([rng.integers(0, n_tex, N_MATS),
                    rng.integers(0, n_tex, N_MATS),
                    rng.integers(0, n_tex, N_MATS)], axis=1)
    vattr = rng.uniform(-1.5, 2.5, size=(N_VERTS, 8)).astype(np.float32)
    scene = SimpleNamespace(
        colors=(torch.ones(N_VERTS),) * 3 if colours else None,
        mat_tex_ids=torch.from_numpy(mat.astype(np.int32)),
        textures=textures)
    return scene, _rows(rng), torch.from_numpy(vattr)


def layers(seed: int, k_layers: int, empty_share: float = 0.15,
           n_tiles: int = COLS * ROWS):
    """(d f32, i i32) [K, G, TH, TW]: random triangles at increasing
    depths, each layer empty (2.0, -1) with ``empty_share``."""
    rng = np.random.default_rng(seed + 1000)
    shape = (k_layers, n_tiles, TH, TW)
    d = np.cumsum(rng.uniform(0.001, 0.05, size=shape), axis=0)
    i = rng.integers(0, N_TRIS, size=shape)
    empty = rng.uniform(size=shape) < empty_share
    d[empty] = 2.0
    i[empty] = -1
    return (torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(i.astype(np.int32)))


def state(seed: int, n_tiles: int = COLS * ROWS, continuing: bool = False):
    """The pass's state before a round: the opaque depth and ids, and
    for a continuation round pending (a random part of the frame) and
    deepest."""
    rng = np.random.default_rng(seed + 2000)
    shape = (n_tiles, TH, TW)
    depth = torch.from_numpy(rng.uniform(0.5, 1.0, shape).astype(np.float32))
    tid = torch.from_numpy(rng.integers(-1, N_TRIS, shape).astype(np.int32))
    if not continuing:
        return depth, tid, None, None
    from vk_renderer_tpu_torch.ops import masked
    valid, _, _ = masked._tile_geometry(n_tiles, TH, TW, COLS, WIDTH,
                                        HEIGHT, "cpu")
    pending = valid & torch.from_numpy(rng.uniform(size=shape) < 0.6)
    deepest = torch.from_numpy(rng.uniform(0.0, 0.4, shape)
                               .astype(np.float32))
    return depth, tid, pending, deepest


def on(dev, tree):
    """Tensors (and a scene's tensors) of a case moved to ``dev``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple):
        return tuple(on(dev, x) for x in tree)
    if isinstance(tree, SimpleNamespace):
        return SimpleNamespace(**{k: on(dev, v)
                                  for k, v in vars(tree).items()})
    if isinstance(tree, TextureTable):
        return dataclasses.replace(tree, **{
            f.name: on(dev, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree
