"""Shared op-layer utilities.

Framebuffer layout convention (kept from the JAX package so the tests
compare like with like): color images are planar ``f32[3, H, W]``, depth
is ``f32[H, W]``, per-vertex / per-triangle data are tuples of 1-D
component tensors.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def to_tiles(img: torch.Tensor, rows: int, cols: int, th: int, tw: int,
             fill) -> torch.Tensor:
    """[H, W] -> [rows*cols, th, tw] (row-major tile order), padding the
    tile grid's overhang with ``fill``."""
    h, w = img.shape
    if (h, w) != (rows * th, cols * tw):
        padded = torch.full((rows * th, cols * tw), fill, dtype=img.dtype,
                            device=img.device)
        padded[:h, :w] = img
        img = padded
    return (img.reshape(rows, th, cols, tw).permute(0, 2, 1, 3)
            .reshape(rows * cols, th, tw))


def from_tiles(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[rows*cols, th, tw] -> [rows*th, cols*tw]."""
    _, th, tw = x.shape
    return (x.reshape(rows, cols, th, tw).permute(0, 2, 1, 3)
            .reshape(rows * th, cols * tw))


