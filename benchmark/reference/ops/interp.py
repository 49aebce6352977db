"""Per-pixel attribute interpolation from the visibility buffer (planar).

Port of the narrow-row path of vk_renderer_tpu/ops/interp.py: given the
winning triangle per pixel, recompute the three inside-positive edge
functions at the pixel center and normalize — the 2DH identity makes
``e_i / sum(e)`` exactly the perspective-correct barycentric weights.
Attribute derivatives for texture LOD come from the closed-form quotient
rule on the same coefficients.

Per-pixel quantities are planar tensors of any shape (dense [H, W] or a
compacted 1-D pixel list with explicit centers); per-triangle data rides
two [T+1, 8] row tables.  (The JAX package's packed 48-wide and 24-wide
row tables are TPU gather-cost layouts of the same values and are not
ported.)
"""

from __future__ import annotations

import torch


def pixel_centers(height: int, width: int, device):
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :] \
        .expand(height, width) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=device)[:, None] \
        .expand(height, width) + 0.5
    return px, py


def build_tri_rows(setup_padded: dict, tris_p, tri_mat_p):
    """Everything per-pixel interpolation needs as two [T+1, 8] row
    tables:
    row1 = a0 b0 c0 a1 b1 c1 a2 b2
    row2 = c2 ax ay mat_id i0 i1 i2 pad   (ids as f32, exact below 2^24)"""
    e = setup_padded["edge"]
    anc = setup_padded["anchor"]
    f = torch.float32
    row1 = torch.stack([e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7]],
                       dim=-1)
    row2 = torch.stack([e[8], anc[0], anc[1], tri_mat_p.to(f),
                        tris_p[0].to(f), tris_p[1].to(f), tris_p[2].to(f),
                        torch.zeros_like(e[8])], dim=-1)
    return row1, row2


def interpolation_weights_rows(tri_id: torch.Tensor, row1: torch.Tensor,
                               row2: torch.Tensor, px=None, py=None):
    """Perspective-correct weights + plane coefficients for derivatives,
    plus per-pixel ``mat_id`` and corner vertex indices ``vidx``.
    ``px``/``py``: explicit pixel centers matching ``tri_id``'s shape
    (sparse shading); defaults to the dense [H, W] grid."""
    sentinel = row1.shape[0] - 1
    ids = torch.where(tri_id < 0, sentinel, tri_id).long()
    r1 = row1[ids]                                   # [..., 8]
    r2 = row2[ids]

    if px is None:
        h, w = tri_id.shape
        px, py = pixel_centers(h, w, tri_id.device)
    pxa = px - r2[..., 1]
    pya = py - r2[..., 2]

    a = (r1[..., 0], r1[..., 3], r1[..., 6])
    b = (r1[..., 1], r1[..., 4], r1[..., 7])
    c = (r1[..., 2], r1[..., 5], r2[..., 0])
    e = tuple(a[i] * pxa + b[i] * pya + c[i] for i in range(3))
    esum = e[0] + e[1] + e[2]
    esafe = torch.where(esum != 0.0, esum, torch.ones_like(esum))
    inv = 1.0 / esafe
    lam = tuple(ei * inv for ei in e)
    mat_id = r2[..., 3].to(torch.int32)
    vidx = tuple(r2[..., 4 + k].to(torch.int64) for k in range(3))
    return {"lam": lam, "a": a, "b": b, "inv_esum": inv, "mat_id": mat_id,
            "vidx": vidx}


def gather_corners(vrows: torch.Tensor, vidx):
    """The three per-corner row-gathers of a [V, C] attribute table —
    gathered once, feeding both interp_from_corners and
    derivs_from_corners."""
    return vrows[vidx[0]], vrows[vidx[1]], vrows[vidx[2]]


def interp_from_corners(corners, lam):
    """Interpolate every channel of pre-gathered corner rows."""
    c0, c1, c2 = corners
    n = c0.shape[-1]
    return tuple(c0[..., k] * lam[0] + c1[..., k] * lam[1]
                 + c2[..., k] * lam[2] for k in range(n))


def derivs_from_corners(corners, channels, weights: dict):
    """(value, d/dx, d/dy) for the requested channels of pre-gathered
    corner rows (quotient rule on the linear numerator/denominator)."""
    c0, c1, c2 = corners
    lam, a, b, inv = (weights["lam"], weights["a"], weights["b"],
                      weights["inv_esum"])
    dax = a[0] + a[1] + a[2]
    day = b[0] + b[1] + b[2]
    out = []
    for k in channels:
        v0, v1, v2 = c0[..., k], c1[..., k], c2[..., k]
        val = v0 * lam[0] + v1 * lam[1] + v2 * lam[2]
        nx = v0 * a[0] + v1 * a[1] + v2 * a[2]
        ny = v0 * b[0] + v1 * b[1] + v2 * b[2]
        out.append((val, (nx - val * dax) * inv, (ny - val * day) * inv))
    return out


def interp_rows(vrows: torch.Tensor, vidx, lam):
    """Interpolate a [V, C] row table with ONE row-gather per corner.
    Returns a tuple of C planar channels."""
    return interp_from_corners(gather_corners(vrows, vidx), lam)
