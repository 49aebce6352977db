"""Vertex transform and clipless triangle setup (feeds the rasterizer).

Port of vk_renderer_tpu/ops/setup.py: the vertex stage (shaders/mesh.vert:
14-24) and the fixed-function primitive assembly of the Vulkan pipeline as
2D-homogeneous triangle setup (Olano & Greer).  No data-dependent clipping:
triangles crossing w=0 are handled by the sign tests plus a per-pixel
interpolated-w>0 mask.

Everything is planar: positions/normals/clip arrive and leave as tuples of
1-D tensors, per-triangle outputs are dicts of 1-D planes:
- ``edge``: 9 planes (a,b,c per edge), inside-positive,
- ``zlin``: 3 planes — screen-linear depth ``z_ndc(p) = zlin . (px,py,1)``,
- ``bbox``: 4 planes (x0, y0, x1, y1) conservative pixel bounds,
- ``anchor``: 2 planes; edges are evaluated at (p - anchor),
- ``valid``: bool plane.

Vulkan front-face convention: FRONT_FACE_COUNTER_CLOCKWISE == ``det(M) < 0``
here (the spec's signed area carries a leading negation).
"""

from __future__ import annotations

import torch

CULL_NONE = 0
CULL_BACK = 1   # keep front faces (geometry pass, vk_engine_init.cpp:536)
CULL_FRONT = 2  # keep back faces (shadow/skybox, vk_engine_init.cpp:441,626)


def _world_rows(obj_world: torch.Tensor, vert_obj: torch.Tensor):
    """Per-vertex world-matrix row coefficients via flat gathers."""
    flat = obj_world.reshape(-1, 16)
    return [flat[:, c][vert_obj] for c in range(12)]


def transform_vertices(positions, vert_obj: torch.Tensor,
                       obj_world: torch.Tensor, viewproj: torch.Tensor):
    """World + clip transform for all vertices (mesh.vert:16,22).
    positions: (x, y, z) planar.  Returns (world (wx,wy,wz),
    clip (cx,cy,cz,cw)), all planar [V]."""
    m = _world_rows(obj_world, vert_obj)
    x, y, z = positions
    wx = m[0] * x + m[1] * y + m[2] * z + m[3]
    wy = m[4] * x + m[5] * y + m[6] * z + m[7]
    wz = m[8] * x + m[9] * y + m[10] * z + m[11]
    vp = viewproj
    clip = tuple(vp[r, 0] * wx + vp[r, 1] * wy + vp[r, 2] * wz + vp[r, 3]
                 for r in range(4))
    return (wx, wy, wz), clip


def transform_normals(normals, vert_obj: torch.Tensor,
                      obj_world: torch.Tensor):
    """World-space normals: mat3(world) @ n (mesh.vert:18, not normalized
    until the fragment stage).  Planar in/out."""
    m = _world_rows(obj_world, vert_obj)
    x, y, z = normals
    return (m[0] * x + m[1] * y + m[2] * z,
            m[4] * x + m[5] * y + m[6] * z,
            m[8] * x + m[9] * y + m[10] * z)


def cull_objects(obj_world: torch.Tensor, obj_bounds: torch.Tensor,
                 planes: torch.Tensor) -> torch.Tensor:
    """Sphere-vs-frustum visibility per render object
    (vk_engine_run.cpp:461-480): world center, radius scaled by the largest
    basis-column length, visible unless fully outside any plane."""
    centers = torch.einsum("oij,oj->oi", obj_world[:, :3, :3],
                           obj_bounds[:, :3]) + obj_world[:, :3, 3]
    col_scale = torch.linalg.norm(obj_world[:, :3, :3], dim=1)
    radius = obj_bounds[:, 3] * torch.amax(col_scale, dim=-1)
    dist = torch.einsum("pk,ok->op", planes[:, :3], centers) \
        + planes[None, :, 3]
    return torch.all(dist >= -radius[:, None], dim=1)


def gather_corner_positions(coords, tris) -> torch.Tensor:
    """One gather of per-vertex planar coords at every triangle corner:
    coords (cx, cy, cz[, cw]) over V, tris (i0, i1, i2) over T ->
    f32[C, 3, T] (component, corner, triangle).  Gather once and reuse
    across views that share geometry (the shadow cascades transform the
    same corners)."""
    return torch.stack(tuple(coords))[:, torch.stack(tuple(tris))]


def triangle_setup(clip, tris, tri_valid: torch.Tensor, width: int,
                   height: int, cull: int = CULL_BACK, corners=None):
    """Clipless 2DH setup.  clip: (cx,cy,cz,cw) planar over V;
    tris: (i0,i1,i2) planar over T.  ``tri_valid`` folds in the
    frustum-cull mask (and bucket masks).  ``corners``: optional
    pre-gathered per-corner clip coords (x, y, z, w), each a list of 3
    planes, [T] or [L, T] for L views at once (every step is elementwise,
    so the outputs then carry the leading L)."""
    if corners is not None:
        x, y, z, w = corners
    else:
        cx, cy, cz, cw = clip
        x = [cx[i] for i in tris]
        y = [cy[i] for i in tris]
        z = [cz[i] for i in tris]
        w = [cw[i] for i in tris]

    # fold the viewport transform into homogeneous screen coords
    X = [(x[k] + w[k]) * (0.5 * width) for k in range(3)]
    Y = [(y[k] + w[k]) * (0.5 * height) for k in range(3)]

    # Precision: evaluate in per-triangle anchored coordinates (homogeneous
    # translation by a point near the triangle) so cofactor magnitudes scale
    # with the triangle's screen extent, not the screen size.  Anchor =
    # projected bbox center (viewport center for w-crossing triangles).
    def safe(wk):
        return torch.where(torch.abs(wk) > 1e-12, wk,
                           torch.full_like(wk, 1e-12))

    sx = [X[k] / safe(w[k]) for k in range(3)]
    sy = [Y[k] / safe(w[k]) for k in range(3)]
    all_w_pos = (w[0] > 1e-12) & (w[1] > 1e-12) & (w[2] > 1e-12)
    sx_min = torch.minimum(torch.minimum(sx[0], sx[1]), sx[2])
    sx_max = torch.maximum(torch.maximum(sx[0], sx[1]), sx[2])
    sy_min = torch.minimum(torch.minimum(sy[0], sy[1]), sy[2])
    sy_max = torch.maximum(torch.maximum(sy[0], sy[1]), sy[2])
    half_w = torch.full_like(sx_min, 0.5 * width)
    half_h = torch.full_like(sy_min, 0.5 * height)
    ax = torch.clamp(torch.where(all_w_pos, 0.5 * (sx_min + sx_max), half_w),
                     0.0, width)
    ay = torch.clamp(torch.where(all_w_pos, 0.5 * (sy_min + sy_max), half_h),
                     0.0, height)
    X = [X[k] - ax * w[k] for k in range(3)]
    Y = [Y[k] - ay * w[k] for k in range(3)]

    # Per-vertex magnitude normalization conditions the f32 cofactors;
    # cofactor row i is rescaled by its own vertex's factor afterwards so a
    # common per-triangle factor S = s0*s1*s2 cancels in every ratio.
    s = [1.0 / torch.clamp(torch.maximum(torch.abs(X[k]),
                                         torch.maximum(torch.abs(Y[k]),
                                                       torch.abs(w[k]))),
                           min=1e-12)
         for k in range(3)]
    Xn = [X[k] * s[k] for k in range(3)]
    Yn = [Y[k] * s[k] for k in range(3)]
    wn = [w[k] * s[k] for k in range(3)]

    # cofactor rows of M = [[X0,Y0,w0],[X1,Y1,w1],[X2,Y2,w2]]
    def cof(j, k, si):
        return ((Yn[j] * wn[k] - Yn[k] * wn[j]) * si,
                (wn[j] * Xn[k] - wn[k] * Xn[j]) * si,
                (Xn[j] * Yn[k] - Xn[k] * Yn[j]) * si)

    e0 = cof(1, 2, s[0])
    e1 = cof(2, 0, s[1])
    e2 = cof(0, 1, s[2])
    # sum_i w_i e_i == (0, 0, det) identically; read det from the c-term
    det = w[0] * e0[2] + w[1] * e1[2] + w[2] * e2[2]

    front = det < 0.0   # Vulkan CCW front face (see module docstring)
    if cull == CULL_BACK:
        keep_facing = front
    elif cull == CULL_FRONT:
        keep_facing = ~front
    else:
        keep_facing = torch.ones_like(front)

    valid = (tri_valid & keep_facing & (det != 0.0)
             & ~((w[0] <= 0.0) & (w[1] <= 0.0) & (w[2] <= 0.0)))

    # conservative pixel bbox; triangles crossing w<=0 get the full viewport
    zero = torch.zeros_like(sx_min)
    x0 = torch.clamp(torch.where(all_w_pos, sx_min, zero), 0.0, width)
    x1 = torch.clamp(torch.where(all_w_pos, sx_max,
                                 torch.full_like(sx_max, float(width))),
                     0.0, width)
    y0 = torch.clamp(torch.where(all_w_pos, sy_min, zero), 0.0, height)
    y1 = torch.clamp(torch.where(all_w_pos, sy_max,
                                 torch.full_like(sy_max, float(height))),
                     0.0, height)
    valid = valid & (x1 > x0) & (y1 > y0)    # degenerate -> off-screen

    # orient edges inside-positive (e_i(vertex_i) == det -> flip by
    # sign(det)); invalid triangles get all-zero edges (e==0 everywhere
    # fails the top-left rule, so the rasterizer needs no extra mask)
    sgn = torch.where(valid, torch.where(det < 0, -1.0, 1.0),
                      0.0).to(det.dtype)
    edge = [c * sgn for e in (e0, e1, e2) for c in e]   # 9 planes

    # screen-linear depth: z(p) = (sum_i z_i e~_i(p)) / |det|
    inv_absdet = 1.0 / torch.where(det != 0.0, torch.abs(det),
                                   torch.ones_like(det))
    zlin = [(z[0] * edge[c] + z[1] * edge[3 + c] + z[2] * edge[6 + c])
            * inv_absdet for c in range(3)]

    return {"edge": edge, "zlin": zlin, "bbox": [x0, y0, x1, y1],
            "valid": valid, "anchor": [ax, ay]}
