"""Faithful Sponza-replica asset generator (VERDICT r3 Missing #2).

Port of vk_renderer_tpu/scene/sponza_replica.py (NumPy, no JAX): the same
generator, writing byte-equal GLB and KTX files; its PNG textures are
encoded here as PIL encodes them, so no PIL is needed either.

The reference renders ``assets/Sponza/Sponza.gltf`` + ``pisa_cube.ktx``
(src/vk_engine_init.cpp:650,677-678), but the assets are gitignored in its
repo too (.gitignore:3) and this environment has no network — so this
module RECONSTRUCTS an asset of the same class and scale, then writes it
through a real GLB container so the production glTF loader
(scene/gltf.py + scene/assembly.py, mirroring vk_loader.cpp:227-518)
ingests it exactly like the real thing:

- ~25 materials with the Khronos-Sponza material distribution (stone
  structure, 3 column types, 6+ fabric/curtain variants, vases, masked
  thorn/plant foliage, masked chains, lion relief, flagpoles);
- ~70 PNG textures embedded in the GLB (baseColor sRGB + normal +
  metallic-roughness per material — the normal maps land in metalRoughID
  through the reference's texture-ID-swap quirk, vk_loader.cpp:353-363,
  and ARE sampled as metallic-roughness, exactly like the reference
  renders the real Sponza);
- ~260-290k triangles of REAL topology: fluted columns and vases are
  lathe surfaces, arcade walls have semicircular arch openings, drapes
  have sine folds + catenary sag, foliage is clusters of crossed masked
  quads — triangle sizes and orientations span the same range the real
  asset's do (no axis-aligned-subdivided-quad monoculture);
- NO alpha-BLEND materials: the real Sponza has none (the reference's
  Transparent pipeline simply never fires on it);
- one mesh of ~100 primitives under a matrix-transform node, mirroring
  the real file's structure;
- ``pisa_cube.ktx``: a KTX1 R16G16B16A16_SFLOAT HDR cubemap — the real
  pisa asset's exact container/format class (vk_loader.cpp:521-558).

Everything is deterministic (fixed seeds): two builds produce identical
assets.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# texture synthesis (deterministic, Sponza-ish content classes)
# ---------------------------------------------------------------------------

def _value_noise(size, cells, seed, octaves=3):
    """Tileable multi-octave value noise in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        c = min(cells * (2 ** o), size)
        g = rng.uniform(0, 1, size=(c, c)).astype(np.float32)
        g = np.concatenate([g, g[:1]], axis=0)
        g = np.concatenate([g, g[:, :1]], axis=1)
        xs = np.linspace(0, c, size, endpoint=False)
        x0 = xs.astype(np.int64)
        fx = (xs - x0).astype(np.float32)
        fx = fx * fx * (3 - 2 * fx)
        a = g[x0][:, x0]
        b = g[x0 + 1][:, x0]
        cc = g[x0][:, x0 + 1]
        d = g[x0 + 1][:, x0 + 1]
        v = (a * (1 - fx[:, None]) + b * fx[:, None]) * (1 - fx[None, :]) + \
            (cc * (1 - fx[:, None]) + d * fx[:, None]) * fx[None, :]
        out += amp * v
        total += amp
        amp *= 0.5
    return out / total


def stone_texture(size, base_rgb, seed, blocks=8, mortar=0.12):
    """Ashlar stone blocks with mortar lines and per-block tint."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    row = (y * blocks).astype(np.int64)
    xoff = (row % 2) * 0.5
    col = ((x + xoff / blocks) * blocks).astype(np.int64)
    tint = rng.uniform(0.82, 1.05, size=(blocks + 2, 2 * blocks + 2)
                       ).astype(np.float32)[row, col]
    fy = (y * blocks) % 1.0
    fx = ((x + xoff / blocks) * blocks) % 1.0
    edge = (np.minimum(fy, 1 - fy) < mortar / 2) | \
           (np.minimum(fx, 1 - fx) < mortar / 2)
    n = _value_noise(size, 16, seed + 1)
    rgb = np.asarray(base_rgb, np.float32)[None, None] * \
        (tint * (0.85 + 0.3 * n))[..., None]
    rgb = np.where(edge[..., None], rgb * 0.55, rgb)
    out = np.concatenate([np.clip(rgb, 0, 1),
                          np.ones((size, size, 1), np.float32)], -1)
    return (out * 255).astype(np.uint8)


def fabric_texture(size, base_rgb, seed, stripes=0):
    """Woven fabric: fine warp/weft modulation, optional border stripes."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    weave = 0.9 + 0.1 * np.sin(x * size * np.pi / 2) * \
        np.sin(y * size * np.pi / 2)
    n = _value_noise(size, 8, seed)
    rgb = np.asarray(base_rgb, np.float32)[None, None] * \
        (weave * (0.8 + 0.35 * n))[..., None]
    if stripes:
        band = ((y > 0.05) & (y < 0.12)) | ((y > 0.88) & (y < 0.95))
        gold = np.array([0.85, 0.7, 0.25], np.float32)
        rgb = np.where(band[..., None], gold[None, None] * weave[..., None], rgb)
    out = np.concatenate([np.clip(rgb, 0, 1),
                          np.ones((size, size, 1), np.float32)], -1)
    return (out * 255).astype(np.uint8)


def leaf_texture(size, seed, kind="thorn"):
    """Foliage atlas with alpha holes (drives the masked bucket)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alpha = np.zeros((size, size), np.float32)
    green = np.zeros((size, size, 3), np.float32)
    n_leaves = 26 if kind == "thorn" else 14
    for _ in range(n_leaves):
        cx, cy = rng.uniform(0.1, 0.9, 2)
        ang = rng.uniform(0, np.pi)
        lw, lh = rng.uniform(0.03, 0.07), rng.uniform(0.1, 0.22)
        dx, dy = x - cx, y - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        inside = (u / lw) ** 2 + (v / lh) ** 2 < 1.0
        alpha = np.maximum(alpha, inside.astype(np.float32))
        shade = rng.uniform(0.5, 1.0)
        col = np.array([0.12 * shade, (0.45 + 0.3 * shade), 0.1], np.float32)
        green = np.where(inside[..., None], col[None, None], green)
    n = _value_noise(size, 12, seed + 3)
    green *= (0.7 + 0.5 * n)[..., None]
    out = np.concatenate([np.clip(green, 0, 1), alpha[..., None]], -1)
    return (out * 255).astype(np.uint8)


def normal_map(size, seed, strength=2.0, cells=12):
    """Tangent-space normal map derived from a noise height field.
    Through the reference's ID swap this is SAMPLED as metallic-roughness:
    metallic reads .b (~1.0 * metallicFactor), roughness reads .g."""
    h = _value_noise(size, cells, seed, octaves=4)
    gx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    gy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    nz = np.ones_like(h) / strength
    ln = np.sqrt(gx * gx + gy * gy + nz * nz)
    n = np.stack([-gx / ln, -gy / ln, nz / ln], -1) * 0.5 + 0.5
    out = np.concatenate([n, np.ones((size, size, 1), np.float32)], -1)
    return (out * 255).astype(np.uint8)


def mr_texture(size, rough, seed):
    """Metallic-roughness map (G=roughness, B=metallic) — stored but never
    sampled by the reference (the ID swap routes it to normalID)."""
    n = _value_noise(size, 10, seed)
    g = np.clip(rough * (0.8 + 0.4 * n), 0, 1)
    out = np.stack([np.zeros_like(g), g, np.full_like(g, 0.0),
                    np.ones_like(g)], -1)
    return (out * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# geometry library (real-topology builders)
# ---------------------------------------------------------------------------

def _grid(origin, du, dv, nu, nv, uv_scale=(1.0, 1.0), fold=None, seed=None):
    """Subdivided parallelogram patch.  ``fold(u, v) -> displacement[3]``
    adds real-topology relief (drape folds, floor unevenness)."""
    origin = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64)
    dv = np.asarray(dv, np.float64)
    gu, gv = np.meshgrid(np.linspace(0, 1, nu + 1),
                         np.linspace(0, 1, nv + 1), indexing="ij")
    pos = origin[None, None] + gu[..., None] * du + gv[..., None] * dv
    if fold is not None:
        pos = pos + fold(gu, gv)
    pos = pos.reshape(-1, 3)
    uv = np.stack([gu * uv_scale[0], gv * uv_scale[1]],
                  -1).reshape(-1, 2)
    idx = lambda i, j: i * (nv + 1) + j
    tris = []
    for i in range(nu):
        for j in range(nv):
            a, b, c, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    tris = np.array(tris, np.int64)
    nrm = _smooth_normals(pos, tris)
    return pos.astype(np.float32), nrm, uv.astype(np.float32), tris


def _smooth_normals(pos, tris):
    """Area-weighted vertex normals (what exporters emit for curved work)."""
    n = np.zeros_like(pos)
    p = pos[tris]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def _flip(part):
    pos, nrm, uv, tris = part
    return pos, -nrm, uv, tris[:, ::-1]


def lathe(profile, segments, center=(0, 0, 0), uv_v=None, cap_top=False,
          cap_bottom=False, flutes=0, flute_depth=0.0):
    """Surface of revolution around +Y: ``profile`` = [(radius, y), ...]
    bottom-to-top.  ``flutes`` modulates the radius around the circle
    (fluted Sponza column shafts).  CCW from outside."""
    profile = np.asarray(profile, np.float64)
    nv = profile.shape[0]
    ang = np.linspace(0, 2 * np.pi, segments + 1)
    if uv_v is None:
        seg = np.concatenate([[0], np.cumsum(
            np.linalg.norm(np.diff(profile, axis=0), axis=1))])
        uv_v = seg / max(seg[-1], 1e-9)
    r = profile[:, 0][None, :] * (
        1.0 - flute_depth * 0.5 *
        (1 + np.cos(ang[:, None] * flutes)) if flutes else
        np.ones((segments + 1, nv)))
    x = np.cos(ang)[:, None] * r
    z = np.sin(ang)[:, None] * r
    y = np.broadcast_to(profile[:, 1][None, :], x.shape)
    pos = np.stack([x, y, z], -1).reshape(-1, 3) + np.asarray(center, np.float64)
    uv = np.stack(np.meshgrid(ang / (2 * np.pi) * 4.0, uv_v, indexing="ij"),
                  -1).reshape(-1, 2)
    idx = lambda s, v: s * nv + v
    tris = []
    for s in range(segments):
        for v in range(nv - 1):
            a, b = idx(s, v), idx(s + 1, v)
            c, d = idx(s + 1, v + 1), idx(s, v + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    pos = np.asarray(pos)
    base = pos.shape[0]
    uv = list(uv)
    pos = list(pos)
    if cap_top or cap_bottom:
        caps = []
        if cap_bottom:
            caps.append((profile[0], -1))
        if cap_top:
            caps.append((profile[-1], +1))
        for (pr, sgn) in caps:
            cidx = len(pos)
            pos.append(np.array([center[0], pr[1] + center[1], center[2]]))
            uv.append(np.array([0.5, 0.5]))
            ring0 = 0 if sgn < 0 else nv - 1
            for s in range(segments):
                a, b = idx(s, ring0), idx(s + 1, ring0)
                tris.append([cidx, b, a] if sgn < 0 else [cidx, a, b])
        base = len(pos)
    pos = np.asarray(pos, np.float64)
    tris = np.array(tris, np.int64)
    nrm = _smooth_normals(pos, tris)
    return (pos.astype(np.float32), nrm,
            np.asarray(uv, np.float32), tris)


def arch_wall(width, height, arch_r, z, seed, rings=5, segs=16, facing=1):
    """Wall panel with a semicircular arch opening at the bottom center:
    a radial band around the opening + side/top fill, triangulated like a
    real modeling tool would (fans and strips, varied triangle shapes)."""
    spring_y = height - arch_r          # arch springs from this height? no:
    spring_y = arch_r                   # arch center at (0, arch_r)
    outer = max(width / 2, height - spring_y) * 1.999
    ang = np.linspace(0, np.pi, segs + 1)
    pos, uv, tris = [], [], []

    def clampr(a, r):
        """Point at angle a, radius r from arch center, clamped to panel."""
        x = np.cos(a) * r
        y = spring_y + np.sin(a) * r
        x = np.clip(x, -width / 2, width / 2)
        y = np.clip(y, 0.0, height)
        return x, y

    rs = np.concatenate([[arch_r], arch_r + (outer - arch_r) *
                         np.linspace(0.15, 1.0, rings) ** 1.4])
    for ri, r in enumerate(rs):
        for a in ang:
            x, y = clampr(a, r)
            pos.append([x, y, z])
            uv.append([x / width + 0.5, 1 - y / height])
    idx = lambda ri, ai: ri * (segs + 1) + ai
    for ri in range(len(rs) - 1):
        for ai in range(segs):
            a, b = idx(ri, ai), idx(ri, ai + 1)
            c, d = idx(ri + 1, ai + 1), idx(ri + 1, ai)
            if facing > 0:
                tris.append([a, b, c]); tris.append([a, c, d])
            else:
                tris.append([a, c, b]); tris.append([a, d, c])
    # bottom side fills (below the spring line, beside the opening)
    for side in (-1, 1):
        x_in = side * arch_r
        x_out = side * width / 2
        b0 = len(pos)
        for (x, y) in [(x_in, 0), (x_out, 0), (x_out, spring_y),
                       (x_in, spring_y)]:
            pos.append([x, y, z])
            uv.append([x / width + 0.5, 1 - y / height])
        order = [b0, b0 + 1, b0 + 2, b0, b0 + 2, b0 + 3]
        if (side > 0) != (facing > 0):
            order = [order[0], order[2], order[1],
                     order[3], order[5], order[4]]
        tris += [order[:3], order[3:]]
    pos = np.asarray(pos, np.float64)
    tris = np.asarray(tris, np.int64)
    nrm = np.tile(np.array([0, 0, facing], np.float32), (pos.shape[0], 1))
    return pos.astype(np.float32), nrm, np.asarray(uv, np.float32), tris


def drape(center, w, h, nu, nv, seed, folds=5, sag=0.25):
    """Hanging fabric with sine folds + catenary sag (real Sponza drapes)."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi)
    amp = 0.06 * w

    def fold(gu, gv):
        dz = amp * np.sin(gu * folds * 2 * np.pi + phase) * (0.3 + 0.7 * gv) \
            + sag * np.sin(gv * np.pi) * 0.3
        return np.stack([np.zeros_like(gu), np.zeros_like(gu), dz], -1)

    c = np.asarray(center, np.float64)
    return _grid(c + [-w / 2, h / 2, 0], [w, 0, 0], [0, -h, 0], nu, nv,
                 uv_scale=(2.0, 2.0), fold=fold)


def foliage_cluster(center, n_quads, seed, size=(0.25, 0.55)):
    """Crossed masked quads around a center — vase plants / thorn bushes.
    Quads scatter across the cluster's full footprint (real foliage is a
    volume of leaves, not N planes through one axis — a tight cluster
    would also stack 20+ alpha-reject layers on a single ray, far beyond
    the real asset class's peel depth)."""
    rng = np.random.default_rng(seed)
    parts = []
    spread = np.array([2.4, 0.8, 2.4]) * max(size)
    for _ in range(n_quads):
        ang = rng.uniform(0, np.pi)
        s = rng.uniform(*size)
        tilt = rng.uniform(-0.4, 0.4)
        d = np.array([np.cos(ang), tilt, np.sin(ang)]) * s
        up = np.array([0, 1.6 * s, 0])
        off = rng.uniform(-0.5, 0.5, 3) * spread
        c = np.asarray(center, np.float64) + off
        parts.append(_grid(c - d / 2, d, up, 2, 3))
    return parts


def chain_run(top, length, n_links, seed):
    """Hanging chain of small crossed masked quads."""
    parts = []
    top = np.asarray(top, np.float64)
    for i in range(n_links):
        y = -length * (i + 0.5) / n_links
        s = 0.06
        c = top + [0, y, 0]
        parts.append(_grid(c + [-s, s, 0], [2 * s, 0, 0], [0, -2 * s, 0], 1, 2))
        parts.append(_grid(c + [0, s, -s], [0, 0, 2 * s], [0, -2 * s, 0], 1, 2))
    return parts


def _merge(parts):
    """Concatenate (pos, nrm, uv, tris) parts into one primitive."""
    pos, nrm, uv, tris = [], [], [], []
    base = 0
    for (p, n, u, t) in parts:
        pos.append(p); nrm.append(n); uv.append(u)
        tris.append(t + base)
        base += p.shape[0]
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(uv),
            np.concatenate(tris))


def _double_sided(part):
    """Emit both windings (exporters do this for doubleSided foliage —
    the reference backface-culls, so single-sided foliage would vanish
    from half the views)."""
    pos, nrm, uv, tris = part
    return _merge([part, _flip((pos.copy(), nrm.copy(), uv.copy(),
                                tris.copy()))])


# ---------------------------------------------------------------------------
# the atrium
# ---------------------------------------------------------------------------

def build_geometry(scale=1.0):
    """Returns list of (name, material_key, (pos, nrm, uv, tris))."""
    prims = []
    S = scale  # subdivision multiplier

    def gs(n):
        return max(2, int(n * S))

    # ---- floor: stone tiles with slight unevenness (fixed density — the
    # real Sponza floor is low-poly relative to its ornaments)
    def floor_fold(gu, gv):
        h = 0.015 * np.sin(gu * 47.0) * np.cos(gv * 31.0)
        return np.stack([np.zeros_like(gu), h, np.zeros_like(gu)], -1)

    # +x cross -z = +y: upward-facing winding (CCW seen from above)
    prims.append(("floor", "floor",
                  _grid([-16, 0, 8], [32, 0, 0], [0, 0, -16], 110, 55,
                        uv_scale=(16, 8), fold=floor_fold)))
    # ---- ceiling: -y facing (seen from below, inside the hall)
    prims.append(("ceiling", "ceiling",
                  _grid([-16, 11.5, -8], [32, 0, 0], [0, 0, 16],
                        gs(48), gs(24), uv_scale=(12, 6))))
    # ---- roof slopes (visible through the atrium opening)
    prims.append(("roof_a", "roof",
                  _grid([-16, 11.5, -8], [32, 0, 0], [0, 2.2, -2.5],
                        gs(40), gs(8), uv_scale=(16, 2))))
    prims.append(("roof_b", "roof",
                  _grid([-16, 11.5, 8], [32, 0, 0], [0, 2.2, 2.5],
                        gs(40), gs(8), uv_scale=(16, 2))))

    # ---- arcade walls: two levels, bays with arch openings, both sides
    bays = 7
    bay_w = 32.0 / bays
    for level, (y0, hh, r) in enumerate([(0.0, 5.0, 1.6), (5.0, 4.0, 1.3)]):
        for zi, z in enumerate((-6.0, 6.0)):
            panels = []
            facing = 1 if z < 0 else -1
            for b in range(bays):
                x0 = -16 + b * bay_w
                p = arch_wall(bay_w, hh, r, 0.0, seed=level * 10 + b,
                              rings=gs(5), segs=gs(14), facing=facing)
                pos, nrm, uv, tris = p
                pos = pos + np.array([x0 + bay_w / 2, y0, z], np.float32)
                panels.append((pos, nrm, uv, tris))
            prims.append((f"arcade_l{level}_z{zi}", "arch", _merge(panels)))
    # ---- end walls (solid stone)
    prims.append(("end_wall_w", "bricks",
                  _grid([-16, 0, 6], [0, 0, -12], [0, 11.5, 0], gs(24), gs(20),
                        uv_scale=(6, 5))))
    prims.append(("end_wall_e", "bricks",
                  _grid([16, 0, -6], [0, 0, 12], [0, 11.5, 0], gs(24), gs(20),
                        uv_scale=(6, 5))))
    # ---- back walls behind the arcades
    for zi, z in enumerate((-7.8, 7.8)):
        facing = 1 if z < 0 else -1
        part = _grid([-16, 0, z], [32, 0, 0], [0, 11.5, 0], gs(40), gs(16),
                     uv_scale=(14, 5))
        if facing < 0:
            part = _flip(part)
        prims.append((f"back_wall_{zi}", "background", part))

    # ---- columns: lower fluted, upper plain; capitals + bases
    col_mats = ["column_a", "column_b", "column_c"]
    shaft_profile = [(0.32, 0.0), (0.30, 0.4), (0.27, 2.2), (0.26, 3.6),
                     (0.28, 4.2)]
    cap_profile = [(0.28, 0.0), (0.42, 0.25), (0.5, 0.45), (0.5, 0.55)]
    base_profile = [(0.5, 0.0), (0.46, 0.18), (0.34, 0.3), (0.32, 0.42)]
    for level, (y0, sh) in enumerate([(0.0, 1.0), (5.0, 0.8)]):
        for b in range(bays + 1):
            x = -16 + b * bay_w
            for zi, z in enumerate((-6.0, 6.0)):
                mat = col_mats[(b + zi + level) % 3]
                parts = [
                    lathe([(r * sh, y * sh) for (r, y) in base_profile],
                          gs(18), center=(x, y0, z)),
                    lathe([(r * sh, 0.42 * sh + y * sh)
                           for (r, y) in shaft_profile],
                          gs(30), center=(x, y0, z),
                          flutes=20, flute_depth=0.12),
                    lathe([(r * sh, (0.42 + 4.2) * sh + y * sh)
                           for (r, y) in cap_profile],
                          gs(18), center=(x, y0, z), cap_top=True),
                ]
                prims.append((f"col_l{level}_{b}_{zi}", mat, _merge(parts)))

    # ---- fabric: long drapes between upper columns + banners
    fabrics = ["fabric_a", "fabric_c", "fabric_d", "fabric_e", "fabric_f",
               "fabric_g"]
    di = 0
    # fabric is doubleSided in the real Sponza (its exporter emits both
    # windings' visibility via the material flag; we bake both windings
    # so the back-face-culled reference pipeline shows both sides)
    for b in range(bays):
        x = -16 + (b + 0.5) * bay_w
        for zi, z in enumerate((-5.4, 5.4)):
            if (b + zi) % 2 == 0:
                prims.append((f"drape_{di}", fabrics[di % len(fabrics)],
                              _double_sided(
                                  drape([x, 9.2, z], bay_w * 0.8, 3.4,
                                        gs(18), gs(14), seed=40 + di))))
                di += 1
    for i, x in enumerate(np.linspace(-12, 12, 5)):
        prims.append((f"banner_{i}", "curtain_red" if i % 2 else
                      "curtain_green",
                      _double_sided(
                          drape([x, 10.8, 0.0], 1.6, 4.5, gs(10), gs(17),
                                seed=60 + i, folds=3))))

    # ---- vases (lathe) + plants (masked foliage) on the floor
    vase_profile = [(0.02, 0.0), (0.22, 0.06), (0.3, 0.5), (0.16, 0.9),
                    (0.2, 1.05), (0.24, 1.1)]
    vi = 0
    for x in np.linspace(-13, 13, 6):
        for z in (-4.6, 4.6):
            prims.append((f"vase_{vi}", "vase_round",
                          lathe(vase_profile, gs(26), center=(x, 0, z))))
            plant = _merge(foliage_cluster([x, 1.0, z], gs(26),
                                           seed=100 + vi))
            prims.append((f"plant_{vi}", "plant", _double_sided(plant)))
            vi += 1
    # thorn bushes along the center line
    for i, x in enumerate(np.linspace(-14, 14, 9)):
        bush = _merge(foliage_cluster([x, 0.5, 0.0], gs(30), seed=200 + i,
                                      size=(0.35, 0.8)))
        prims.append((f"thorn_{i}", "thorn", _double_sided(bush)))

    # ---- hanging vases on chains
    hv_profile = [(0.02, 0.0), (0.18, 0.1), (0.22, 0.35), (0.12, 0.5)]
    for i, x in enumerate(np.linspace(-10, 10, 4)):
        z = 2.5 if i % 2 else -2.5
        prims.append((f"hang_vase_{i}", "vase_hanging",
                      lathe(hv_profile, gs(22), center=(x, 6.8, z))))
        chain = _merge(chain_run([x, 9.2, z], 2.0, gs(12), seed=300 + i))
        prims.append((f"chain_{i}", "chain", _double_sided(chain)))

    # ---- lion reliefs on the end walls (lathe hemispheres, dense)
    lion_profile = [(0.01, 0.0), (0.5, 0.1), (0.75, 0.35), (0.8, 0.6),
                    (0.6, 0.9), (0.2, 1.05), (0.01, 1.1)]
    for i, x in enumerate((-15.7, 15.7)):
        pos, nrm, uv, tris = lathe(lion_profile, gs(40), center=(0, 0, 0))
        # rotate lathe axis to face into the hall
        sgn = 1.0 if x < 0 else -1.0
        pos = np.stack([pos[:, 1] * sgn * 0.8 + x, pos[:, 0] * 0.9 + 5.5,
                        pos[:, 2] * 0.9], -1).astype(np.float32)
        tris = tris if sgn > 0 else tris[:, ::-1]
        nrm = _smooth_normals(pos.astype(np.float64), tris)
        prims.append((f"lion_{i}", "lion", (pos, nrm, uv, tris)))

    # ---- flagpoles (thin lathes, metallic-factor material)
    for i, x in enumerate(np.linspace(-12, 12, 5)):
        prims.append((f"flagpole_{i}", "flagpole",
                      lathe([(0.05, 0.0), (0.05, 3.2), (0.09, 3.3),
                             (0.01, 3.45)], gs(10),
                            center=(x, 8.6, 0.0))))

    # ---- detail trim: cornice boxes along the beams
    trims = []
    for z in (-5.6, 5.6):
        # face the hall center: +z normal on the -z side, -z on the +z side
        zo = z - 0.15 if z < 0 else z + 0.15
        for y0 in (4.9, 9.0):
            part = _grid([-16, y0, zo], [32, 0, 0], [0, 0.25, 0],
                         gs(60), 2, uv_scale=(30, 0.5))
            trims.append(part if z < 0 else _flip(part))
    prims.append(("trim", "details", _merge(trims)))
    return prims


# material table: Khronos-Sponza-like distribution.
# key -> (baseColor builder, roughness, metallicFactor, has_normal, has_mr)
def _material_specs():
    return {
        "floor": (lambda s: stone_texture(s, (0.55, 0.47, 0.42), 10, blocks=12), 0.8, 0.0, True, True),
        "ceiling": (lambda s: stone_texture(s, (0.6, 0.55, 0.5), 11, blocks=6), 0.9, 0.0, True, True),
        "roof": (lambda s: stone_texture(s, (0.55, 0.28, 0.2), 12, blocks=20, mortar=0.2), 0.85, 0.0, True, True),
        "arch": (lambda s: stone_texture(s, (0.62, 0.55, 0.47), 13, blocks=8), 0.75, 0.0, True, True),
        "bricks": (lambda s: stone_texture(s, (0.58, 0.45, 0.35), 14, blocks=16, mortar=0.15), 0.8, 0.0, True, True),
        "background": (lambda s: stone_texture(s, (0.5, 0.46, 0.42), 15, blocks=10), 0.9, 0.0, True, False),
        "column_a": (lambda s: stone_texture(s, (0.6, 0.55, 0.48), 16, blocks=5), 0.7, 0.0, True, True),
        "column_b": (lambda s: stone_texture(s, (0.57, 0.5, 0.44), 17, blocks=5), 0.7, 0.0, True, True),
        "column_c": (lambda s: stone_texture(s, (0.63, 0.58, 0.5), 18, blocks=5), 0.7, 0.0, True, True),
        "details": (lambda s: stone_texture(s, (0.5, 0.42, 0.35), 19, blocks=24), 0.6, 0.1, True, True),
        "fabric_a": (lambda s: fabric_texture(s, (0.6, 0.12, 0.1), 20, stripes=1), 1.0, 0.0, True, True),
        "fabric_c": (lambda s: fabric_texture(s, (0.1, 0.35, 0.12), 21, stripes=1), 1.0, 0.0, True, True),
        "fabric_d": (lambda s: fabric_texture(s, (0.12, 0.15, 0.45), 22), 1.0, 0.0, True, True),
        "fabric_e": (lambda s: fabric_texture(s, (0.5, 0.4, 0.1), 23), 1.0, 0.0, True, True),
        "fabric_f": (lambda s: fabric_texture(s, (0.45, 0.1, 0.3), 24, stripes=1), 1.0, 0.0, True, True),
        "fabric_g": (lambda s: fabric_texture(s, (0.3, 0.3, 0.3), 25), 1.0, 0.0, True, True),
        "curtain_red": (lambda s: fabric_texture(s, (0.55, 0.1, 0.08), 26, stripes=1), 1.0, 0.0, True, True),
        "curtain_green": (lambda s: fabric_texture(s, (0.1, 0.4, 0.1), 27, stripes=1), 1.0, 0.0, True, True),
        "vase_round": (lambda s: stone_texture(s, (0.35, 0.3, 0.28), 28, blocks=3, mortar=0.0), 0.4, 0.2, True, True),
        "vase_hanging": (lambda s: stone_texture(s, (0.4, 0.3, 0.2), 29, blocks=3, mortar=0.0), 0.35, 0.6, True, True),
        "plant": (lambda s: leaf_texture(s, 30, kind="plant"), 0.9, 0.0, True, False),
        "thorn": (lambda s: leaf_texture(s, 31, kind="thorn"), 0.9, 0.0, True, False),
        "chain": (lambda s: leaf_texture(s, 32, kind="thorn"), 0.5, 0.8, True, False),
        "lion": (lambda s: stone_texture(s, (0.55, 0.45, 0.3), 33, blocks=2, mortar=0.0), 0.5, 0.3, True, True),
        "flagpole": (lambda s: stone_texture(s, (0.5, 0.4, 0.25), 34, blocks=2, mortar=0.0), 0.3, 0.9, True, False),
    }


# ---------------------------------------------------------------------------
# GLB writer
# ---------------------------------------------------------------------------

def _png_bytes(rgba_u8):
    """u8[H, W, 4] -> PNG bytes, equal to what PIL's PNG writer (the JAX
    package's encoder here) gives with its defaults, without PIL: each row
    takes the filter of least sum of |signed byte| among none, up, sub
    and Paeth, tried in that order, a later one only if strictly smaller
    (PIL's ZipEncode.c, average left out as PIL does without
    ``optimize``); zlib at the default level with strategy Z_FILTERED,
    window 15, memLevel 9; IDAT chunks of 65536 bytes."""
    h, w, c = rgba_u8.shape
    raw = np.ascontiguousarray(rgba_u8, np.uint8).reshape(h, w * c)
    comp = zlib.compressobj(-1, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = []
    prev = np.zeros(w * c, np.uint8)
    for line in raw:
        data.append(comp.compress(_filter_row(line, prev, c)))
        prev = line
    data = b"".join(data) + comp.flush()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    color = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[i:i + 65536])
                       for i in range(0, len(data), 65536))
            + chunk(b"IEND", b""))


def _filter_row(line, prev, bpp: int) -> bytes:
    """One PNG row, filter byte first, as PIL filters it (_png_bytes)."""
    def cost(v):
        v = v.astype(np.int64)
        return int(np.where(v < 128, v, 256 - v).sum())

    zero = np.zeros(bpp, np.uint8)
    left = np.concatenate([zero, line[:-bpp]])
    best, kind, s = line, 0, cost(line)
    for k in (2, 1, 4):            # up, sub, Paeth
        if s == 0:
            break
        if k == 2:
            v = line - prev
        elif k == 1:
            v = line - left
        else:
            v = line - _paeth(left, prev, np.concatenate([zero, prev[:-bpp]]))
        sv = cost(v)
        if sv < s:
            best, kind, s = v, k, sv
    return bytes([kind]) + best.tobytes()


def _paeth(a, b, c):
    """The Paeth predictor of u8 rows (left a, up b, up-left c)."""
    a, b, c = (x.astype(np.int64) for x in (a, b, c))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def write_glb(path, tex_size=512, aux_size=256, scale=1.0,
              verbose=False):
    """Generate + write the replica GLB.  Returns (n_tris, n_textures)."""
    prims = build_geometry(scale=scale)
    specs = _material_specs()

    blob = bytearray()

    def align(n=4):
        while len(blob) % n:
            blob.append(0)

    buffer_views = []
    accessors = []
    images = []
    textures = []
    samplers = [{"magFilter": 9729, "minFilter": 9987,
                 "wrapS": 10497, "wrapT": 10497}]

    def add_view(data: bytes, target=None, stride=None):
        align()
        bv = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if target:
            bv["target"] = target
        if stride:
            bv["byteStride"] = stride
        blob.extend(data)
        buffer_views.append(bv)
        return len(buffer_views) - 1

    def add_image(rgba_u8):
        images.append({"bufferView": add_view(_png_bytes(rgba_u8)),
                       "mimeType": "image/png"})
        textures.append({"source": len(images) - 1, "sampler": 0})
        return len(textures) - 1

    # materials + their textures
    materials = []
    mat_index = {}
    n_textures = 0
    for key, (builder, rough, metal, has_n, has_mr) in specs.items():
        base_tex = add_image(builder(tex_size))
        n_textures += 1
        m = {"name": key, "doubleSided": key in ("plant", "thorn", "chain"),
             "pbrMetallicRoughness": {
                 "baseColorTexture": {"index": base_tex},
                 "metallicFactor": float(metal),
                 "roughnessFactor": float(rough)}}
        if key in ("plant", "thorn", "chain"):
            m["alphaMode"] = "MASK"
            m["alphaCutoff"] = 0.5
        if has_n:
            m["normalTexture"] = {
                "index": add_image(normal_map(aux_size, 500 + n_textures))}
            n_textures += 1
        if has_mr:
            m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": add_image(mr_texture(aux_size, rough,
                                              700 + n_textures))}
            n_textures += 1
        mat_index[key] = len(materials)
        materials.append(m)

    FLOAT, UINT = 5126, 5125
    ARRAY, ELEMENT = 34962, 34963
    primitives = []
    n_tris = 0
    for (name, mkey, (pos, nrm, uv, tris)) in prims:
        inter = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
        v_view = add_view(inter.tobytes(), target=ARRAY, stride=32)
        idx = tris.reshape(-1).astype(np.uint32)
        i_view = add_view(idx.tobytes(), target=ELEMENT)
        a0 = len(accessors)
        accessors.extend([
            {"bufferView": v_view, "byteOffset": 0, "componentType": FLOAT,
             "count": int(pos.shape[0]), "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
            {"bufferView": v_view, "byteOffset": 12, "componentType": FLOAT,
             "count": int(pos.shape[0]), "type": "VEC3"},
            {"bufferView": v_view, "byteOffset": 24, "componentType": FLOAT,
             "count": int(pos.shape[0]), "type": "VEC2"},
            {"bufferView": i_view, "componentType": UINT,
             "count": int(idx.size), "type": "SCALAR"},
        ])
        primitives.append({
            "attributes": {"POSITION": a0, "NORMAL": a0 + 1,
                           "TEXCOORD_0": a0 + 2},
            "indices": a0 + 3, "material": mat_index[mkey]})
        n_tris += tris.shape[0]
        if verbose:
            print(f"  {name:<18} {mkey:<14} {tris.shape[0]:>7} tris")

    gltf = {
        "asset": {"version": "2.0",
                  "generator": "vk_renderer_tpu sponza replica"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        # matrix-transform root like the real file (identity scale here;
        # the real Sponza bakes a cm->m scale into its root node)
        "nodes": [{"name": "Sponza",
                   "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0,
                              0, 0, 0, 1],
                   "mesh": 0}],
        "meshes": [{"name": "sponza_replica", "primitives": primitives}],
        "materials": materials,
        "textures": textures,
        "images": images,
        "samplers": samplers,
        "buffers": [{"byteLength": 0}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    align()
    gltf["buffers"][0]["byteLength"] = len(blob)

    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(bytes(blob))
    return n_tris, n_textures


def write_pisa_cubemap(path, face=256):
    """pisa_cube.ktx replica: KTX1 R16G16B16A16_SFLOAT HDR sky cubemap —
    the real asset's container/format class (vk_loader.cpp:521-558)."""
    from . import procedural
    from .ktx import write_ktx1_half
    cm = procedural.make_sky_cubemap(face)          # f32[6, F, F, 3] linear
    rgba = np.concatenate([cm, np.ones((*cm.shape[:3], 1), np.float32)],
                          axis=-1).astype(np.float16)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_ktx1_half(path, rgba)


def ensure_assets(root="assets/sponza_replica", tex_size=512, aux_size=256,
                  scale=2.8):
    """Generate the replica GLB + pisa cubemap if absent (cached on disk;
    assets are gitignored, like the reference's).  Returns
    (glb_path, ktx_path)."""
    glb = os.path.join(root, "Sponza.glb")
    ktx = os.path.join(root, "pisa_cube.ktx")
    tag = os.path.join(root, f".v5_t{tex_size}_a{aux_size}_s{scale}")
    if not (os.path.exists(glb) and os.path.exists(ktx)
            and os.path.exists(tag)):
        n_tris, n_tex = write_glb(glb, tex_size=tex_size, aux_size=aux_size,
                                  scale=scale)
        write_pisa_cubemap(ktx)
        for f in os.listdir(root):
            if f.startswith(".v") and os.path.join(root, f) != tag:
                os.remove(os.path.join(root, f))
        with open(tag, "w") as f:
            f.write(f"{n_tris} tris, {n_tex} textures\n")
    return glb, ktx
