"""Texture sampling (SURVEY.md F4) over the flat texture heap.

Port of vk_renderer_tpu/ops/texture.py for the samplers the frame uses:
- glTF scene textures: ``_defaultSamplerLinear`` — linear mag/min, linear
  mipmap mode, REPEAT wrap, full LOD range (vk_engine_init.cpp:343-344;
  the bindless table always binds the default sampler, vk_loader.cpp:320),
- shadow map: linear, CLAMP_TO_BORDER with opaque-white border
  (vk_engine_init.cpp:392-394) over the 16-bit pair-packed cascades,
- skybox cubemap: linear, per-face clamp-to-edge, RGB9E5 texels.

LOD follows the Vulkan spec's isotropic approximation
``lambda = log2(max(|dUV/dx|, |dUV/dy|))`` in level-0 texel units, then a
trilinear blend between the two bracketing mips.

The heap is one i32 word per texel (the JAX package's quad interleave,
ShadowRows, CoarseRows and quad-row cubemap are TPU gather-cost layouts
of the same words: every bilinear here gathers its four corners, and the
shadow classifier its 2x2 cells, directly, with the same REPEAT / clamp
arithmetic, so the values read are identical).
Scenes whose glTF samplers differ from the default take the per-sampler
path (``_sample_general``: NEAREST / LINEAR filters and mip modes, REPEAT /
CLAMP_TO_EDGE / MIRRORED_REPEAT wrap).
"""

from __future__ import annotations

import torch

from ..scene.types import MAX_MIPS


def _unpack_rgba8(packed, srgb, channels):
    """i32 packed RGBA8 -> requested channel planes in shading space
    (per-texel sRGB decode before filtering for RGB of sRGB textures,
    exactly like R8G8B8A8_SRGB sampling hardware)."""
    out = []
    for c in channels:
        v = ((packed >> (8 * c)) & 0xFF).to(torch.float32) * (1.0 / 255.0)
        if c < 3:
            lin = torch.where(v <= 0.04045, v / 12.92,
                              torch.pow((v + 0.055) / 1.055, 2.4))
            v = torch.where(srgb, lin, v)
        out.append(v)
    return out


def _bilinear_at(texels, off, w, h, u, v, srgb, channels):
    """Bilinear fetch given an explicit (offset, w, h) descriptor: the
    four REPEAT-wrapped corners (self, x+1, y+1, both) of the base texel.
    Returns a tuple of planes for the requested channels."""
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    base = off.long()
    row0 = base + (y0i * w).long()
    row1 = base + (y1i * w).long()
    p00 = texels[row0 + x0i.long()]
    p10 = texels[row0 + x1i.long()]
    p01 = texels[row1 + x0i.long()]
    p11 = texels[row1 + x1i.long()]

    out = []
    for (t00, t10, t01, t11) in zip(_unpack_rgba8(p00, srgb, channels),
                                    _unpack_rgba8(p10, srgb, channels),
                                    _unpack_rgba8(p01, srgb, channels),
                                    _unpack_rgba8(p11, srgb, channels)):
        top = t00 + (t10 - t00) * fx
        bot = t01 + (t11 - t01) * fx
        out.append(top + (bot - top) * fy)
    return tuple(out)


def _meta_take(textures, tex_id):
    """Per-texture (w0, h0, max_level, srgb, w0i, h0i, base_off) for each
    pixel's texture id."""
    tid = tex_id.long()
    w0i = textures.mip_sizes[:, 0, 0][tid]
    h0i = textures.mip_sizes[:, 0, 1][tid]
    lvl = (textures.n_mips - 1)[tid]
    srgb = textures.srgb_flags[tid] > 0
    base = textures.mip_offsets[:, 0][tid]
    return (w0i.to(torch.float32), h0i.to(torch.float32),
            lvl.to(torch.float32), srgb, w0i, h0i, base)


def _desc_from_meta(base, w0i, h0i, level):
    """Mip descriptor (offset, w, h) computed from the level-0 descriptor:
    the heap lays mips contiguously (scene/textures.py build) with sizes
    ``max(x >> m, 1)``, so
        off(l) = base + sum_{m<l} max(w0>>m,1) * max(h0>>m,1)
    ``level`` must already be clipped to max_level."""
    acc = torch.zeros_like(base)
    for m in range(MAX_MIPS - 1):
        wm = torch.clamp(w0i >> m, min=1)
        hm = torch.clamp(h0i >> m, min=1)
        acc = acc + torch.where(level > m, wm * hm, 0)
    w = torch.clamp(w0i >> level, min=1)
    h = torch.clamp(h0i >> level, min=1)
    return base + acc, w, h


def _lod_from_meta(w0, h0, max_level, dudx, dvdx, dudy, dvdy):
    """Vulkan isotropic LOD from planar UV derivatives."""
    rho = torch.maximum(
        torch.sqrt((dudx * w0) ** 2 + (dvdx * h0) ** 2),
        torch.sqrt((dudy * w0) ** 2 + (dvdy * h0) ** 2))
    lam = torch.log2(torch.clamp(rho, min=1e-12))
    return torch.minimum(torch.clamp(lam, min=0.0), max_level)


WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2


def _wrap_index(i, n, wmode):
    """Per-texel-index Vulkan address modes (wmode i32 planar):
    0 REPEAT (mod), 1 CLAMP_TO_EDGE (clip), 2 MIRRORED_REPEAT
    (fold each period; Vulkan's per-index transform)."""
    rep = torch.remainder(i, n)
    clp = torch.minimum(torch.clamp(i, min=0), n - 1)
    m = torch.remainder(i, 2 * n)
    mir = torch.where(m >= n, 2 * n - 1 - m, m)
    return torch.where(wmode == WRAP_CLAMP, clp,
                       torch.where(wmode == WRAP_MIRROR, mir, rep))


def _sample_general(textures, tex_id, u, v, dudx, dvdx, dudy, dvdy,
                    channels):
    """Per-sampler-state sampling (texture.py:174-246): honors the glTF
    sampler the reference parses at src/vk_loader.cpp:253-270 — mag/min
    NEAREST vs LINEAR, mipmap mode NEAREST vs LINEAR, REPEAT /
    CLAMP_TO_EDGE / MIRRORED_REPEAT wrap per axis (mode bits:
    scene/textures.gltf_sampler_mode).  Taken only for scenes with a
    non-default sampler (TextureTable.has_custom_samplers).

    Vulkan semantics: filter = magFilter where lambda <= 0 else
    minFilter; NEAREST filtering reads texel floor(u*w) (no half-texel
    shift); mipmap NEAREST level = ceil(lambda + 0.5) - 1.  NEAREST
    filtering and NEAREST mip selection fold into the bilinear /
    two-level form as degenerate cases (fx = 0, l1 = l0), so one code
    path serves every mode combination."""
    w0, h0, max_level, srgb, w0i, h0i, base = _meta_take(textures, tex_id)
    mode = textures.sampler_modes[tex_id.long()]
    mag_n = (mode & 1) > 0
    min_n = (mode & 2) > 0
    mip_n = (mode & 4) > 0
    wrap_s = (mode >> 3) & 3
    wrap_t = (mode >> 5) & 3

    lam = _lod_from_meta(w0, h0, max_level, dudx, dvdx, dudy, dvdy)
    f_nearest = torch.where(lam <= 0.0, mag_n, min_n)
    max_l = max_level.to(torch.int32)
    # mip level(s): NEAREST folds to l1 == l0, frac = 0
    d_near = torch.minimum(torch.clamp(
        torch.ceil(lam + 0.5).to(torch.int32) - 1, min=0), max_l)
    l0 = torch.where(mip_n, d_near, torch.floor(lam).to(torch.int32))
    l1 = torch.where(mip_n, d_near, torch.minimum(l0 + 1, max_l))
    frac = torch.where(mip_n, 0.0, lam - torch.floor(lam))

    def level(li):
        off, wi, hi = _desc_from_meta(base, w0i, h0i, li)
        wf = wi.to(torch.float32)
        hf = hi.to(torch.float32)
        xb = u * wf - 0.5
        yb = v * hf - 0.5
        xn = torch.floor(u * wf)
        yn = torch.floor(v * hf)
        x0 = torch.where(f_nearest, xn, torch.floor(xb)).to(torch.int32)
        y0 = torch.where(f_nearest, yn, torch.floor(yb)).to(torch.int32)
        fx = torch.where(f_nearest, 0.0, xb - torch.floor(xb))
        fy = torch.where(f_nearest, 0.0, yb - torch.floor(yb))
        i0 = _wrap_index(x0, wi, wrap_s)
        i1 = _wrap_index(x0 + 1, wi, wrap_s)
        j0 = _wrap_index(y0, hi, wrap_t)
        j1 = _wrap_index(y0 + 1, hi, wrap_t)
        row0 = off.long() + (j0 * wi).long()
        row1 = off.long() + (j1 * wi).long()
        texels = textures.texels
        p00 = texels[row0 + i0.long()]
        p10 = texels[row0 + i1.long()]
        p01 = texels[row1 + i0.long()]
        p11 = texels[row1 + i1.long()]
        out = []
        for (t00, t10, t01, t11) in zip(_unpack_rgba8(p00, srgb, channels),
                                        _unpack_rgba8(p10, srgb, channels),
                                        _unpack_rgba8(p01, srgb, channels),
                                        _unpack_rgba8(p11, srgb, channels)):
            top = t00 + (t10 - t00) * fx
            bot = t01 + (t11 - t01) * fx
            out.append(top + (bot - top) * fy)
        return tuple(out)

    c0 = level(l0)
    c1 = level(l1)
    return tuple(a + (b - a) * frac for a, b in zip(c0, c1))


def sample_trilinear(textures, tex_id, u, v, dudx, dvdx, dudy, dvdy,
                     channels=(0, 1, 2, 3), nearest_mip: bool = False):
    """Full trilinear sample.  All per-pixel args planar (any matching
    shape).  Returns a tuple of planes for the requested channels.

    ``nearest_mip=True`` is the gated fidelity knob (texture.py:255-258):
    one bilinear sample at the rounded mip level instead of two blended
    levels.  Off by default (exact trilinear).

    Scenes carrying a non-default glTF sampler (has_custom_samplers)
    route through the per-sampler path, _sample_general, which does not
    take the knob."""
    if textures.has_custom_samplers:
        assert not nearest_mip, \
            "mr_nearest_mip knob is not supported with custom samplers"
        return _sample_general(textures, tex_id, u, v, dudx, dvdx, dudy,
                               dvdy, channels)
    w0, h0, max_level, srgb, w0b, h0b, base = _meta_take(textures, tex_id)
    lam = _lod_from_meta(w0, h0, max_level, dudx, dvdx, dudy, dvdy)
    if nearest_mip:
        off, wi, hi = _desc_from_meta(base, w0b, h0b,
                                      torch.round(lam).to(torch.int32))
        return _bilinear_at(textures.texels, off, wi, hi, u, v, srgb,
                            channels)
    l0 = torch.floor(lam).to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_level.to(torch.int32))
    frac = lam - l0.to(torch.float32)

    off0, w0i, h0i = _desc_from_meta(base, w0b, h0b, l0)
    c0 = _bilinear_at(textures.texels, off0, w0i, h0i, u, v, srgb, channels)
    # level l0+1's descriptor follows arithmetically from l0's (mips are
    # contiguous, sizes halve with a clamp at 1); at the chain end
    # (l1 == l0) the descriptor is reused unchanged
    deeper = l1 > l0
    off1 = torch.where(deeper, off0 + w0i * h0i, off0)
    w1i = torch.where(deeper, torch.clamp(w0i >> 1, min=1), w0i)
    h1i = torch.where(deeper, torch.clamp(h0i >> 1, min=1), h0i)
    c1 = _bilinear_at(textures.texels, off1, w1i, h1i, u, v, srgb, channels)
    return tuple(a + (b - a) * frac for a, b in zip(c0, c1))


# ----------------------------------------------------------------------------
# shadow map: 2D array, linear filter, clamp-to-border white
# ----------------------------------------------------------------------------

SHADOW_Q = 65535.0   # 16-bit fixed-point depth quantization (see pack)


def pack_shadow_maps(maps: torch.Tensor) -> torch.Tensor:
    """f32[L, S, S] depth -> pair-packed i32[L, S, S]:
    ``word[y, x] = q16(d[y, x]) | q16(d[y, min(x+1, S-1)]) << 16``
    (texture.py:458-482, bit for bit).  16-bit fixed point quantizes depth
    to 1.5e-5 — 33x finer than the 5e-4 compare bias (mesh_pbr.frag:38);
    a documented deviation from the reference's D32."""
    q = torch.round(torch.clamp(maps, 0.0, 1.0) * SHADOW_Q).to(torch.int32)
    q_next = torch.cat([q[..., 1:], q[..., -1:]], dim=-1)
    return q | (q_next << 16)


def _index(x, size):
    """Clamped integer texel index (NaN coordinates land on texel 0; the
    in-range masks already send them to the border value)."""
    return torch.nan_to_num(torch.clamp(x, 0, size - 1), nan=0.0).long()


SHADOW_COARSE_BLOCK = 64   # texels per coarse min/max cell at 2048


def coarse_block_for(size: int) -> int:
    """Coarse classifier cell size for a shadow map (texture.py:484-493):
    ~32 cells per side, clamped to [16, 64] so the widest PCSS search
    window stays within two consecutive cells."""
    return max(16, min(SHADOW_COARSE_BLOCK, size // 32))


def fine_block_for(size: int) -> int:
    """Cell size of the classifier's fine level (texture.py:496-505): its
    window covers only the filter's tap footprint, so cells 4x smaller
    than the coarse level still fit it in 2x2 cells."""
    return max(4, coarse_block_for(size) // 4)


def build_shadow_coarse(packed: torch.Tensor,
                        block: int | None = None) -> torch.Tensor:
    """Pair-packed maps i32[L, S, S] -> i32[L, S/B, S/B] classifier cells,
    each ``min_q | max_q << 16`` over its B x B block of quantized depths
    (the low halfword is the texel's own value; texture.py:508-532)."""
    lo = packed & 0xFFFF
    n_layers, s, _ = packed.shape
    block = coarse_block_for(s) if block is None else block
    block = min(block, s)            # tiny maps: one cell per map
    assert s % block == 0, "shadow size must be a multiple of the block"
    sb = s // block
    r = lo.reshape(n_layers, sb, block, sb, block)
    return r.amin(dim=(2, 4)) | (r.amax(dim=(2, 4)) << 16)


def _shadow_corners(shadow_packed: torch.Tensor, us: torch.Tensor,
                    vs: torch.Tensor, layer: torch.Tensor):
    """Border-substituted bilinear corner depths (t00, t10, t01, t11) and
    the lerp fractions (fx, fy) of taps us/vs [K, ...] over pair-packed
    i32[L, S, S] maps, layer [...].  Border depth 1.0 outside [0,1]^2
    (opaque-white border).  Two flat gathers per tap (the x-pair rides one
    packed word)."""
    size = shadow_packed.shape[-1]
    x = us * float(size) - 0.5
    y = vs * float(size) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    x0in = (x0 >= 0) & (x0 < size)
    x1in = (x0 + 1 >= 0) & (x0 + 1 < size)
    y0in = (y0 >= 0) & (y0 < size)
    y1in = (y0 + 1 >= 0) & (y0 + 1 < size)

    x0c = _index(x0, size)
    x1c = _index(x0 + 1, size)
    y0c = _index(y0, size)
    y1c = _index(y0 + 1, size)
    base = (layer.long() * (size * size))[None]
    flat = shadow_packed.reshape(-1)
    w0 = flat[base + y0c * size + x0c]
    w1 = flat[base + y1c * size + x0c]
    inv_q = 1.0 / SHADOW_Q
    lo0 = (w0 & 0xFFFF).to(torch.float32) * inv_q
    hi0 = ((w0 >> 16) & 0xFFFF).to(torch.float32) * inv_q
    lo1 = (w1 & 0xFFFF).to(torch.float32) * inv_q
    hi1 = ((w1 >> 16) & 0xFFFF).to(torch.float32) * inv_q
    # x0 < 0 clamps x0c to 0 == x1c: corner 1 is then the word's LO lane
    use_hi = x1c > x0c
    one = torch.ones((), dtype=torch.float32, device=us.device)
    t00 = torch.where(x0in & y0in, lo0, one)
    t10 = torch.where(x1in & y0in, torch.where(use_hi, hi0, lo0), one)
    t01 = torch.where(x0in & y1in, lo1, one)
    t11 = torch.where(x1in & y1in, torch.where(use_hi, hi1, lo1), one)
    return t00, t10, t01, t11, fx, fy


def sample_shadow_batch(shadow_packed: torch.Tensor, us: torch.Tensor,
                        vs: torch.Tensor, layer: torch.Tensor):
    """Batched bilinear shadow taps over pair-packed i32[L, S, S] maps:
    us/vs [K, ...] (K independent filter taps), layer [...]."""
    t00, t10, t01, t11, fx, fy = _shadow_corners(shadow_packed, us, vs,
                                                 layer)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def shadow_tap_corners(shadow_packed: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor, layer: torch.Tensor):
    """The four corner depths (t00, t10, t01, t11) of one bilinear tap at
    (u, v): the texel values sample_shadow interpolates, without the lerp
    (texture.py:645-659).  The classifier's receiver-quad proof reads
    them."""
    c = _shadow_corners(shadow_packed, u[None], v[None], layer)
    return tuple(x[0] for x in c[:4])


def sample_shadow(shadow_packed: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor, layer: torch.Tensor) -> torch.Tensor:
    """Single bilinear shadow tap (see sample_shadow_batch)."""
    return sample_shadow_batch(shadow_packed, u[None], v[None], layer)[0]


# ----------------------------------------------------------------------------
# cubemap
# ----------------------------------------------------------------------------

def _decode_rgb9e5(w):
    """Shared-exponent RGB9E5 -> (r, g, b) f32 (see types.pack_rgb9e5)."""
    e = ((w >> 27) & 0x1F).to(torch.float32)
    scale = torch.exp2(e - (15.0 + 9.0))
    return ((w & 0x1FF).to(torch.float32) * scale,
            ((w >> 9) & 0x1FF).to(torch.float32) * scale,
            ((w >> 18) & 0x1FF).to(torch.float32) * scale)


def sample_cubemap(cubemap: torch.Tensor, dx, dy, dz):
    """cubemap: RGB9E5-packed i32[6, F, F], Vulkan face order
    +X -X +Y -Y +Z -Z; direction components planar.  Bilinear, per-face
    clamp-to-edge, face selection per the Vulkan cube-map equations.
    Returns (r, g, b) planar."""
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    use_x = (ax >= ay) & (ax >= az)
    use_y = (~use_x) & (ay >= az)

    def sel(c, a, b):
        return torch.where(c, a, b)

    face = sel(use_x, sel(dx >= 0, 0, 1),
               sel(use_y, sel(dy >= 0, 2, 3), sel(dz >= 0, 4, 5)))
    ma = sel(use_x, ax, sel(use_y, ay, az))
    sc = sel(use_x, sel(dx >= 0, -dz, dz),
             sel(use_y, dx, sel(dz >= 0, dx, -dx)))
    tc = sel(use_x, -dy, sel(use_y, sel(dy >= 0, dz, -dz), -dy))

    ma = torch.clamp(ma, min=1e-12)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)

    size = cubemap.shape[1]
    xf = u * float(size) - 0.5
    yf = v * float(size) - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = xf - x0
    fy = yf - y0
    x0i = _index(x0, size)
    y0i = _index(y0, size)
    x1i = _index(x0 + 1, size)
    y1i = _index(y0 + 1, size)
    flat = cubemap.reshape(-1)
    base = face.long() * (size * size)
    w00 = flat[base + y0i * size + x0i]
    w10 = flat[base + y0i * size + x1i]
    w01 = flat[base + y1i * size + x0i]
    w11 = flat[base + y1i * size + x1i]
    out = []
    for (c00, c10, c01, c11) in zip(_decode_rgb9e5(w00), _decode_rgb9e5(w10),
                                    _decode_rgb9e5(w01), _decode_rgb9e5(w11)):
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        out.append(top + (bot - top) * fy)
    return tuple(out)
