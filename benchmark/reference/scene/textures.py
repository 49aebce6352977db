"""Texture heap construction: decode, mip generation, bindless table.

Replicates the reference's texture pipeline on the host at load time:
- glTF images decode to RGBA8 and upload as R8G8B8A8_SRGB with full mip
  chains (src/vk_loader.cpp:272-329); sampling hardware decodes sRGB->linear
  before filtering, so we store linear floats.
- default 1x1 textures and the magenta/black checkerboard are
  R8G8B8A8_UNORM (src/vk_engine_init.cpp:318-341) — stored raw.
- mip generation is the vkCmdBlitImage linear-filter chain
  (src/vk_images.cpp:64-158): each level bilinearly resamples the previous
  at destination pixel centers.

Bindless slot layout replicates the reference exactly, including its
slot-0 double-write quirk (SURVEY.md quirk 2): slot 0 holds the flat-normal
color (0.5, 0.5, 1, 1) — because init_default_data writes white to slot 0
then overwrites slot 0 with the default normal (vk_engine_init.cpp:351-355)
— slot 1 is never written (we store white), and glTF textures start at 2.
"""

from __future__ import annotations

import numpy as np

from ..utils.image import linear_to_srgb, srgb_to_linear
from .types import MAX_MIPS, TextureTable


def blit_resize_bilinear(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Bilinear resample f32[H, W, C] to (dst_h, dst_w) at dst pixel centers,
    clamp-to-edge — the vkCmdBlitImage(VK_FILTER_LINEAR) sampling rule."""
    src_h, src_w = img.shape[:2]
    xs = (np.arange(dst_w, dtype=np.float64) + 0.5) * (src_w / dst_w) - 0.5
    ys = (np.arange(dst_h, dtype=np.float64) + 0.5) * (src_h / dst_h) - 0.5
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = (xs - x0).astype(np.float32)
    fy = (ys - y0).astype(np.float32)
    x0c = np.clip(x0, 0, src_w - 1); x1c = np.clip(x0 + 1, 0, src_w - 1)
    y0c = np.clip(y0, 0, src_h - 1); y1c = np.clip(y0 + 1, 0, src_h - 1)
    a = img[y0c][:, x0c]
    b = img[y0c][:, x1c]
    c = img[y1c][:, x0c]
    d = img[y1c][:, x1c]
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy).astype(np.float32)


def generate_mips(level0: np.ndarray) -> list[np.ndarray]:
    """Full mip chain down to 1x1 (mipLevels = floor(log2(max(w,h)))+1,
    src/vk_loader.cpp:121)."""
    mips = [level0.astype(np.float32)]
    h, w = level0.shape[:2]
    n_levels = int(np.floor(np.log2(max(w, h)))) + 1
    for _ in range(1, n_levels):
        w = max(w // 2, 1)
        h = max(h // 2, 1)
        mips.append(blit_resize_bilinear(mips[-1], w, h))
    return mips


# Per-slot sampler mode bits (SamplerModes), honoring glTF per-sampler
# state (VERDICT r4 task 6; the reference CREATES these VkSamplers,
# src/vk_loader.cpp:253-270, but then binds _defaultSamplerLinear to every
# bindless slot at :320 — so mode 0 IS actual-reference behavior, and
# nonzero modes are the rebuild honoring what the loader parsed):
#   bit 0: mag filter NEAREST        bit 1: min filter NEAREST
#   bit 2: mipmap mode NEAREST       bits 3-4: wrapS  bits 5-6: wrapT
# wrap values: 0 REPEAT, 1 CLAMP_TO_EDGE, 2 MIRRORED_REPEAT
WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2


def gltf_sampler_mode(sampler: dict) -> int:
    """glTF sampler dict -> mode bits.  Explicit NEAREST filters are
    honored; ABSENT fields fall back to the default-sampler behavior
    (linear/linear/mip-linear, REPEAT) — the reference's dead
    per-sampler code maps absent to Nearest (value_or(Nearest),
    vk_loader.cpp:258-260) but its BOUND sampler is always the linear
    default, so the actual-behavior default is linear (documented
    deviation from dead code)."""
    mag = sampler.get("magFilter")
    mn = sampler.get("minFilter")
    mode = 0
    if mag == 9728:                         # NEAREST
        mode |= 1
    if mn in (9728, 9984, 9986):            # NEAREST* minification
        mode |= 2
    if mn in (9984, 9985):                  # *_MIPMAP_NEAREST
        mode |= 4
    wraps = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}
    mode |= wraps.get(sampler.get("wrapS", 10497), WRAP_REPEAT) << 3
    mode |= wraps.get(sampler.get("wrapT", 10497), WRAP_REPEAT) << 5
    return mode


class TextureHeapBuilder:
    """Accumulates textures into the flat heap (the bindless table analog)."""

    def __init__(self):
        self._textures: list[list[np.ndarray]] = []   # per texture: list of mips
        self._srgb: list[bool] = []
        self._modes: list[int] = []    # per-slot sampler mode bits (0=default)

    def add(self, rgba_u8: np.ndarray, *, srgb: bool, mipmapped: bool,
            sampler_mode: int = 0) -> int:
        """Add an RGBA8 image; returns its bindless index (NumPy decode
        and mip filter)."""
        rgba_u8 = np.asarray(rgba_u8)
        assert rgba_u8.dtype == np.uint8 and rgba_u8.ndim == 3 and rgba_u8.shape[2] == 4

        f = rgba_u8.astype(np.float32) / 255.0
        if srgb:
            # hardware sRGB decode applies to RGB only; alpha stays linear
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]],
                               axis=-1)
        mips = [f]
        if mipmapped:
            mips = generate_mips(f)
        # the descriptor table has MAX_MIPS slots; a >4096^2 texture's chain
        # must be clamped or build() would index past offsets[t, MAX_MIPS-1]
        mips = mips[:MAX_MIPS]
        # base dimensions must fit the 13-bit packed-meta fields
        # (ops/texture.packed_meta_cols packs w0/h0 as <= 8191); beyond that
        # the packed-rows path would silently decode w0=0 and sample garbage
        # while the narrow path stayed correct — reject loudly instead
        h0, w0 = mips[0].shape[:2]
        if w0 > 8191 or h0 > 8191:
            raise ValueError(
                f"texture {w0}x{h0} exceeds the 8191px packed-meta limit "
                "(downscale at load; the reference's bindless era caps at "
                "4096^2, vk_engine_init.cpp:226)")
        self._textures.append(mips)
        self._srgb.append(bool(srgb))
        self._modes.append(int(sampler_mode))
        return len(self._textures) - 1

    def add_solid(self, rgba: tuple[float, float, float, float]) -> int:
        """1x1 UNORM constant texture (the default-texture path)."""
        px = np.array([[list(rgba)]], dtype=np.float32)
        self._textures.append([px])
        self._srgb.append(False)
        self._modes.append(0)
        return len(self._textures) - 1

    def min_alpha(self, index: int) -> float:
        """Min texel alpha across all mips — used to classify materials as
        never-discarding (bilinear filtering of values >= 0.5 stays >= 0.5,
        so min >= 0.5 means mesh_pbr.frag:193 can never discard)."""
        return float(min(m[..., 3].min() for m in self._textures[index]))

    def build(self) -> TextureTable:
        """Pack the heap: RGBA8 in uint32 (the reference's texture format),
        sRGB textures stored sRGB-encoded (mips re-encoded after the
        linear-space blit chain — the hardware behavior), one word per
        texel, levels laid out contiguously (the JAX package's heap with
        its quad interleave undone: its word ``4*i`` is this heap's word
        ``i``)."""
        n_tex = len(self._textures)
        offsets = np.zeros((n_tex, MAX_MIPS), dtype=np.int32)
        sizes = np.ones((n_tex, MAX_MIPS, 2), dtype=np.int32)
        n_mips = np.zeros(n_tex, dtype=np.int32)
        srgb_flags = np.array([1 if s else 0 for s in self._srgb], np.int32)
        chunks = []
        cursor = 0
        for t, mips in enumerate(self._textures):
            n_mips[t] = len(mips)
            for m, img in enumerate(mips):
                h, w = img.shape[:2]
                f = np.clip(img, 0.0, 1.0)
                if self._srgb[t]:
                    # re-encode: RGB to sRGB, alpha stays linear
                    f = np.concatenate([linear_to_srgb(f[..., :3]),
                                        f[..., 3:]], axis=-1)
                u8 = (f * 255.0 + 0.5).astype(np.uint32)
                packed = (u8[..., 0] | (u8[..., 1] << 8)
                          | (u8[..., 2] << 16) | (u8[..., 3] << 24))
                offsets[t, m] = cursor
                sizes[t, m] = (w, h)
                chunks.append(packed.reshape(-1).astype(np.uint32))
                cursor += w * h
            # clamp-extend: trilinear may address level n_mips-1+1; point the
            # remaining slots at the last real level
            for m in range(len(mips), MAX_MIPS):
                offsets[t, m] = offsets[t, len(mips) - 1]
                sizes[t, m] = sizes[t, len(mips) - 1]
        assert cursor < 2**31, "texture heap exceeds i32 offsets"
        texels = (np.concatenate(chunks) if chunks
                  else np.zeros((1,), dtype=np.uint32))
        modes = np.array(self._modes, np.int32)
        return TextureTable(texels=texels, mip_offsets=offsets,
                            mip_sizes=sizes, n_mips=n_mips,
                            srgb_flags=srgb_flags,
                            sampler_modes=modes,
                            has_custom_samplers=bool((modes != 0).any()))


def _minmax_pyramids(a: np.ndarray):
    """2x2 min/max pyramids of a 2-D array (edge-padded to even sizes —
    valid for IN-RANGE rect queries; wrap-crossing queries fall back to
    the global bounds in tri_alpha_bounds)."""
    pmins, pmaxs = [a], [a]
    while pmins[-1].shape[0] > 1 or pmins[-1].shape[1] > 1:
        p_min, p_max = pmins[-1], pmaxs[-1]
        hh, ww = p_min.shape
        if hh % 2 or ww % 2:
            p_min = np.pad(p_min, ((0, hh % 2), (0, ww % 2)), mode="edge")
            p_max = np.pad(p_max, ((0, hh % 2), (0, ww % 2)), mode="edge")
        s = p_min.shape
        pmins.append(p_min.reshape(s[0] // 2, 2, s[1] // 2, 2).min((1, 3)))
        pmaxs.append(p_max.reshape(s[0] // 2, 2, s[1] // 2, 2).max((1, 3)))
    return pmins, pmaxs


def _rect_minmax(pmins, pmaxs, h, w, x0, x1, y0, y1):
    """Vectorized conservative min/max of a[y0:y1, x0:x1] (texel-index
    rects, exclusive upper) via the pyramids: query the level where the
    rect spans <= 2 cells per axis (<= 4 gathers).  Rects that wrap the
    REPEAT boundary or cover an axis fall back to the global bounds."""
    n = x0.shape[0]
    spanx = x1 - x0
    spany = y1 - y0
    gmin = np.float32(pmins[-1].reshape(-1)[0])
    gmax = np.float32(pmaxs[-1].reshape(-1)[0])
    whole = (spanx >= w) | (spany >= h)
    x0m = np.mod(x0, w)
    y0m = np.mod(y0, h)
    whole |= (x0m + spanx > w) | (y0m + spany > h)
    span = np.maximum(np.maximum(spanx, spany), 1)
    q = np.clip(np.ceil(np.log2(span)).astype(np.int64), 0,
                len(pmins) - 1)
    lo = np.full(n, gmin, np.float32)
    hi = np.full(n, gmax, np.float32)
    for ql in np.unique(q[~whole]):
        sel = (~whole) & (q == ql)
        pm, px = pmins[ql], pmaxs[ql]
        ph, pw = pm.shape
        i0 = np.clip(x0m[sel] >> ql, 0, pw - 1)
        i1 = np.clip((x0m[sel] + spanx[sel] - 1) >> ql, 0, pw - 1)
        j0 = np.clip(y0m[sel] >> ql, 0, ph - 1)
        j1 = np.clip((y0m[sel] + spany[sel] - 1) >> ql, 0, ph - 1)
        lo[sel] = np.minimum(np.minimum(pm[j0, i0], pm[j0, i1]),
                             np.minimum(pm[j1, i0], pm[j1, i1]))
        hi[sel] = np.maximum(np.maximum(px[j0, i0], px[j0, i1]),
                             np.maximum(px[j1, i0], px[j1, i1]))
    return lo, hi


def tri_alpha_bounds(heap: TextureHeapBuilder, tex_ids: np.ndarray,
                     u: np.ndarray, v: np.ndarray):
    """Conservative per-triangle bounds [amin, amax] of the alpha the
    fragment stage can sample.  The reference's discard operand is the RAW
    trilinear albedo alpha — ``if (albedoTex.a < 0.5) discard;``
    (mesh_pbr.frag:193) — with no colorFactors.a or vertex-color term, and
    the runtime accept test (_winner_alpha) matches it; the bounds must
    therefore cover exactly that operand (a baseColorFactor.a < 1 material
    must NOT scale the bound, or visible geometry would be classified
    never-pass and silently culled): every trilinear tap inside the
    triangle reads texels within
    the triangle's uv bbox expanded by the bilinear footprint (1.5
    texels at the sampled level; any mip level may be sampled, so bounds
    fold min/max across ALL levels), and the lerp of two levels stays
    within their joint bounds.  Quantization of the stored u8 texels
    adds <= 1/255 — folded into the bounds margins.

    Used to classify masked triangles (frame masked pass):
    amax < 0.5  => the alpha test can NEVER pass (the triangle is
    invisible to the camera: exclude it from the masked raster bucket —
    it still casts shadows, the reference's shadow pass has no fragment
    stage);  amin >= 0.5 => always passes.

    u/v: [T, 3] per-corner uv.  Returns (amin, amax) f32[T]."""
    t_count = tex_ids.shape[0]
    amin = np.zeros(t_count, np.float32)
    amax = np.ones(t_count, np.float32)
    umin, umax = u.min(axis=1), u.max(axis=1)
    vmin, vmax = v.min(axis=1), v.max(axis=1)
    finite = (np.isfinite(umin) & np.isfinite(umax)
              & np.isfinite(vmin) & np.isfinite(vmax))
    q_margin = np.float32(1.0 / 255.0)
    for t in np.unique(tex_ids):
        sel = (tex_ids == t) & finite
        if not sel.any():
            continue
        lo = np.full(int(sel.sum()), np.inf, np.float32)
        hi = np.full(int(sel.sum()), -np.inf, np.float32)
        for img in heap._textures[t]:
            h_l, w_l = img.shape[:2]
            aq = np.round(np.clip(img[..., 3], 0.0, 1.0) * 255.0) / \
                np.float32(255.0)
            pmins, pmaxs = _minmax_pyramids(aq.astype(np.float32))
            x0 = np.floor(umin[sel] * w_l - 1.5).astype(np.int64)
            x1 = np.ceil(umax[sel] * w_l + 1.5).astype(np.int64)
            y0 = np.floor(vmin[sel] * h_l - 1.5).astype(np.int64)
            y1 = np.ceil(vmax[sel] * h_l + 1.5).astype(np.int64)
            l_lo, l_hi = _rect_minmax(pmins, pmaxs, h_l, w_l,
                                      x0, x1, y0, y1)
            lo = np.minimum(lo, l_lo)
            hi = np.maximum(hi, l_hi)
        amin[sel] = np.maximum(lo - q_margin, 0.0)
        amax[sel] = hi + q_margin
    return amin, amax


def make_default_heap() -> tuple[TextureHeapBuilder, dict[str, int]]:
    """Create the heap pre-populated with the reference's default slots
    (vk_engine_init.cpp:318-355, including the slot-0 overwrite quirk) plus
    the error checkerboard used as the load-failure fallback
    (vk_loader.cpp:323-328)."""
    b = TextureHeapBuilder()
    # slot 0: intended white, overwritten by flat normal 0xFFFF8080
    slot0 = b.add_solid((128 / 255.0, 128 / 255.0, 1.0, 1.0))
    # slot 1: never written in the reference; white (the original intent)
    slot1 = b.add_solid((1.0, 1.0, 1.0, 1.0))
    ids = {"default_normal": slot0, "white": slot1}
    return b, ids


def make_checkerboard_u8(size: int = 16) -> np.ndarray:
    """16x16 magenta/black error checkerboard (vk_engine_init.cpp:329-341)."""
    img = np.zeros((size, size, 4), dtype=np.uint8)
    for y in range(size):
        for x in range(size):
            img[y, x] = (255, 0, 255, 255) if (x % 2) ^ (y % 2) else (0, 0, 0, 255)
    return img
