"""Scene containers: the SoA arrays the render graph consumes.

This layer replaces the reference's GPU-resident scene state — the packed
vertex/index mesh buffers (src/vk_loader.cpp:186-225), the bindless texture
table (src/vk_engine_init.cpp:215-266), the per-material UBOs
(src/vk_materials.h:14-21) and the flattened RenderObject draw list
(src/vk_types.h:148-163).  Host builders fill the dataclasses with NumPy
arrays; ``to_device`` (or ``scene_to_torch`` for a host scene from either
package) uploads them once as torch tensors.

Vertex layout matches shaders/common.glsl:6-12 semantically (position,
normal, uv, color) but stored SoA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_MIPS = 13  # enough for 4096x4096 (bindless capacity era, vk_engine_init.cpp:226)

# Material pass types (src/vk_materials.h MaterialPass: MainColor / Transparent)
PASS_OPAQUE = 0
PASS_TRANSPARENT = 1


@dataclass
class TextureTable:
    """Bindless-equivalent texture heap.

    All texel data lives in one flat ``u32[N]`` buffer of packed RGBA8 —
    exactly the reference's R8G8B8A8 storage (vk_loader.cpp:283): sRGB
    images keep their sRGB encoding (with mips re-encoded after linear-space
    filtering, matching the hardware blit chain vk_images.cpp:64-158) and
    are decoded to linear per-texel at sample time before filtering, exactly
    like VK_FORMAT_R8G8B8A8_SRGB sampling; UNORM images are stored raw.

    Per (texture, mip): ``mip_offset[t, m]`` is the heap index of texel
    (0,0); level texels are row-major.  ``mip_sizes[t, m] = (width, height)``.
    On the device the heap is i32 (the same bits).
    """
    texels: np.ndarray       # u32[N] packed RGBA8 (r | g<<8 | b<<16 | a<<24)
    mip_offsets: np.ndarray  # i32[T, MAX_MIPS]
    mip_sizes: np.ndarray    # i32[T, MAX_MIPS, 2]  (w, h) logical, clamped at 1
    n_mips: np.ndarray       # i32[T]
    srgb_flags: np.ndarray = None   # i32[T]: 1 = stored sRGB-encoded
    # per-slot sampler mode bits (scene/textures.py gltf_sampler_mode);
    # 0 = the reference's actual bound sampler (trilinear + REPEAT)
    sampler_modes: np.ndarray = None     # i32[T]
    has_custom_samplers: bool = False


@dataclass
class SceneArrays:
    """Everything the frame function needs.  Host form: NumPy 2-D arrays;
    device form (``to_device``): planar tuples of 1-D tensors."""
    # vertex pool (SoA) — shaders/common.glsl:6-12
    positions: np.ndarray    # f32[V, 3]
    normals: np.ndarray      # f32[V, 3]
    uvs: np.ndarray          # f32[V, 2]
    colors: np.ndarray       # f32[V, 4]
    vert_obj: np.ndarray     # i32[V]   render-object id per vertex

    # triangle pool, sorted [opaque.. | masked.. | transparent..]
    tris: np.ndarray         # i32[T, 3]
    tri_material: np.ndarray # i32[T]
    n_opaque: int = 0        # static: count of opaque (never-discard) tris
    n_masked: int = 0        # static: count of alpha-cutoff-able tris
    n_transparent: int = 0   # static: additive-blend tris

    # render objects (flattened node graph, vk_types.h:148-163)
    obj_world: np.ndarray = None    # f32[O, 4, 4]
    obj_bounds: np.ndarray = None   # f32[O, 4] world-agnostic (center, radius)

    # material table (vk_materials.h:14-21)
    mat_color_factors: np.ndarray = None  # f32[M, 4]
    mat_metal_rough: np.ndarray = None    # f32[M, 4] (x=metallic, y=roughness)
    mat_tex_ids: np.ndarray = None        # i32[M, 3] (albedoID, normalID, metalRoughID)

    # bindless texture heap
    textures: TextureTable = None

    # skybox cubemap, host f32[6, F, F, 3], +X -X +Y -Y +Z -Z (Vulkan
    # layer order); device form: RGB9E5-packed i32[6, F, F]
    cubemap: np.ndarray = None

    # static: count of masked triangles whose alpha test CAN pass
    # (textures.tri_alpha_bounds amax >= 0.5).  The masked range is
    # sorted [can-pass.. | never-pass..]; never-pass triangles are
    # invisible to the camera raster but still cast shadows.
    # -1 = unclassified (treat all as can-pass)
    n_masked_raster: int = -1

    @property
    def n_masked_vis(self) -> int:
        """Masked triangles the camera raster must consider."""
        return self.n_masked if self.n_masked_raster < 0 \
            else self.n_masked_raster

    @property
    def num_vertices(self) -> int:
        p = self.positions
        return p[0].shape[0] if isinstance(p, tuple) else p.shape[0]

    @property
    def num_triangles(self) -> int:
        t = self.tris
        return t[0].shape[0] if isinstance(t, tuple) else t.shape[0]

    def to_device(self, device) -> "SceneArrays":
        """Upload all arrays once (the immediate_submit analog,
        vk_loader.cpp:54-74).  See scene_to_torch."""
        return scene_to_torch(self, device)


RGB9E5_EXP_BIAS = 15
RGB9E5_MANTISSA_BITS = 9


def pack_rgb9e5(rgb: np.ndarray) -> np.ndarray:
    """f32[..., 3] (non-negative, HDR up to ~6.5e4) -> shared-exponent
    RGB9E5 u32 [...] (EXT_texture_shared_exponent layout: r | g<<9 | b<<18
    | e<<27).  ~9-bit relative precision per channel; one 32-bit word per
    texel makes a cubemap bilinear corner a single gather."""
    c = np.clip(np.asarray(rgb, np.float32), 0.0, 65408.0)
    maxc = np.maximum(c.max(axis=-1), 1e-12)
    e = np.clip(np.floor(np.log2(maxc)).astype(np.int32) + 1
                + RGB9E5_EXP_BIAS, 0, 31)
    scale = np.exp2(e - RGB9E5_EXP_BIAS - RGB9E5_MANTISSA_BITS
                    ).astype(np.float32)
    m = np.clip(np.round(c / scale[..., None]).astype(np.int32), 0, 511)
    return (m[..., 0] | (m[..., 1] << 9) | (m[..., 2] << 18)
            | (e << 27)).astype(np.int32)


def _heap_words(tex) -> np.ndarray:
    """The host heap as one u32 word per texel.  The JAX package's host
    heap is quad-interleaved (4 words per texel, corner 0 = the texel
    itself); its length is then 4x the texel count, which the descriptor
    table determines."""
    texels = np.asarray(tex.texels).reshape(-1)
    n_mips = np.asarray(tex.n_mips)
    sizes = np.asarray(tex.mip_sizes)
    n_texels = sum(int(sizes[t, m, 0]) * int(sizes[t, m, 1])
                   for t in range(n_mips.shape[0]) for m in range(n_mips[t]))
    if n_texels and texels.shape[0] == 4 * n_texels:
        texels = texels[0::4]
    return np.ascontiguousarray(texels).view(np.int32)


def textures_to_torch(tex, device) -> TextureTable:
    """A host TextureTable (either package's) -> the device table: one
    i32 word per texel and i32 descriptor tables."""
    import torch

    def put(x):
        a = np.ascontiguousarray(np.asarray(x))
        return torch.from_numpy(a.copy()).to(device).to(torch.int32)

    modes = getattr(tex, "sampler_modes", None)
    if modes is None:
        modes = np.zeros(np.asarray(tex.n_mips).shape, np.int32)
    return TextureTable(
        texels=put(_heap_words(tex)),
        mip_offsets=put(tex.mip_offsets),
        mip_sizes=put(tex.mip_sizes),
        n_mips=put(tex.n_mips),
        srgb_flags=put(tex.srgb_flags),
        sampler_modes=put(modes),
        has_custom_samplers=bool(tex.has_custom_samplers))


def scene_to_torch(host, device) -> SceneArrays:
    """Host ``SceneArrays`` (this package's, or the JAX package's
    ``SceneBuilder.build()`` output before ``device_put`` — read by
    attribute, so no JAX import) -> device SceneArrays of torch tensors.

    Per-vertex/per-triangle attribute matrices become PLANAR column tuples
    (``positions`` -> ``(x, y, z)``, ``tris`` -> ``(i0, i1, i2)``), the
    layout the JAX package's public functions use.  All-ones vertex colors
    (the glTF COLOR_0 default) become ``None`` so the shading path folds
    the multiply away.  The cubemap is stored RGB9E5-packed."""
    import torch

    def put(x, dtype=None):
        a = np.ascontiguousarray(np.asarray(x))
        t = torch.from_numpy(a.copy()).to(device)
        return t if dtype is None else t.to(dtype)

    def put_cols(x, dtype=None):
        x = np.asarray(x)
        return tuple(put(x[:, c], dtype) for c in range(x.shape[1]))

    new_tex = (None if host.textures is None
               else textures_to_torch(host.textures, device))
    cubemap = None
    if host.cubemap is not None:
        cubemap = put(pack_rgb9e5(host.cubemap))
    colors = None
    if host.colors is not None and not bool(
            np.all(np.asarray(host.colors)[:, :3] == 1.0)):
        colors = put_cols(host.colors, torch.float32)
    f32, i32 = torch.float32, torch.int32
    return SceneArrays(
        positions=put_cols(host.positions, f32),
        normals=put_cols(host.normals, f32),
        uvs=put_cols(host.uvs, f32),
        colors=colors,
        vert_obj=put(host.vert_obj, i32),
        tris=put_cols(host.tris, i32),
        tri_material=put(host.tri_material, i32),
        n_opaque=int(host.n_opaque), n_masked=int(host.n_masked),
        n_transparent=int(host.n_transparent),
        obj_world=put(host.obj_world, f32),
        obj_bounds=put(host.obj_bounds, f32),
        mat_color_factors=put(host.mat_color_factors, f32),
        mat_metal_rough=put(host.mat_metal_rough, f32),
        mat_tex_ids=put(host.mat_tex_ids, i32),
        textures=new_tex,
        cubemap=cubemap,
        n_masked_raster=int(getattr(host, "n_masked_raster", -1)),
    )
