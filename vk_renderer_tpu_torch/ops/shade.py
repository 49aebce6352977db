"""Fragment shading: Cook-Torrance PBR, flat Lambert and the shadow
filter library.

Port of vk_renderer_tpu/ops/shade.py (the dense-filter path):
- shaders/mesh_pbr.frag:159-226 — GGX distribution, Schlick-GGX geometry
  (k=(r+1)^2/8), Schlick Fresnel, F0=mix(0.04, albedo, metallic),
  kD scaled by (1-metallic), out = ambient*albedo + Lo*(1-shadow),
- shaders/mesh.frag:124-182 — Lambert + ambient (``shade_flat``),
- shaders/mesh_pbr.frag:37-156 — shadow filters: Hard 1-tap, PCF 3x3,
  PCSS (16-tap Poisson blocker search + 16-tap Poisson PCF), CSM =
  cascade-select + PCSS.  Bias 5e-4, biasMat NDC->UV remap.

The filter runs densely over every pixel (``compute_shadow_factor``).
The JAX package's penumbra classifier (``classified_shadow_factor``)
proves most pixels lit or blocked first and filters only the uncertain
band; it is exact, so the dense filter gives the same image.  The shadow
mode and enable flag are host values here (the frame reads them from the
per-frame scene data), so the mode switch is a Python branch.

All per-pixel math is planar; the G-buffer is a dict of planar tensors:
  nx ny nz | cr cg cb | u v dudx dvdx dudy dvdy | wx wy wz | view_z |
  mat_id | covered
"""

from __future__ import annotations

import torch

from . import texture as tex

PI = 3.14159265359
SHADOW_BIAS = 0.0005                 # mesh_pbr.frag:38
NUM_SAMPLES_BLOCKER_SEARCH = 16
NUM_SAMPLES_PCF = 16
NEAR_PLANE = 0.1                     # mesh_pbr.frag:63
LIGHT_WORLD_SIZE = 2.0
LIGHT_FRUSTUM_WIDTH = 200.0
LIGHT_SIZE_UV = LIGHT_WORLD_SIZE / LIGHT_FRUSTUM_WIDTH

# mesh_pbr.frag:68-85, verbatim
POISSON_DISK = [
    (-0.94201624, -0.39906216), (0.94558609, -0.76890725),
    (-0.094184101, -0.92938870), (0.34495938, 0.29387760),
    (-0.91588581, 0.45771432), (-0.81544232, -0.87912464),
    (-0.38277543, 0.27676845), (0.97484398, 0.75648379),
    (0.44323325, -0.97511554), (0.53742981, -0.47373420),
    (-0.26496911, -0.41893023), (0.79197514, 0.19090188),
    (-0.24188840, 0.99706507), (-0.81409955, 0.91437590),
    (0.19984126, 0.78641367), (0.14383161, -0.14100790)]


# ----------------------------------------------------------------------------
# shadow filter library (planar: coordinates as (su, sv, sz) arrays)
# ----------------------------------------------------------------------------

def _blocked(cond):
    return cond.to(torch.float32)


def _shadow_hard(shadow_maps, su, sv, sz, layer):
    """compute_shadow (mesh_pbr.frag:39-46): 1 tap."""
    depth = tex.sample_shadow(shadow_maps, su, sv, layer)
    return _blocked(depth + SHADOW_BIAS < sz)


def _shadow_pcf(shadow_maps, su, sv, sz, layer):
    """PCF 3x3 (mesh_pbr.frag:48-59)."""
    texel = 1.0 / shadow_maps.shape[-1]
    acc = torch.zeros_like(sz)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            d = tex.sample_shadow(shadow_maps, su + i * texel,
                                  sv + j * texel, layer)
            acc = acc + _blocked(sz - SHADOW_BIAS > d)
    return acc / 9.0


def _shadow_pcss(shadow_maps, su, sv, sz, layer):
    """PCSS (mesh_pbr.frag:87-121)."""
    search_w = LIGHT_SIZE_UV * (sz - NEAR_PLANE) / sz
    disk = POISSON_DISK[:NUM_SAMPLES_BLOCKER_SEARCH]
    blocker_sum = torch.zeros_like(sz)
    n_blockers = torch.zeros_like(sz)
    for (px, py) in disk:
        z = tex.sample_shadow(shadow_maps, su + px * search_w,
                              sv + py * search_w, layer)
        hit = z + SHADOW_BIAS < sz
        blocker_sum = blocker_sum + torch.where(hit, z, 0.0)
        n_blockers = n_blockers + hit.to(torch.float32)
    z_blocker = torch.where(n_blockers > 0,
                            blocker_sum / torch.clamp(n_blockers, min=1),
                            -1.0)

    penumbra = (sz - z_blocker) / z_blocker
    radius = penumbra * LIGHT_SIZE_UV * NEAR_PLANE / sz
    acc = torch.zeros_like(sz)
    for (px, py) in POISSON_DISK[:NUM_SAMPLES_PCF]:
        d = tex.sample_shadow(shadow_maps, su + px * radius,
                              sv + py * radius, layer)
        acc = acc + _blocked(sz - SHADOW_BIAS > d)
    pcf = acc / NUM_SAMPLES_PCF
    return torch.where(z_blocker < 0, 0.0, pcf)


def shadow_coords(wx, wy, wz, view_z, scene_data, shadow_mode: int):
    """The coordinate half of calcShadow (mesh_pbr.frag:127-141): cascade
    selection + shadowCoord = biasMat @ lightViewproj[layer] @ fragWorld.
    Returns planar (su, sv, sz, layer)."""
    # cascade selection: first i with |viewZ| < cascadeDistances[i]
    view_depth = torch.abs(view_z)
    dists = scene_data["cascade_distances"]
    n = dists.shape[0]
    layer = torch.full(view_depth.shape, n - 1, dtype=torch.int32,
                       device=view_z.device)
    for i in range(n - 1, -1, -1):
        layer = torch.where(view_depth < dists[i], i, layer)
    if shadow_mode < 3:
        layer = torch.zeros_like(layer)

    lvps = scene_data["light_viewproj"]                  # [4, 4, 4]

    def coord_for(m):
        def row(r):
            return wx * m[r, 0] + wy * m[r, 1] + wz * m[r, 2] + m[r, 3]
        x, y, z, w = row(0), row(1), row(2), row(3)
        return x * 0.5 + w * 0.5, y * 0.5 + w * 0.5, z

    su, sv, sz = coord_for(lvps[0])
    if shadow_mode >= 3:
        for i in range(1, lvps.shape[0]):
            ui, vi, zi = coord_for(lvps[i])
            sel = layer == i
            su = torch.where(sel, ui, su)
            sv = torch.where(sel, vi, sv)
            sz = torch.where(sel, zi, sz)
    return su, sv, sz, layer


def _filter_dispatch(shadow_maps, su, sv, sz, layer, shadow_mode: int):
    """Run the selected shadow filter (Hard/PCF/PCSS; CSM differs from
    PCSS only in the cascade selection).  Layer is clamped to the
    rastered cascade count; modes outside 0..3 clamp like the JAX
    package's traced switch."""
    layer = torch.clamp(layer, max=shadow_maps.shape[0] - 1)
    mode = min(max(int(shadow_mode), 0), 2)
    if mode == 0:
        return _shadow_hard(shadow_maps, su, sv, sz, layer)
    if mode == 1:
        return _shadow_pcf(shadow_maps, su, sv, sz, layer)
    return _shadow_pcss(shadow_maps, su, sv, sz, layer)


def compute_shadow_factor(shadow_maps, wx, wy, wz, view_z, scene_data,
                          shadow_mode: int, enable_shadows: bool):
    """calcShadow (mesh_pbr.frag:127-156) over every pixel.  World
    position and view-space z arrive planar; ``shadow_mode`` and
    ``enable_shadows`` are the per-frame UBO flags (sunlightDirection.w,
    sunlightColor.w) read on the host."""
    if not enable_shadows:
        return torch.zeros_like(view_z)
    su, sv, sz, layer = shadow_coords(wx, wy, wz, view_z, scene_data,
                                      shadow_mode)
    return _filter_dispatch(shadow_maps, su, sv, sz, layer, shadow_mode)


# ----------------------------------------------------------------------------
# BRDF helpers (planar scalars)
# ----------------------------------------------------------------------------

def _distribution_ggx(n_dot_h, roughness):
    a = roughness * roughness
    a2 = a * a
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def _geometry_schlick_ggx(n_dot_v, roughness):
    r = roughness + 1.0
    k = r * r / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def _fresnel_schlick(cos_theta, f0):
    p = torch.pow(torch.clamp(1.0 - cos_theta, 0.0, 1.0), 5.0)
    return f0 + (1.0 - f0) * p


def _normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-40))
    return x * inv, y * inv, z * inv


def shade_pbr(gbuf: dict, scene, scene_data: dict, shadow_maps,
              shadow_mode: int, enable_shadows: bool):
    """mesh_pbr.frag main (185-226) over the planar G-buffer.
    Returns ((r, g, b), albedo_alpha), all planar."""
    nx, ny, nz = _normalize3(gbuf["nx"], gbuf["ny"], gbuf["nz"])
    cam = scene_data["cam_pos"]
    vx, vy, vz = _normalize3(cam[0] - gbuf["wx"], cam[1] - gbuf["wy"],
                             cam[2] - gbuf["wz"])
    sun = scene_data["sunlight_direction"]
    inv_sun = torch.rsqrt(torch.clamp(
        sun[0] ** 2 + sun[1] ** 2 + sun[2] ** 2, min=1e-40))
    lx, ly, lz = -sun[0] * inv_sun, -sun[1] * inv_sun, -sun[2] * inv_sun
    hx, hy, hz = _normalize3(vx + lx, vy + ly, vz + lz)

    # one [M, 8] material row per pixel (ids are exact in f32 below 2^24)
    mat_id = gbuf["mat_id"].long()
    mrow = torch.stack(
        [scene.mat_tex_ids[:, 0].to(torch.float32),
         scene.mat_tex_ids[:, 2].to(torch.float32),
         scene.mat_color_factors[:, 0], scene.mat_color_factors[:, 1],
         scene.mat_color_factors[:, 2], scene.mat_metal_rough[:, 0],
         scene.mat_metal_rough[:, 1],
         torch.zeros_like(scene.mat_color_factors[:, 0])], dim=-1)[mat_id]
    albedo_id = mrow[..., 0].to(torch.int32)
    mr_id = mrow[..., 1].to(torch.int32)
    cf_r, cf_g, cf_b = mrow[..., 2], mrow[..., 3], mrow[..., 4]
    metal_f, rough_f = mrow[..., 5], mrow[..., 6]

    at_r, at_g, at_b, at_a = tex.sample_trilinear(
        scene.textures, albedo_id, gbuf["u"], gbuf["v"],
        gbuf["dudx"], gbuf["dvdx"], gbuf["dudy"], gbuf["dvdy"])
    alb_r = cf_r * at_r * gbuf["cr"]
    alb_g = cf_g * at_g * gbuf["cg"]
    alb_b = cf_b * at_b * gbuf["cb"]
    # metallic = factor * tex.b, roughness = factor * tex.g (frag:196-197)
    mr_g, mr_b = tex.sample_trilinear(
        scene.textures, mr_id, gbuf["u"], gbuf["v"],
        gbuf["dudx"], gbuf["dvdx"], gbuf["dudy"], gbuf["dvdy"],
        channels=(1, 2))
    metallic = metal_f * mr_b
    roughness = rough_f * mr_g

    f0_r = 0.04 * (1.0 - metallic) + alb_r * metallic
    f0_g = 0.04 * (1.0 - metallic) + alb_g * metallic
    f0_b = 0.04 * (1.0 - metallic) + alb_b * metallic

    n_dot_v = torch.clamp(nx * vx + ny * vy + nz * vz, min=0.0)
    n_dot_l = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
    n_dot_h = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    h_dot_v = torch.clamp(hx * vx + hy * vy + hz * vz, min=0.0)

    ndf = _distribution_ggx(n_dot_h, roughness)
    g = (_geometry_schlick_ggx(n_dot_v, roughness)
         * _geometry_schlick_ggx(n_dot_l, roughness))
    fr = _fresnel_schlick(h_dot_v, f0_r)
    fg = _fresnel_schlick(h_dot_v, f0_g)
    fb = _fresnel_schlick(h_dot_v, f0_b)

    one_minus_metal = 1.0 - metallic
    kd_r = (1.0 - fr) * one_minus_metal
    kd_g = (1.0 - fg) * one_minus_metal
    kd_b = (1.0 - fb) * one_minus_metal

    denom = 4.0 * n_dot_v * n_dot_l + 0.0001
    ndf_g = ndf * g
    spec_r = ndf_g * fr / denom
    spec_g = ndf_g * fg / denom
    spec_b = ndf_g * fb / denom

    rad = scene_data["sunlight_color"]
    lo_r = (kd_r * alb_r / PI + spec_r) * n_dot_l * rad[0]
    lo_g = (kd_g * alb_g / PI + spec_g) * n_dot_l * rad[1]
    lo_b = (kd_b * alb_b / PI + spec_b) * n_dot_l * rad[2]

    amb = scene_data["ambient_color"]
    shadow = compute_shadow_factor(shadow_maps, gbuf["wx"], gbuf["wy"],
                                   gbuf["wz"], gbuf["view_z"], scene_data,
                                   shadow_mode, enable_shadows)
    lit = 1.0 - shadow
    out_r = amb[0] * alb_r + lo_r * lit
    out_g = amb[1] * alb_g + lo_g * lit
    out_b = amb[2] * alb_b + lo_b * lit
    return (out_r, out_g, out_b), at_a


def shade_flat(gbuf: dict, scene, scene_data: dict, shadow_maps,
               shadow_mode: int, enable_shadows: bool):
    """mesh.frag main (124-182): Lambert + ambient with the same shadow
    library and alpha handling (shade.py:777-840, dense filter).
    Returns ((r, g, b), albedo_alpha), all planar."""
    mrow = torch.stack(
        [scene.mat_tex_ids[:, 0].to(torch.float32),
         scene.mat_color_factors[:, 0], scene.mat_color_factors[:, 1],
         scene.mat_color_factors[:, 2]], dim=-1)[gbuf["mat_id"].long()]
    albedo_id = mrow[..., 0].to(torch.int32)
    cf_r, cf_g, cf_b = mrow[..., 1], mrow[..., 2], mrow[..., 3]
    at_r, at_g, at_b, at_a = tex.sample_trilinear(
        scene.textures, albedo_id, gbuf["u"], gbuf["v"],
        gbuf["dudx"], gbuf["dvdx"], gbuf["dudy"], gbuf["dvdy"])
    col_r = gbuf["cr"] * at_r * cf_r
    col_g = gbuf["cg"] * at_g * cf_g
    col_b = gbuf["cb"] * at_b * cf_b

    nx, ny, nz = _normalize3(gbuf["nx"], gbuf["ny"], gbuf["nz"])
    sun = scene_data["sunlight_direction"]
    inv_sun = torch.rsqrt(torch.clamp(
        sun[0] ** 2 + sun[1] ** 2 + sun[2] ** 2, min=1e-40))
    lx, ly, lz = -sun[0] * inv_sun, -sun[1] * inv_sun, -sun[2] * inv_sun
    n_dot_l = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)

    shadow = compute_shadow_factor(shadow_maps, gbuf["wx"], gbuf["wy"],
                                   gbuf["wz"], gbuf["view_z"], scene_data,
                                   shadow_mode, enable_shadows)
    lit = 1.0 - shadow
    rad = scene_data["sunlight_color"]
    amb = scene_data["ambient_color"]
    out_r = n_dot_l * col_r * rad[0] * lit + amb[0] * col_r
    out_g = n_dot_l * col_g * rad[1] * lit + amb[1] * col_g
    out_b = n_dot_l * col_b * rad[2] * lit + amb[2] * col_b
    return (out_r, out_g, out_b), at_a
