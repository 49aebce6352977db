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

The frame's default shadow path is the penumbra classifier
(``classified_shadow_factor``, shade.py:188-559): three exact proofs
sort every active pixel into fully lit (factor 0), fully blocked
(factor 1) or uncertain, and only the uncertain pixels run the filter.
It changes the cost, not the image: the factor equals the dense filter's
(``compute_shadow_factor``) on every active pixel.  The shadow mode and
enable flag are host values here (the frame reads them from the
per-frame scene data), so the mode switch is a Python branch and the
classifier takes its static-mode branches.

All per-pixel math is planar; the G-buffer is a dict of planar tensors:
  nx ny nz | cr cg cb | u v dudx dvdx dudy dvdy | wx wy wz | view_z |
  mat_id | covered
"""

from __future__ import annotations

import torch

from ..utils import tracing
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

# smallest |offset| in the disk (~0.2014): the blocked proof needs only
# ONE search tap's neighbourhood to be provably a blocker
_POISSON_MIN_MAG = min((x * x + y * y) ** 0.5 for x, y in POISSON_DISK)


# ----------------------------------------------------------------------------
# shadow filter library (planar: coordinates as (su, sv, sz) arrays)
# ----------------------------------------------------------------------------

def _blocked(cond):
    return cond.to(torch.float32)


def _shadow_hard(shadow_maps, su, sv, sz, layer):
    """compute_shadow (mesh_pbr.frag:39-46): 1 tap."""
    depth = tex.sample_shadow(shadow_maps, su, sv, layer)
    return _blocked(depth + SHADOW_BIAS < sz)


def _taps(shadow_maps, su, sv, offsets, scale, layer):
    """Every tap of a filter in ONE batched sample: tap k reads
    (su + ox_k * scale, sv + oy_k * scale), or (su + ox_k, sv + oy_k)
    when ``scale`` is None.  Returns [K, ...] depths.  Each element is
    the same f32 arithmetic as a one-tap-at-a-time loop (the JAX filters
    sample tap by tap, a TPU gather-cost choice), in K times fewer eager
    launches."""
    off = torch.tensor(offsets, dtype=torch.float32, device=su.device)
    shape = (-1,) + (1,) * su.dim()
    ox, oy = off[:, 0].reshape(shape), off[:, 1].reshape(shape)
    if scale is not None:
        ox, oy = ox * scale, oy * scale
    return tex.sample_shadow_batch(shadow_maps, su + ox, sv + oy, layer)


def _shadow_pcf(shadow_maps, su, sv, sz, layer):
    """PCF 3x3 (mesh_pbr.frag:48-59); the taps are summed in the
    reference's order."""
    texel = 1.0 / shadow_maps.shape[-1]
    blocked = _blocked(sz - SHADOW_BIAS > _taps(
        shadow_maps, su, sv, [(i * texel, j * texel) for i in (-1, 0, 1)
                              for j in (-1, 0, 1)], None, layer))
    acc = torch.zeros_like(sz)
    for b in blocked:
        acc = acc + b
    return acc / 9.0


def _shadow_pcss(shadow_maps, su, sv, sz, layer):
    """PCSS (mesh_pbr.frag:87-121); the blocker and PCF sums are added
    tap by tap in the reference's order."""
    search_w = LIGHT_SIZE_UV * (sz - NEAR_PLANE) / sz
    z = _taps(shadow_maps, su, sv,
              POISSON_DISK[:NUM_SAMPLES_BLOCKER_SEARCH], search_w, layer)
    hit = z + SHADOW_BIAS < sz
    z_hit = torch.where(hit, z, 0.0)
    hit = hit.to(torch.float32)
    blocker_sum = torch.zeros_like(sz)
    n_blockers = torch.zeros_like(sz)
    for k in range(NUM_SAMPLES_BLOCKER_SEARCH):
        blocker_sum = blocker_sum + z_hit[k]
        n_blockers = n_blockers + hit[k]
    z_blocker = torch.where(n_blockers > 0,
                            blocker_sum / torch.clamp(n_blockers, min=1),
                            -1.0)

    penumbra = (sz - z_blocker) / z_blocker
    radius = penumbra * LIGHT_SIZE_UV * NEAR_PLANE / sz
    blocked = _blocked(sz - SHADOW_BIAS > _taps(
        shadow_maps, su, sv, POISSON_DISK[:NUM_SAMPLES_PCF], radius, layer))
    acc = torch.zeros_like(sz)
    for b in blocked:
        acc = acc + b
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
# penumbra-classified sparse shadow filtering
# ----------------------------------------------------------------------------

# fp-safety margin of the lit / blocked predicates (shade.py:192-197): the
# bilinear lerp and the blocker mean can land a few ulp outside the
# window's [min, max]; 1e-5 dominates that and stays below the 5e-4 bias
_CLASSIFY_EPS = 1e-5
_CLASSIFY_PAD = 4.0    # texels: bilinear footprint (1.5) + fp slack
# receiver-quad position slack in texels (shade.py:199-205)
_QUAD_POS_EPS = 0.01


def _window_minmax(table, cx, cy, hw, layer, map_size: int):
    """Conservative min/max over the 2x2-cell window covering
    [cx-hw, cx+hw] x [cy-hw, cy+hw] (texel-index space) of a min|max<<16
    cell table i32[L, sb, sb] (build_shadow_coarse).  Returns
    (mn, mx, fits, g0x, g0y, block): ``fits`` is False where the window
    spans more than 2 cells per axis (the values are then meaningless and
    the caller leaves the pixel uncertain).  The four cells are read
    directly, the second of each axis clamped to the grid's last cell —
    the values the JAX package's ``take2`` pairs and edge fix-up give."""
    n_layers, sb = table.shape[0], table.shape[-1]
    block = map_size // sb
    layer = torch.clamp(layer, max=n_layers - 1).long()
    bx0 = torch.floor((cx - hw) / block)
    bx1 = torch.floor((cx + hw) / block)
    by0 = torch.floor((cy - hw) / block)
    by1 = torch.floor((cy + hw) / block)
    fits = (bx1 <= bx0 + 1) & (by1 <= by0 + 1)

    def cell0(b):
        # NaN windows (uncovered pixels) read cell 0; they never fit
        return torch.nan_to_num(torch.clamp(b, 0, sb - 1),
                                nan=0.0).to(torch.int32)

    g0x, g0y = cell0(bx0), cell0(by0)
    x0, y0 = g0x.long(), g0y.long()
    x1 = torch.clamp(x0 + 1, max=sb - 1)
    y1 = torch.clamp(y0 + 1, max=sb - 1)
    w00, w10 = table[layer, y0, x0], table[layer, y0, x1]
    w01, w11 = table[layer, y1, x0], table[layer, y1, x1]
    inv_q = 1.0 / tex.SHADOW_Q
    mn = torch.minimum(torch.minimum(w00 & 0xFFFF, w10 & 0xFFFF),
                       torch.minimum(w01 & 0xFFFF, w11 & 0xFFFF)
                       ).to(torch.float32) * inv_q
    mx = torch.maximum(
        torch.maximum((w00 >> 16) & 0xFFFF, (w10 >> 16) & 0xFFFF),
        torch.maximum((w01 >> 16) & 0xFFFF, (w11 >> 16) & 0xFFFF)
    ).to(torch.float32) * inv_q
    return mn, mx, fits, g0x, g0y, block


def _classify_shadow(shadow_coarse, su, sv, sz, layer, map_size: int,
                     shadow_mode: int, return_parts: bool = False,
                     shadow_rows=None, shadow_fine=None,
                     traced_windows: bool = False):
    """Conservative per-pixel classification (shade.py:258-471).  Returns
    (lit_c, blk_c): lit_c => the mode's filter returns exactly 0.0, blk_c
    => exactly 1.0; anything not provable is left uncertain (both False),
    including windows too wide for the 2x2 cells, NaN or degenerate
    coordinates and off-map windows (border depth 1.0 is folded into the
    min/max like the clamp-to-border-white sampler).

    Three proofs, each exact (the JAX docstring has the argument):
    1. the coarse min/max window (``shadow_coarse``) over the union of
       the mode's taps: if even its min is no blocker the factor is 0; if
       even its max is a blocker and (PCSS) the penumbra radius at the
       window min still fits the cells, the factor is 1;
    2. the receiver's own 2x2 texel quad (``shadow_rows``, the full maps):
       when every PCF tap within the bounded radius interpolates that
       quad and even its min is no blocker, the factor is 0;
    3. a 4x-finer min/max window (``shadow_fine``) over the tap footprint
       only (the PCF disk's bounded radius plus the smallest blocker-search
       tap), proving lit and blocked close to the true penumbra.

    ``shadow_mode`` is a host int.  By default the windows are the JAX
    function's static-mode ones (its masks called with a Python int
    mode): Hard and PCF take their own narrow tap union.  With
    ``traced_windows`` they are the ones the JAX frame gets, which
    passes a traced mode: every mode takes the union window of all
    modes (the blocker-search radius, at least one texel), the PCSS
    proofs run for every mode, the receiver quad is gated by
    ``mode >= 2 ? fits : mode < 1``, the fine window by
    ``mode >= 2 ? fits : True`` and widened to ``max(rb_tex, 1)``.  Fewer
    pixels are proven, the factor is exact either way.  Every comparison
    keeps the JAX function's f32 operation order, so the masks agree bit
    for bit on the CPU in both forms."""
    s = float(map_size)
    cx = su * s                      # window centre, texel-index space
    cy = sv * s

    # union tap half-width (texels) before the bilinear-footprint pad:
    # Hard 0, PCF 1 texel, PCSS/CSM the blocker-search Poisson radius
    search_w = LIGHT_SIZE_UV * (sz - NEAR_PLANE) / sz
    static = not traced_windows
    if static and shadow_mode == 0:
        hw_taps = torch.zeros_like(sz)
    elif static and shadow_mode == 1:
        hw_taps = torch.ones_like(sz)
    else:
        hw_taps = torch.clamp(torch.abs(search_w) * s, min=1.0)
    hw_lit = hw_taps + _CLASSIFY_PAD

    mn_g, mx_g, fits, g0x, g0y, block = _window_minmax(
        shadow_coarse, cx, cy, hw_lit, layer, map_size)
    sb = map_size // block

    def touches_border(hw):
        return ((cx - hw < 0.0) | (cx + hw > s - 1.0)
                | (cy - hw < 0.0) | (cy + hw > s - 1.0))

    def quad_lit(m_tex):
        # every tap within m_tex texels of the centre interpolates the
        # centre's 2x2 quad when the bilinear-cell margins exceed m_tex
        # (off-map corners are border 1.0, which never passes)
        lc = torch.clamp(layer, max=shadow_rows.shape[0] - 1)
        t00, t10, t01, t11 = tex.shadow_tap_corners(shadow_rows, su, sv, lc)
        qmin = torch.minimum(torch.minimum(t00, t10), torch.minimum(t01, t11))
        fx = (cx - 0.5) - torch.floor(cx - 0.5)
        fy = (cy - 0.5) - torch.floor(cy - 0.5)
        contained = ((fx >= m_tex) & (fx <= 1.0 - m_tex)
                     & (fy >= m_tex) & (fy <= 1.0 - m_tex))
        return contained & ~(sz - SHADOW_BIAS > qmin - _CLASSIFY_EPS)

    # certain-lit over the lit window (border texels are depth 1.0)
    mn_eff = torch.where(touches_border(hw_lit), torch.clamp(mn_g, max=1.0),
                         mn_g)
    mn_m = mn_eff - _CLASSIFY_EPS
    lit_c = fits & ~(mn_m + SHADOW_BIAS < sz) & ~(sz - SHADOW_BIAS > mn_m)

    def fine_minmax(hw):
        # fine-window bounds over the tap footprint
        mn_f, mx_f, fits_f, _, _, _ = _window_minmax(
            shadow_fine, cx, cy, hw, layer, map_size)
        bl = touches_border(hw)
        mn_fe = torch.where(bl, torch.clamp(mn_f, max=1.0), mn_f) \
            - _CLASSIFY_EPS
        mx_fe = torch.where(bl, torch.clamp(mx_f, min=1.0), mx_f) \
            + _CLASSIFY_EPS
        f_lit = fits_f & ~(sz - SHADOW_BIAS > mn_fe)
        f_blk = (fits_f & (mx_fe + SHADOW_BIAS < sz)
                 & (sz - SHADOW_BIAS > mx_fe))
        return f_lit, f_blk

    def parts(in_region, mx_eff, mx_m, hw_blk):
        return {"fits": fits, "in_region": in_region, "mn": mn_eff,
                "mx": mx_eff, "lit_depth_ok": ~(mn_m + SHADOW_BIAS < sz),
                "blk_depth_ok": (mx_m + SHADOW_BIAS < sz),
                "hw_lit": hw_lit, "hw_blk": hw_blk,
                "border_lit": touches_border(hw_lit)}

    if static and shadow_mode < 2:
        # Hard's single tap is AT the quad centre (m = 0); PCF's 3x3 taps
        # exceed one quad.  Every Hard/PCF tap lies in the lit window, so
        # the blocked proof needs no radius bound.
        if shadow_rows is not None and shadow_mode == 0:
            lit_c = lit_c | quad_lit(0.0)
        mx_eff = torch.where(touches_border(hw_lit),
                             torch.clamp(mx_g, min=1.0), mx_g)
        mx_m = mx_eff + _CLASSIFY_EPS
        blk_c = fits & (mx_m + SHADOW_BIAS < sz) & (sz - SHADOW_BIAS > mx_m)
        if shadow_fine is not None:
            f_lit, f_blk = fine_minmax(hw_lit)
            lit_c = lit_c | f_lit
            blk_c = blk_c | f_blk
        if return_parts:
            return lit_c, blk_c & ~lit_c, parts(fits, mx_eff, mx_m, hw_lit)
        return lit_c, blk_c & ~lit_c

    # worst-case PCSS PCF radius: every blocker-search hit has
    # z >= mn_eff, so the penumbra is bounded by its value there
    zb_min = torch.clamp(mn_m, min=1e-6)
    penumbra_bound = (sz - zb_min) / zb_min
    radius_bound = penumbra_bound * LIGHT_SIZE_UV * NEAR_PLANE / sz
    rb_tex = torch.clamp(radius_bound, min=0.0) * s
    # the radius bound relies on the coarse min covering the search
    # (``fits``); the traced windows' modes < 2 need no radius: the
    # receiver quad holds for Hard only, the fine window for both
    pcss = static or shadow_mode >= 2
    if shadow_rows is not None and (pcss or shadow_mode < 1):
        quad = quad_lit(rb_tex + _QUAD_POS_EPS)
        lit_c = lit_c | ((fits & quad) if pcss else quad)

    if shadow_fine is not None:
        # one fine window serves both sides: the PCF disk's bounded
        # radius (with the traced windows at least PCF's one texel:
        # JAX's max(rb_tex, union1)) and, for the blocked side, the
        # smallest search tap
        rb_f = rb_tex if static else torch.clamp(rb_tex, min=1.0)
        hw_f = torch.maximum(
            rb_f + _CLASSIFY_PAD,
            _POISSON_MIN_MAG * torch.abs(search_w) * s + _CLASSIFY_PAD)
        f_lit, f_blk = fine_minmax(hw_f)
        lit_c = lit_c | ((fits & f_lit) if pcss else f_lit)
        blk_fine = (fits & f_blk) if pcss else f_blk
    else:
        blk_fine = None

    # certain-blocked also needs the PCSS PCF disk at the worst radius to
    # fit the gathered 2x2 cells [g0*B, (g0+2)*B) on both axes
    hw_blk = torch.maximum(hw_lit, torch.abs(radius_bound) * s
                           + _CLASSIFY_PAD)
    bxl = torch.floor((cx - hw_blk) / block)
    bxh = torch.floor((cx + hw_blk) / block)
    byl = torch.floor((cy - hw_blk) / block)
    byh = torch.floor((cy + hw_blk) / block)
    in_region = ((torch.clamp(bxl, min=0) >= g0x)
                 & (torch.clamp(bxh, max=sb - 1) <= g0x + 1)
                 & (torch.clamp(byl, min=0) >= g0y)
                 & (torch.clamp(byh, max=sb - 1) <= g0y + 1))
    mx_eff = torch.where(touches_border(hw_blk), torch.clamp(mx_g, min=1.0),
                         mx_g)
    mx_m = mx_eff + _CLASSIFY_EPS
    blk_c = (fits & in_region
             & (mx_m + SHADOW_BIAS < sz) & (sz - SHADOW_BIAS > mx_m))
    if blk_fine is not None:
        blk_c = blk_c | blk_fine
    if return_parts:
        return lit_c, blk_c & ~lit_c, parts(in_region, mx_eff, mx_m, hw_blk)
    return lit_c, blk_c & ~lit_c


@tracing.spanned("shade.classify")
def classified_shadow_factor(shadow_maps, shadow_coarse, gbuf, scene_data,
                             shadow_mode: int, enable_shadows: bool,
                             n_dot_l, cap: int, quad_lit: bool = True,
                             shadow_fine=None, traced_windows: bool = False):
    """Penumbra-classified shadow factor (shade.py:474-559), exact:
    1. classify every active pixel (covered, sun-facing, shadows on):
       proven lit -> 0, proven blocked -> 1 (_classify_shadow);
    2. gather the uncertain pixels (``torch.nonzero``, raster order);
    3. run the mode's filter on them and scatter back.
    Beyond ``cap`` uncertain pixels the dense filter runs instead (slower,
    never wrong).  Returns (factor, overflow): the overflow counts the
    uncertain pixels beyond ``cap`` — a cap-sizing signal (the frame's
    ``fallback_px``), not a deviation.  ``traced_windows`` picks the JAX
    frame's classifier windows (see _classify_shadow).

    The active-pixel restriction is exact for the image: the factor only
    scales Lo * n_dot_l (mesh_pbr.frag:225), zero where n_dot_l == 0, and
    uncovered pixels are overwritten by the background or skybox."""
    if not enable_shadows:
        return (torch.zeros_like(n_dot_l),
                torch.zeros((), dtype=torch.int32, device=n_dot_l.device))
    su, sv, sz, layer = shadow_coords(gbuf["wx"], gbuf["wy"], gbuf["wz"],
                                      gbuf["view_z"], scene_data, shadow_mode)
    active = gbuf["covered"] & (n_dot_l > 0.0)
    lit_c, blk_c = _classify_shadow(
        shadow_coarse, su, sv, sz, layer, shadow_maps.shape[-1],
        shadow_mode, shadow_rows=shadow_maps if quad_lit else None,
        shadow_fine=shadow_fine, traced_windows=traced_windows)
    uncertain = active & ~lit_c & ~blk_c
    base = (active & blk_c).to(torch.float32)
    sel = torch.nonzero(uncertain.reshape(-1)).squeeze(1)
    n_unc = sel.numel()
    tracing.count("shade.uncertain_px", n_unc)
    if n_unc > cap:
        shadow = torch.where(uncertain, _filter_dispatch(
            shadow_maps, su, sv, sz, layer, shadow_mode), base)
    else:
        shadow = base.reshape(-1)
        if n_unc:
            def g(a):
                return a.reshape(-1)[sel]
            shadow[sel] = _filter_dispatch(shadow_maps, g(su), g(sv), g(sz),
                                           g(layer), shadow_mode)
        shadow = shadow.reshape(n_dot_l.shape)
    return shadow, torch.tensor(max(n_unc - cap, 0), dtype=torch.int32,
                                device=n_dot_l.device)


def _sparse_shadow_factor(shadow_maps, gbuf, scene_data, shadow_mode: int,
                          enable_shadows: bool, n_dot_l, cap: int):
    """Shadow factor on the active pixels only (shade.py:593-617, with
    ``compact_mask``'s semantics): the first ``cap`` active pixels in
    raster order are filtered, the rest get 0 (lit) and are counted in
    the returned overflow."""
    dev = n_dot_l.device
    if not enable_shadows:
        return (torch.zeros_like(n_dot_l),
                torch.zeros((), dtype=torch.int32, device=dev))
    mask = gbuf["covered"] & (n_dot_l > 0.0)
    sel = torch.nonzero(mask.reshape(-1)).squeeze(1)
    ovf = max(sel.numel() - cap, 0)
    sel = sel[:cap]

    def g(name):
        return gbuf[name].reshape(-1)[sel]

    shadow = torch.zeros(n_dot_l.numel(), dtype=torch.float32, device=dev)
    shadow[sel] = compute_shadow_factor(shadow_maps, g("wx"), g("wy"),
                                        g("wz"), g("view_z"), scene_data,
                                        shadow_mode, enable_shadows)
    return (shadow.reshape(n_dot_l.shape),
            torch.tensor(ovf, dtype=torch.int32, device=dev))


def _shadow_term(gbuf, scene_data, shadow_maps, shadow_mode: int,
                 enable_shadows: bool, n_dot_l, cap, shadow_coarse,
                 quad_lit: bool, traced_windows: bool):
    """The shaders' shadow factor and overflow (shade.py:750-767): dense
    without a cap (overflow None); with a cap, classified when classifier
    tables are given (``shadow_coarse``: a coarse table or a (coarse,
    fine) pair), else plain compaction of the active pixels."""
    if cap is None:
        return compute_shadow_factor(shadow_maps, gbuf["wx"], gbuf["wy"],
                                     gbuf["wz"], gbuf["view_z"], scene_data,
                                     shadow_mode, enable_shadows), None
    if shadow_coarse is not None:
        coarse, fine = (shadow_coarse if isinstance(shadow_coarse, tuple)
                        else (shadow_coarse, None))
        return classified_shadow_factor(
            shadow_maps, coarse, gbuf, scene_data, shadow_mode,
            enable_shadows, n_dot_l, cap, quad_lit=quad_lit,
            shadow_fine=fine, traced_windows=traced_windows)
    return _sparse_shadow_factor(shadow_maps, gbuf, scene_data, shadow_mode,
                                 enable_shadows, n_dot_l, cap)


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
              shadow_mode: int, enable_shadows: bool,
              shadow_sparse_cap: int | None = None, shadow_coarse=None,
              mr_nearest_mip: bool = False, shadow_quad_lit: bool = True,
              shadow_traced_windows: bool = False):
    """mesh_pbr.frag main (185-226) over the planar G-buffer.
    Returns ((r, g, b), albedo_alpha), all planar — plus the shadow
    overflow when ``shadow_sparse_cap`` is set (see _shadow_term; with
    ``shadow_coarse`` the classified path runs, with the JAX frame's
    windows under ``shadow_traced_windows``).  ``mr_nearest_mip``
    samples the metallic-roughness texture at the nearest mip (the gated
    fidelity knob, FrameConfig.mr_nearest_mip)."""
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
        channels=(1, 2), nearest_mip=mr_nearest_mip)
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
    shadow, sp_ovf = _shadow_term(gbuf, scene_data, shadow_maps, shadow_mode,
                                  enable_shadows, n_dot_l, shadow_sparse_cap,
                                  shadow_coarse, shadow_quad_lit,
                                  shadow_traced_windows)
    lit = 1.0 - shadow
    out_r = amb[0] * alb_r + lo_r * lit
    out_g = amb[1] * alb_g + lo_g * lit
    out_b = amb[2] * alb_b + lo_b * lit
    if sp_ovf is None:
        return (out_r, out_g, out_b), at_a
    return (out_r, out_g, out_b), at_a, sp_ovf


def shade_flat(gbuf: dict, scene, scene_data: dict, shadow_maps,
               shadow_mode: int, enable_shadows: bool,
               shadow_sparse_cap: int | None = None, shadow_coarse=None,
               mr_nearest_mip: bool = False, shadow_quad_lit: bool = True,
               shadow_traced_windows: bool = False):
    """mesh.frag main (124-182): Lambert + ambient with the same shadow
    library and alpha handling (shade.py:777-840).  Returns ((r, g, b),
    albedo_alpha), all planar, plus the shadow overflow when
    ``shadow_sparse_cap`` is set (as shade_pbr)."""
    del mr_nearest_mip   # no metallic-roughness texture in the flat path
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

    shadow, sp_ovf = _shadow_term(gbuf, scene_data, shadow_maps, shadow_mode,
                                  enable_shadows, n_dot_l, shadow_sparse_cap,
                                  shadow_coarse, shadow_quad_lit,
                                  shadow_traced_windows)
    lit = 1.0 - shadow
    rad = scene_data["sunlight_color"]
    amb = scene_data["ambient_color"]
    out_r = n_dot_l * col_r * rad[0] * lit + amb[0] * col_r
    out_g = n_dot_l * col_g * rad[1] * lit + amb[1] * col_g
    out_b = n_dot_l * col_b * rad[2] * lit + amb[2] * col_b
    if sp_ovf is None:
        return (out_r, out_g, out_b), at_a
    return (out_r, out_g, out_b), at_a, sp_ovf
