"""The per-frame render graph, eager PyTorch.

Port of vk_renderer_tpu/graph/frame.py (``render_frame``, frame.py:863).
Pass order and semantics match the reference frame (VulkanEngine::draw,
src/vk_engine_run.cpp:68-193):

  shadow maps -> background gradient/clear -> opaque geometry raster ->
  alpha-masked k-buffer peel -> G-buffer + PBR or flat shading -> skybox
  (fills depth==1 pixels) -> additive transparent peels -> tonemap.

The raster passes run the hand-written CUDA kernels on the GPU (through
ops/raster.py), and so do the gradient background and the tonemap
(ops/post.py) and the masked pass's alpha resolve (ops/masked.py, one
launch a k-buffer round); on the CPU each runs its plain PyTorch
version.

Shadows take the JAX frame's default path: the penumbra classifier
(shade.classified_shadow_factor over the tables of
``_build_classifier_tables``) filters only the pixels it cannot prove
fully lit or fully blocked.  It is exact — the image equals the dense
filter's (``shadow_classify_cap=0``) bit for bit.  Its windows are the
JAX frame's (``shadow_traced_windows``, on by default): the JAX frame
passes its shadow mode as a traced value, so its classifier takes the
union window of all four modes, and only with the same windows does
the port leave the same pixels uncertain — so only then does
``fallback_px`` (the classifier's cap misses) equal the JAX frame's once
a frame has more uncertain pixels than its cap.  The cost is pixels the
static-mode windows of the port's host-int mode would prove: on Hard and
PCF frames the union window is the blocker-search radius, not 0 or 1
texel, and at PCSS the fine window is at least one texel wide; those
pixels run the filter instead.  ``shadow_traced_windows=False`` keeps
the narrower windows: the same image, fewer uncertain pixels.

Left out are the JAX package's TPU-only layout forms, each documented
there as bit-identical to its plain form: packed and alpha row tables,
alpha states and quads, ShadowRows / CoarseRows, ``optimization_barrier``
pins, the compaction tier ladders (the port gathers exactly the pixels a
pass needs with ``torch.nonzero``), ``pair_cap`` and the packed frame
vector.  The stats follow the JAX frame: ``fallback_px`` counts the
classifier's and the sky's cap misses (uncertain or sky pixels beyond
the cap, which then take the dense path — exact, just slower); it has no
term for the masked pass's tail-tile cap or ``pair_cap``, TPU forms with
no counterpart here.  ``sparse_overflow`` counts pixels the opt-in plain
shadow compaction (``shadow_sparse_cap``) leaves unfiltered.

While a torch profiler records, each stage runs inside a ``vkr.*`` span
and the frame counts its work (utils/tracing.py): ``frames``,
``shadow.cascades`` (cascades the shadow pass rendered, in one batch a
call), ``masked.rounds`` (k-buffer rounds that ran), ``masked.alpha_px``
(the alpha test's pixels, added up on the device by the resolve) and
``shade.uncertain_px`` (the classifier's).
graph/profiler.py reads the spans.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import interp, masked, post, raster, shade, skybox
from ..ops import setup as rsetup
from ..ops import texture as tex
from ..ops.common import cdiv, from_tiles, to_tiles
from ..utils import tracing

NUM_CASCADES = 4

# postprocess registry: name -> (f32[3, H, W] -> f32[3, H, W]); the
# reference's only registered pass is tonemap (vk_engine_init.cpp:596)
POSTPROCESS_REGISTRY = {
    "tonemap": post.tonemap,
}


@dataclass(frozen=True)
class FrameConfig:
    """Static pipeline state (the analog of baked VkPipelines).  Field
    names and defaults follow the JAX package's FrameConfig (see its
    docstrings for how each default was sized on the bench scene)."""
    width: int = 1920
    height: int = 1080
    tile_w: int = 128
    tile_h: int = 32
    # per-tile candidate capacities (counts clamp; records are bounded by
    # the rec_* caps) — overflow is counted in bin_overflow
    cap_opaque: int = 16384
    cap_masked: int = 4096
    cap_transparent: int = 256
    # masked (alpha-cutoff) k-buffer depth: round 0 keeps masked_peels
    # layers; deeper reject chains resolve in masked_tail_rounds
    # continuation rounds of masked_tail_peels layers each over the same
    # records; the last round's extra layer is the peel_overflow probe
    masked_peels: int = 10
    masked_tail_rounds: int = 3
    masked_tail_peels: int = 6
    # additive transparent depth peels; one more layer is the probe
    transparent_peels: int = 2
    # occupancy-packed record caps (auto-shrunk to scene size);
    # truncation is counted in bin_overflow
    rec_opaque: int = 4096
    rec_masked: int = 2048
    rec_transparent: int = 1024
    rec_shadow: int = 5120
    # big-triangle capacity for EXACT big binning and the bbox-pair span
    # threshold above which a triangle takes the exact path
    big_cap: int = 1024
    max_span: int = 16
    shadow_max_span: int = 16
    shadow_big_cap: int = 1024
    shading: str = "pbr"    # "pbr" (mesh_pbr.frag) | "flat" (mesh.frag)
    # compiles the shadow SUBSYSTEM in; the per-frame on/off and filter
    # mode ride the scene data's UBO flag channels
    enable_shadows: bool = False     # vk_engine.h:116 default off
    shadow_size: int = 2048          # vk_engine.h:107
    shadow_cap: int = 24576
    # cascades actually rastered (1 for Hard/PCF/PCSS configs, 4 for CSM)
    shadow_cascades: int = NUM_CASCADES
    use_skybox: bool = True
    post_chain: tuple = ("tonemap",)
    # opt-in plain shadow compaction capacity (0 = off): the first cap
    # active pixels are filtered, the rest counted in sparse_overflow
    shadow_sparse_cap: int = 0
    # penumbra-classified shadow filtering (default on, exact): -1 = auto
    # cap (half the frame), 0 = off (dense filter), > 0 explicit; beyond
    # the cap the dense filter runs and the miss lands in fallback_px
    shadow_classify_cap: int = -1
    # the classifier's receiver-quad and fine-window stages (False =
    # coarse window only)
    shadow_fine_classify: bool = True
    # the classifier's windows as the JAX frame's traced shadow mode
    # makes them (the union over all modes); False = the narrower
    # static-mode windows: the same image, fewer uncertain pixels
    shadow_traced_windows: bool = True
    # sky-pixel cap (-1 = auto, a third of the frame; 0 = none); only the
    # fallback_px count depends on it
    sky_sparse_cap: int = -1
    # gated fidelity knob: the metallic-roughness texture sampled at the
    # nearest mip (one bilinear) instead of trilinear; off = exact
    mr_nearest_mip: bool = False


STATS_KEYS = ("triangles", "drawcalls", "bin_overflow", "peel_overflow",
              "sparse_overflow", "fallback_px")


def stats_from_vec(vec) -> dict:
    """One-transfer host fetch of the frame stats."""
    v = vec.cpu().tolist() if isinstance(vec, torch.Tensor) else list(vec)
    return {k: int(v[i]) for i, k in enumerate(STATS_KEYS)}


def _frustum_planes(viewproj: torch.Tensor) -> torch.Tensor:
    """extract_frustum_planes (vk_engine_run.cpp:420-433)."""
    m = viewproj
    planes = torch.stack([m[3] + m[0], m[3] - m[0], m[3] + m[1],
                          m[3] - m[1], m[2], m[3] - m[2]])
    return planes / torch.linalg.norm(planes[:, :3], dim=1, keepdim=True)


def _visible_tris(scene, scene_data):
    planes = _frustum_planes(scene_data["viewproj"])
    visible = rsetup.cull_objects(scene.obj_world, scene.obj_bounds, planes)
    tri_obj = scene.vert_obj[scene.tris[0].long()]
    return visible, visible[tri_obj.long()]


def _shadow_flags(scene_data, cfg: FrameConfig):
    """(mode, enabled) from the reference's UBO flag channels
    (sunlightDirection.w, sunlightColor.w — scenedata.py:132-135)."""
    if not cfg.enable_shadows:
        return 0, False
    mode = int(round(float(scene_data["sunlight_direction"][3])))
    return mode, float(scene_data["sunlight_color"][3]) > 0.5


def _resolve_classify_cap(cfg: FrameConfig) -> int:
    """Uncertain-pixel capacity of classified shadow filtering
    (frame.py:280-292): -1 = auto (half the frame: soft-penumbra scenes
    measure ~36% uncertain at the bench camera), 0 = off."""
    if cfg.shadow_classify_cap >= 0:
        return cfg.shadow_classify_cap
    return max(8192, (cfg.width * cfg.height) // 2)


def _resolve_sky_cap(cfg: FrameConfig) -> int | None:
    """Sky-pixel capacity (frame.py:295-304): -1 = auto (a third of the
    frame), 0 = none."""
    if cfg.sky_sparse_cap == 0:
        return None
    if cfg.sky_sparse_cap > 0:
        return cfg.sky_sparse_cap
    return max(8192, (cfg.width * cfg.height) // 3)


@tracing.spanned("classifier")
def _build_classifier_tables(shadow_packed, cfg: FrameConfig):
    """The classifier's min/max cell tables over the pair-packed maps
    (frame.py:324-341): the coarse level bounds the blocker search, the
    4x-finer level the tap footprint; None when classification is off or
    shadows are compiled out (the 1x1 placeholder maps), the coarse table
    alone without ``shadow_fine_classify``."""
    if cfg.shadow_classify_cap == 0 or not cfg.enable_shadows:
        return None
    coarse = tex.build_shadow_coarse(shadow_packed)
    if not cfg.shadow_fine_classify:
        return coarse
    fine = tex.build_shadow_coarse(
        shadow_packed, block=tex.fine_block_for(shadow_packed.shape[-1]))
    return (coarse, fine)


def render_shadow_maps(scene, world_pos, tri_visible, light_viewproj,
                       cfg: FrameConfig, out_h: int | None = None):
    """Depth-only passes into the shadow_size^2 cascade array
    (vk_engine_run.cpp:334-382): all camera-visible objects (the culled
    list feeds the shadow pass), front-face culling
    (vk_engine_init.cpp:441), no alpha test (no fragment shader).
    With ``out_h`` each cascade is a shadow_size x out_h strip, rastered
    through the row-remapped light matrices the caller passes (the
    sharded path, parallel/sharded.py).  Returns (pair-packed
    i32[L, out_h, S] maps, bin overflow).

    The L cascades run as ONE chain over a leading cascade axis, with no
    host sync: the light transform, setup, binning and records of all
    of them at once, then one depth raster over their tiles stacked
    row-major (cascade c owns tile rows [c * rows, (c + 1) * rows) and
    records [c * rec_cap, (c + 1) * rec_cap)).  Every cascade keeps its
    own triangle ids and tile origins, so each map equals the one a
    cascade rendered alone, bit for bit."""
    s = cfg.shadow_size
    out_h = s if out_h is None else out_h
    n_active = min(cfg.shadow_cascades, light_viewproj.shape[0])
    n_tris = scene.num_triangles
    tracing.count("shadow.cascades", n_active)
    # the triangle corners' WORLD positions, gathered once; the light
    # transform runs over [L, row, corner, T]
    cx, cy, cz = rsetup.gather_corner_positions(world_pos, scene.tris)
    m = light_viewproj[:n_active, :, :, None, None]
    clip = m[:, :, 0] * cx + m[:, :, 1] * cy + m[:, :, 2] * cz + m[:, :, 3]
    corn = tuple([clip[:, r, k] for k in range(3)] for r in range(4))
    st = rsetup.triangle_setup(None, None, tri_visible, s, out_h,
                               cull=rsetup.CULL_FRONT, corners=corn)
    (plan,) = raster.plan_view_buckets(
        st, ((0, n_tris),), s, out_h, cfg.tile_w, cfg.tile_h,
        (cfg.shadow_cap,), (cfg.rec_shadow,), big_cap=cfg.shadow_big_cap,
        max_span=cfg.shadow_max_span)
    plan = raster.prepare_records(plan, raster.pad_setup(st), st["bbox"], s,
                                  cfg.tile_w, cfg.tile_h)
    records = plan["records"]
    rows, cols = plan["counts"].shape[1:]
    rec_cap = records.shape[1]
    first = torch.arange(0, n_active * rec_cap, rec_cap, dtype=torch.int32,
                         device=records.device)
    stacked = {"records": records.reshape(-1, *records.shape[2:]),
               "rec_start": (plan["rec_start"] + first[:, None]).reshape(-1),
               "counts": plan["counts"].reshape(n_active * rows, cols)}
    d, _ = raster.rasterize_plan(stacked, s, n_active * rows * cfg.tile_h,
                                 n_tris, tile_w=cfg.tile_w,
                                 tile_h=cfg.tile_h)
    maps = d.reshape(n_active, rows * cfg.tile_h, s)[:, :out_h]
    return (tex.pack_shadow_maps(maps),
            plan["overflow"].sum(dtype=torch.int32))


def shadow_pass(scene, scene_data: dict, cfg: FrameConfig,
                light_viewproj=None, out_h: int | None = None):
    """The frame's shadow stage: (pair-packed maps, bin overflow or
    None).  With shadows compiled out: the 1x1 placeholder maps.  The
    sharded path passes a strip's row-remapped ``light_viewproj`` and its
    ``out_h``; culling always takes the whole camera frustum."""
    if not cfg.enable_shadows:
        dev = scene.positions[0].device
        return tex.pack_shadow_maps(torch.ones(
            (NUM_CASCADES, 1, 1), dtype=torch.float32, device=dev)), None
    with tracing.span("shadow"):
        _, tri_visible = _visible_tris(scene, scene_data)
        world_pos, _ = rsetup.transform_vertices(
            scene.positions, scene.vert_obj, scene.obj_world,
            scene_data["viewproj"])
        if light_viewproj is None:
            light_viewproj = scene_data["light_viewproj"]
        return render_shadow_maps(scene, world_pos, tri_visible,
                                  light_viewproj, cfg, out_h=out_h)


def render_frame(scene, scene_data: dict, settings: dict, cfg: FrameConfig):
    """One frame.  scene: device SceneArrays (scene/types.scene_to_torch);
    scene_data: the GPUSceneData dict of tensors (driver.
    scene_data_to_torch); settings: {enable_background, enable_postprocess,
    bg_top, bg_bottom} tensors.

    Returns dict: color f32[3, H, W], depth f32[H, W], stats (dict of i32
    scalars), stats_vec i32[6], color_u8 u8[H, W, 3]."""
    tracing.count("frames", 1)
    with tracing.span("frame"):
        shadow_maps, shadow_ovf = shadow_pass(scene, scene_data, cfg)
        coarse = _build_classifier_tables(shadow_maps, cfg)
        return render_view(scene, scene_data, settings, cfg, shadow_maps,
                           shadow_coarse=coarse,
                           extra_bin_overflow=shadow_ovf)


@tracing.spanned("setup")
def view_setup(scene, scene_data: dict, cfg: FrameConfig) -> dict:
    """Culling, vertex stage, triangle setup and the interpolation row
    tables of the camera view (vk_engine_run.cpp:435-480, mesh.vert)."""
    n_tris = scene.num_triangles
    dev = scene.positions[0].device
    visible, tri_visible = _visible_tris(scene, scene_data)
    # never-pass masked triangles (sorted to the masked range's tail) are
    # invisible to the camera — their alpha test provably never passes —
    # but the stats keep counting them and the shadow pass rasters them
    n_mvis = scene.n_masked_vis
    tri_visible_cam = tri_visible
    if n_mvis < scene.n_masked:
        ids = torch.arange(n_tris, device=dev)
        never = (ids >= scene.n_opaque + n_mvis) & \
            (ids < scene.n_opaque + scene.n_masked)
        tri_visible_cam = tri_visible & ~never
    world_pos, clip = rsetup.transform_vertices(
        scene.positions, scene.vert_obj, scene.obj_world,
        scene_data["viewproj"])
    world_nrm = rsetup.transform_normals(scene.normals, scene.vert_obj,
                                         scene.obj_world)
    st = rsetup.triangle_setup(clip, scene.tris, tri_visible_cam,
                               cfg.width, cfg.height, cull=rsetup.CULL_BACK)
    padded = raster.pad_setup(st)
    zero_i = torch.zeros((1,), dtype=torch.int32, device=dev)
    tris_p = tuple(torch.cat([t, zero_i]) for t in scene.tris)
    tri_mat_p = torch.cat([scene.tri_material, zero_i])
    vattr, vpos = _build_vertex_rows(scene, world_pos, world_nrm)
    return {"visible": visible, "tri_visible": tri_visible, "st": st,
            "padded": padded,
            "rows": interp.build_tri_rows(padded, tris_p, tri_mat_p),
            "vattr": vattr, "vpos": vpos}


def plan_view(scene, st: dict, cfg: FrameConfig) -> list:
    """Bin every camera-view bucket with ONE pair sort (buckets are
    contiguous tri-id ranges): opaque, the can-pass masked range, then
    the transparent range, each present only if the scene has it."""
    bounds = [(0, scene.n_opaque)]
    caps = [cfg.cap_opaque]
    rec_caps = [cfg.rec_opaque]
    if scene.n_masked_vis > 0:
        bounds.append((scene.n_opaque, scene.n_opaque + scene.n_masked_vis))
        caps.append(cfg.cap_masked)
        rec_caps.append(cfg.rec_masked)
    if scene.n_transparent > 0:
        bounds.append((scene.n_opaque + scene.n_masked, scene.num_triangles))
        caps.append(cfg.cap_transparent)
        rec_caps.append(cfg.rec_transparent)
    return list(raster.plan_view_buckets(
        st, tuple(bounds), cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
        tuple(caps), tuple(rec_caps), big_cap=cfg.big_cap,
        max_span=cfg.max_span))


@tracing.spanned("shade")
def shade_view(gbuf, scene, scene_data: dict, cfg: FrameConfig, shadow_maps,
               shadow_coarse=None):
    """Shading with the frame's shadow path (frame.py:1037-1063):
    classified when there are classifier tables and a cap, else the opt-in
    plain compaction, else dense.  Returns (rgb, alpha, fallback_px,
    sparse_overflow), the counts None where the path has none."""
    shader = _shader(cfg)
    shadow_mode, shadows_on = _shadow_flags(scene_data, cfg)
    classify_cap = _resolve_classify_cap(cfg)
    if shadow_coarse is not None and classify_cap > 0:
        rgb, alpha, fb = shader(
            gbuf, scene, scene_data, shadow_maps, shadow_mode, shadows_on,
            shadow_sparse_cap=classify_cap, shadow_coarse=shadow_coarse,
            mr_nearest_mip=cfg.mr_nearest_mip,
            shadow_quad_lit=cfg.shadow_fine_classify,
            shadow_traced_windows=cfg.shadow_traced_windows)
        return rgb, alpha, fb, None
    if cfg.shadow_sparse_cap > 0:
        rgb, alpha, sp = shader(gbuf, scene, scene_data, shadow_maps,
                                shadow_mode, shadows_on,
                                shadow_sparse_cap=cfg.shadow_sparse_cap,
                                mr_nearest_mip=cfg.mr_nearest_mip)
        return rgb, alpha, None, sp
    rgb, alpha = shader(gbuf, scene, scene_data, shadow_maps, shadow_mode,
                        shadows_on, mr_nearest_mip=cfg.mr_nearest_mip)
    return rgb, alpha, None, None


@tracing.spanned("compose")
def compose(rgb, tid, depth, scene, scene_data: dict, settings: dict,
            cfg: FrameConfig, y_offset: int = 0,
            full_height: int | None = None):
    """Shaded pixels over the background (clear (0,0,0) or gradient;
    vk_engine_run.cpp:246-248), then the skybox on the pixels still at
    clear depth (vk_engine_run.cpp:313), for the cfg.height-row strip at
    row ``y_offset`` of a ``full_height`` frame (the whole frame by
    default).  Returns (colour planes, the sky's cap misses or None)."""
    h, w = cfg.height, cfg.width
    full_height = h if full_height is None else full_height
    bg = post.gradient(h, w, settings["bg_top"], settings["bg_bottom"],
                       extent_h=full_height, row0=y_offset) \
        * settings["enable_background"]
    color = tuple(torch.where((tid >= 0)[None], torch.stack(list(rgb)), bg))
    if not (cfg.use_skybox and scene.cubemap is not None):
        return color, None
    return skybox.composite_skybox(color, depth, scene.cubemap,
                                   scene_data["view"], scene_data["proj"],
                                   sparse_cap=_resolve_sky_cap(cfg),
                                   y_offset=y_offset,
                                   full_height=full_height)


@tracing.spanned("tonemap")
def post_chain(color, settings: dict, cfg: FrameConfig):
    """The registered postprocess passes (vk_engine_init.cpp:554-596) over
    the colour planes, applied where enable_postprocess is on; returns
    f32[3, H, W]."""
    color = torch.stack(list(color))
    processed = color
    for pass_name in cfg.post_chain:
        processed = POSTPROCESS_REGISTRY[pass_name](processed)
    return torch.where(settings["enable_postprocess"] > 0.5, processed,
                       color)


@tracing.spanned("view")
def render_view(scene, scene_data: dict, settings: dict, cfg: FrameConfig,
                shadow_maps, y_offset: int = 0, full_height: int | None = None,
                shadow_coarse=None, extra_bin_overflow=None):
    """Camera-view render (everything except the shadow pass) of the
    horizontal strip of cfg.height rows starting at row ``y_offset`` of
    a ``full_height``-row frame (frame.py:906-918): the whole frame by
    default; the sharded path passes each strip with a row-remapped
    ``scene_data['viewproj']``, and only the background and the skybox
    need the strip's place.  The stats fold as the JAX frame's do
    (frame.py:1006-1116)."""
    w, h = cfg.width, cfg.height
    n_tris = scene.num_triangles
    dev = scene.positions[0].device
    i32 = torch.int32

    view = view_setup(scene, scene_data, cfg)
    st, padded = view["st"], view["padded"]
    rows, vattr, vpos = view["rows"], view["vattr"], view["vpos"]
    # triangles submitted per frame (vk_engine_run.cpp:309-310)
    stats_triangles = view["tri_visible"].sum(dtype=i32)
    stats_drawcalls = view["visible"].sum(dtype=i32)

    # ---- geometry raster: opaque bucket then masked bucket, binned once;
    # each bucket's records are built once
    plans = plan_view(scene, st, cfg)
    plan_o = raster.prepare_records(plans.pop(0), padded, st["bbox"], w,
                                    cfg.tile_w, cfg.tile_h)
    with tracing.span("raster_opaque"):
        depth, tid = raster.rasterize_plan(plan_o, w, h, n_tris,
                                           tile_w=cfg.tile_w,
                                           tile_h=cfg.tile_h)

    overflow = plan_o["overflow"]
    if extra_bin_overflow is not None:
        overflow = overflow + extra_bin_overflow
    zero = torch.zeros((), dtype=i32, device=dev)
    peel_overflow = sparse_overflow = fallback_px = zero
    if scene.n_masked_vis > 0:
        plan_m = raster.prepare_records(plans.pop(0), padded, st["bbox"], w,
                                        cfg.tile_w, cfg.tile_h)
        depth, tid, peel_m = _masked_pass(scene, cfg, plan_m, rows, vattr,
                                          depth, tid)
        overflow = overflow + plan_m["overflow"]
        peel_overflow = peel_overflow + peel_m

    # ---- G-buffer interpolation (fixed-function varyings, SURVEY F3)
    gbuf = _build_gbuffer(scene, scene_data, tid, rows, vattr, vpos)

    # ---- shading (planar channels); classifier cap misses are exact
    # (dense fallback), so they count in fallback_px, not as deviations
    rgb, _alpha, fb_sh, sp_sh = shade_view(gbuf, scene, scene_data, cfg,
                                           shadow_maps, shadow_coarse)
    if fb_sh is not None:
        fallback_px = fallback_px + fb_sh
    if sp_sh is not None:
        sparse_overflow = sparse_overflow + sp_sh

    # ---- background compose + skybox
    color, sky_ovf = compose(rgb, tid, depth, scene, scene_data, settings,
                             cfg, y_offset, full_height)
    if sky_ovf is not None:
        fallback_px = fallback_px + sky_ovf

    # ---- additive transparent pass (depth peeling, order-independent sum)
    if scene.n_transparent > 0:
        plan_t = raster.prepare_records(plans.pop(0), padded, st["bbox"], w,
                                        cfg.tile_w, cfg.tile_h)
        # bin_overflow folds in the opaque and masked plans only, as the
        # JAX frame does (frame.py:1087-1096); each plan repeats the view's
        # big-triangle drop, so a third copy would break stats parity
        color, peel_t, sp_t = _transparent_pass(
            scene, scene_data, cfg, plan_t, rows, vattr, vpos, depth,
            shadow_maps, color, shadow_coarse=shadow_coarse)
        peel_overflow = peel_overflow + peel_t
        sparse_overflow = sparse_overflow + sp_t

    # ---- postprocess chain, then [3, H, W]
    color = post_chain(color, settings, cfg)

    stats = {"triangles": stats_triangles, "drawcalls": stats_drawcalls,
             "bin_overflow": overflow.to(i32),
             "peel_overflow": peel_overflow.to(i32),
             "sparse_overflow": sparse_overflow.to(i32),
             # exact-path cap misses (classified shadow, sky): a
             # cap-sizing signal, never a deviation
             "fallback_px": fallback_px.to(i32)}
    return {"color": color, "depth": depth, "stats": stats,
            "stats_vec": torch.stack([stats[k] for k in STATS_KEYS]),
            "color_u8": _to_u8_device(color)}


@tracing.spanned("to_u8")
def _to_u8_device(color: torch.Tensor) -> torch.Tensor:
    """Swapchain blit analog on the device: f32[3, H, W] -> u8[H, W, 3]."""
    q = torch.clamp(color, 0.0, 1.0) * 255.0 + 0.5
    return q.to(torch.uint8).permute(1, 2, 0).contiguous()


def _build_vertex_rows(scene, world_pos, world_nrm):
    """Per-frame packed vertex-attribute row tables.

    Without vertex colors (scene.colors is None — the glTF COLOR_0
    default): ONE 8-wide table vattr [V, 8] = nx ny nz u v wx wy wz,
    vpos = None.  With vertex colors: vattr [V, 8] = nx ny nz cr cg cb u v;
    vpos [V, 4] = wx wy wz pad."""
    if scene.colors is None:
        vattr = torch.stack([world_nrm[0], world_nrm[1], world_nrm[2],
                             scene.uvs[0], scene.uvs[1],
                             world_pos[0], world_pos[1], world_pos[2]],
                            dim=-1)
        return vattr, None
    vattr = torch.stack([world_nrm[0], world_nrm[1], world_nrm[2],
                         scene.colors[0], scene.colors[1], scene.colors[2],
                         scene.uvs[0], scene.uvs[1]], dim=-1)
    vpos = torch.stack([world_pos[0], world_pos[1], world_pos[2],
                        torch.zeros_like(world_pos[0])], dim=-1)
    return vattr, vpos


def _shader(cfg: FrameConfig):
    """mesh_pbr.frag or mesh.frag (frame.py:1033)."""
    return shade.shade_pbr if cfg.shading == "pbr" else shade.shade_flat


@tracing.spanned("gbuffer")
def _build_gbuffer(scene, scene_data, tid, rows, vattr, vpos, px=None,
                   py=None):
    """Planar G-buffer (see ops/shade.py for the key list): dense [H, W],
    or at the explicit pixel centres ``px``/``py`` of a pixel list."""
    g = {}
    weights = interp.interpolation_weights_rows(tid, rows[0], rows[1],
                                                px, py)
    # one corner-gather of the attribute rows serves both the plain
    # interpolation and the UV-derivative quotient rule
    corners = interp.gather_corners(vattr, weights["vidx"])
    g["mat_id"] = weights["mat_id"]
    lam = weights["lam"]
    a = interp.interp_from_corners(corners, lam)
    g["nx"], g["ny"], g["nz"] = a[0], a[1], a[2]
    if vpos is None:
        # colorless layout: nx ny nz u v wx wy wz; vertex color folds to 1
        one = torch.ones_like(a[0])
        g["cr"], g["cg"], g["cb"] = one, one, one
        (g["u"], g["dudx"], g["dudy"]), (g["v"], g["dvdx"], g["dvdy"]) = \
            interp.derivs_from_corners(corners, (3, 4), weights)
        g["wx"], g["wy"], g["wz"] = a[5], a[6], a[7]
    else:
        g["cr"], g["cg"], g["cb"] = a[3], a[4], a[5]
        (g["u"], g["dudx"], g["dudy"]), (g["v"], g["dvdx"], g["dvdy"]) = \
            interp.derivs_from_corners(corners, (6, 7), weights)
        pz = interp.interp_rows(vpos, weights["vidx"], lam)
        g["wx"], g["wy"], g["wz"] = pz[0], pz[1], pz[2]
    view = scene_data["view"]
    g["view_z"] = (g["wx"] * view[2, 0] + g["wy"] * view[2, 1]
                   + g["wz"] * view[2, 2] + view[2, 3])
    g["covered"] = tid >= 0
    return g


@tracing.spanned("masked")
def _masked_pass(scene, cfg: FrameConfig, plan_m, rows, vattr, depth, tid):
    """Alpha-cutoff bucket resolved with the k-buffer (frame.py:579-777):
    round 0 keeps the ``masked_peels`` nearest strictly-increasing
    masked fragments per pixel behind nothing nearer than the opaque
    depth, in ONE pass over the bucket's records; each layer's winner is
    accepted (trilinear albedo alpha >= 0.5, mesh_pbr.frag:193) or
    rejected, front to back, per pixel.  Pixels still pending (every
    layer so far rejected) re-enter the same record stream in up to
    ``masked_tail_rounds`` continuation rounds of ``masked_tail_peels``
    layers, with floor = the deepest rejected layer and the record
    counts zeroed on tiles holding no pending pixel.  The final round's
    extra layer is the probe: a pending pixel that still finds a
    fragment there counts in ``peel_overflow``.

    Each round's layers are resolved by ``masked.masked_resolve``: on the
    card one kernel launch a round, on the CPU its plain version, whose
    alpha test runs only on the (pending, found) pixels of each layer —
    the JAX package's 32-pixel cell ladders compact to the same set.
    Returns (depth, tid, peel_overflow)."""
    w, h = cfg.width, cfg.height
    th, tw = cfg.tile_h, cfg.tile_w
    n_tris = scene.num_triangles
    rows_t, cols_t = cdiv(h, th), cdiv(w, tw)
    dev = depth.device
    rounds = 1 + max(0, cfg.masked_tail_rounds)
    peel_plan = [cfg.masked_peels] + [cfg.masked_tail_peels] * (rounds - 1)

    depth_t = to_tiles(depth, rows_t, cols_t, th, tw, 2.0)
    tid_t = to_tiles(tid, rows_t, cols_t, th, tw, -1)
    bound_t0 = depth_t.contiguous()
    # pixels alpha-tested, fed by the resolve while a profiler records
    tested = tracing.device_counter("masked.alpha_px", dev)

    def resolve(r, layers, state):
        with tracing.span("masked.accept"):
            return masked.masked_resolve(
                *layers, peel_plan[r], r == rounds - 1, state, scene, rows,
                vattr, cols_t, w, h, tested)

    # round 0: the full record stream; pending = the frame extent (tile
    # padding never enters the accept domain or the overflow probe)
    last0 = rounds == 1
    tracing.count("masked.rounds", 1)
    with tracing.span("masked_kraster0"):
        layers = raster.rasterize_plan_k_stacked(
            plan_m, n_tris, peel_plan[0] + (1 if last0 else 0), bound_t0,
            tile_w=tw, tile_h=th)
    state, peel_ovf = resolve(0, layers, (depth_t, tid_t, None, None))

    # continuation rounds: skipped when nothing is pending; a run round
    # re-enters the records only on tiles that still hold pending pixels
    for r in range(1, rounds):
        with tracing.span("masked.tail"):
            pending, deepest = state[2], state[3]
            if not bool(pending.any()):
                break
            tracing.count("masked.rounds", 1)
            last = r == rounds - 1
            pend_tiles = pending.any(dim=2).any(dim=1)
            floor_t = torch.where(pending, deepest, 2.0)
            counts = torch.where(
                pend_tiles.reshape(plan_m["counts"].shape),
                plan_m["counts"], 0)
            layers = raster.rasterize_plan_k_stacked(
                plan_m, n_tris, peel_plan[r] + (1 if last else 0), bound_t0,
                tile_w=tw, tile_h=th, floor_t=floor_t, counts=counts)
            state, peel_ovf = resolve(r, layers, state)
    if peel_ovf is None:        # the probe round never ran
        peel_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    depth_t, tid_t = state[0], state[1]
    depth = from_tiles(depth_t, rows_t, cols_t)[:h, :w]
    tid = from_tiles(tid_t, rows_t, cols_t)[:h, :w]
    return depth, tid, peel_ovf


@tracing.spanned("transparent")
def _transparent_pass(scene, scene_data, cfg: FrameConfig, plan_t, rows,
                      vattr, vpos, depth, shadow_maps, color,
                      shadow_coarse=None):
    """Additive-blend transparent geometry (frame.py:1303-1384, the
    k-raster form): srcAlpha*src + dst with mesh_pbr's alpha = 1, i.e.
    ONE/ONE (vk_pipelines.cpp:108-118), depth test LESS_OR_EQUAL against
    the opaque + masked depth, no depth write.  One k-buffer pass over the
    bucket's records yields ``transparent_peels`` layers plus the probe
    layer; each peel is shaded on exactly its covered pixels and its
    undiscarded colour (albedo alpha >= 0.5, mesh_pbr.frag:193) added in
    peel order.  A pixel the probe layer still covers counts in
    ``peel_overflow``.

    Each peel's shadows take the frame's path with a cap of the peel's
    pixel count (frame.py:1331-1344): classified over ``shadow_coarse``
    when given, else compacted, so neither ever overflows.

    The layers come back in tile space and are cropped to the frame before
    shading and the probe count: tile rows past the frame's last row are
    padding that a triangle's edge functions can still cover.
    Returns (color planes, peel_overflow, sparse_overflow)."""
    w, h = cfg.width, cfg.height
    th, tw = cfg.tile_h, cfg.tile_w
    rows_t, cols_t = cdiv(h, th), cdiv(w, tw)
    bound_t = to_tiles(depth, rows_t, cols_t, th, tw, 2.0)
    _, layer_ids = raster.rasterize_plan_k_stacked(
        plan_t, scene.num_triangles, cfg.transparent_peels + 1, bound_t,
        tile_w=tw, tile_h=th)
    tids = [from_tiles(lt, rows_t, cols_t)[:h, :w].reshape(-1)
            for lt in layer_ids]
    shader = _shader(cfg)
    shadow_mode, shadows_on = _shadow_flags(scene_data, cfg)
    color = [c.reshape(-1) for c in color]
    sparse_ovf = torch.zeros((), dtype=torch.int32, device=depth.device)
    for tid in tids[:-1]:
        sel = torch.nonzero(tid >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        px = (sel % w).to(torch.float32) + 0.5
        py = (sel // w).to(torch.float32) + 0.5
        gbuf = _build_gbuffer(scene, scene_data, tid[sel], rows, vattr, vpos,
                              px, py)
        rgb, alpha, sp_sh = shader(
            gbuf, scene, scene_data, shadow_maps, shadow_mode, shadows_on,
            shadow_sparse_cap=sel.numel(), shadow_coarse=shadow_coarse,
            mr_nearest_mip=cfg.mr_nearest_mip,
            shadow_quad_lit=cfg.shadow_fine_classify,
            shadow_traced_windows=cfg.shadow_traced_windows)
        sparse_ovf = sparse_ovf + sp_sh
        keep = alpha >= 0.5                      # the discard still applies
        color = [cf.index_add(0, sel, torch.where(keep, rc, 0.0))
                 for cf, rc in zip(color, rgb)]
    peel_ovf = (tids[-1] >= 0).sum(dtype=torch.int32)
    return tuple(c.reshape(h, w) for c in color), peel_ovf, sparse_ovf
