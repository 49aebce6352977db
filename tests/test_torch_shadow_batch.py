"""The shadow pass renders its cascades as one batch over a leading
cascade axis (graph/frame.render_shadow_maps).  Held here, on the CPU at
small sizes, against a loop that renders one cascade at a time through
the port's single-view functions (L = 1): the pair-packed maps and the
bin overflow bit for bit, for 1, 2 and 4 cascades, the whole map and a
strip, and a big-triangle capacity that the cube and the glTF fixture
overflow (the big triangles' sync-free slots and their drop count).
Also ``binning.bin_buckets_packed`` over [L, T] planes against L calls
over [T] planes, plan for plan.  Imports no JAX."""

import dataclasses
import os

import pytest
import torch

from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
from vk_renderer_tpu_torch.ops import binning, raster
from vk_renderer_tpu_torch.ops import setup as rsetup
from vk_renderer_tpu_torch.ops import texture as tex
from vk_renderer_tpu_torch.parallel import sharded
from vk_renderer_tpu_torch.scene import procedural
from vk_renderer_tpu_torch.scene.assembly import SceneBuilder
from vk_renderer_tpu_torch.scene.camera import Camera
from vk_renderer_tpu_torch.scene.types import scene_to_torch

import torch_threads  # noqa: F401  (bounds torch's threads)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "textured_box", "scene.gltf")
SHADOW = 256
# the strip: rows STRIP_Y0 .. STRIP_Y0 + STRIP_H of every cascade, which
# hold the shadow casters of both scenes
STRIP_Y0, STRIP_H = 48, 64


def _cube():
    return procedural.build_cube_scene().build()


def _fixture():
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "fixture")
    b.cubemap = procedural.make_sky_cubemap(16)
    return b.build()


SCENES = {"cube": _cube, "fixture": _fixture}
# (shadow_big_cap, shadow_max_span): the frame's defaults, and one whose
# big triangles overflow the capacity in both scenes
CAPS = {"default": (1024, 16), "overflowing": (1, 1)}


@pytest.fixture(scope="module", params=list(SCENES))
def scene_inputs(request):
    scene = scene_to_torch(SCENES[request.param](), "cpu")
    settings = RenderSettings(enable_shadows=True, shadow_mode=3)
    cfg = driver.config_from_settings(settings, 64, 32, shadow_size=SHADOW)
    sd, _ = driver.frame_inputs(scene, Camera(), settings, cfg)
    _, tri_visible = frame._visible_tris(scene, sd)
    world_pos, _ = rsetup.transform_vertices(
        scene.positions, scene.vert_obj, scene.obj_world, sd["viewproj"])
    return request.param, scene, sd, cfg, world_pos, tri_visible


def _light_matrices(sd, cfg, strip: bool):
    """(light matrices, out_h): the whole maps, or a strip of them
    through its row-remapped matrices (parallel/sharded.py)."""
    if not strip:
        return sd["light_viewproj"], None
    return torch.stack([
        sharded._row_slice_matrix(m, STRIP_Y0, cfg.shadow_size, STRIP_H)
        for m in sd["light_viewproj"]]), STRIP_H


def _one_at_a_time(scene, world_pos, tri_visible, lvp, cfg, out_h):
    """Each cascade alone through the single-view (L = 1) functions:
    (pair-packed maps, summed bin overflow)."""
    s = cfg.shadow_size
    out_h = s if out_h is None else out_h
    n_tris = scene.num_triangles
    cw = [[c[i] for i in scene.tris] for c in world_pos]
    maps, overflow = [], 0
    for m in lvp[:min(cfg.shadow_cascades, lvp.shape[0])]:
        corn = tuple([m[r, 0] * cw[0][k] + m[r, 1] * cw[1][k]
                      + m[r, 2] * cw[2][k] + m[r, 3] for k in range(3)]
                     for r in range(4))
        st = rsetup.triangle_setup(None, None, tri_visible, s, out_h,
                                   cull=rsetup.CULL_FRONT, corners=corn)
        (plan,) = raster.plan_view_buckets(
            st, ((0, n_tris),), s, out_h, cfg.tile_w, cfg.tile_h,
            (cfg.shadow_cap,), (cfg.rec_shadow,),
            big_cap=cfg.shadow_big_cap, max_span=cfg.shadow_max_span)
        assert plan["rec_tri"].dim() == 1
        plan = raster.prepare_records(plan, raster.pad_setup(st), st["bbox"],
                                      s, cfg.tile_w, cfg.tile_h)
        d, _ = raster.rasterize_plan(plan, s, out_h, n_tris,
                                     tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        maps.append(d)
        overflow += int(plan["overflow"])
    return tex.pack_shadow_maps(torch.stack(maps)), overflow


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("strip", [False, True], ids=["whole", "strip"])
@pytest.mark.parametrize("cascades", [1, 2, 4])
def test_batched_maps_equal_one_cascade_at_a_time(scene_inputs, cascades,
                                                  strip, caps):
    name, scene, sd, cfg, world_pos, tri_visible = scene_inputs
    big_cap, max_span = CAPS[caps]
    cfg = dataclasses.replace(cfg, shadow_cascades=cascades,
                              shadow_big_cap=big_cap,
                              shadow_max_span=max_span)
    lvp, out_h = _light_matrices(sd, cfg, strip)
    want, want_ovf = _one_at_a_time(scene, world_pos, tri_visible, lvp, cfg,
                                    out_h)
    got, got_ovf = frame.render_shadow_maps(scene, world_pos, tri_visible,
                                            lvp, cfg, out_h=out_h)
    assert got.dtype == torch.int32
    assert got.shape == (cascades, out_h or SHADOW, SHADOW)
    assert torch.equal(got, want)
    assert got_ovf.dtype == torch.int32 and got_ovf.shape == ()
    assert int(got_ovf) == want_ovf
    # every map holds casters, unless the small capacity drops them; it
    # does, but for the fixture's first cascade, whose one big triangle
    # fits
    empty = tex.pack_shadow_maps(torch.ones(1, 1, 1))
    if caps == "default":
        assert want_ovf == 0
        assert bool((got != empty).flatten(1).any(1).all())
    else:
        assert want_ovf > 0 or (name, cascades) == ("fixture", 1)


@pytest.mark.parametrize("caps", list(CAPS))
@pytest.mark.parametrize("cascades", [2, 4])
def test_batched_binning_equals_one_view_at_a_time(scene_inputs, cascades,
                                                   caps):
    """bin_buckets_packed over the cascades' [L, T] setup planes gives,
    for every view, the plans of a call over that view's [T] planes: two
    buckets (the scene's two halves), every array equal."""
    _, scene, sd, cfg, world_pos, tri_visible = scene_inputs
    big_cap, max_span = CAPS[caps]
    n_tris = scene.num_triangles
    cx, cy, cz = rsetup.gather_corner_positions(world_pos, scene.tris)
    m = sd["light_viewproj"][:cascades, :, :, None, None]
    clip = m[:, :, 0] * cx + m[:, :, 1] * cy + m[:, :, 2] * cz + m[:, :, 3]
    st = rsetup.triangle_setup(
        None, None, tri_visible, SHADOW, SHADOW, cull=rsetup.CULL_FRONT,
        corners=tuple([clip[:, r, k] for k in range(3)] for r in range(4)))
    assert st["valid"].shape == (cascades, n_tris)
    kw = dict(bounds=((0, n_tris // 2), (n_tris // 2, n_tris)),
              width=SHADOW, height=SHADOW, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, caps=(64, 48), rec_caps=(96, 80),
              max_span=max_span, big_cap=big_cap)
    batched = binning.bin_buckets_packed(st["bbox"], st["valid"],
                                         edge=st["edge"],
                                         anchor=st["anchor"], **kw)
    for c in range(cascades):
        def view(planes):
            return [p[c] for p in planes]

        single = binning.bin_buckets_packed(
            view(st["bbox"]), st["valid"][c], edge=view(st["edge"]),
            anchor=view(st["anchor"]), **kw)
        assert len(single) == len(batched) == 2
        for one, many in zip(single, batched):
            assert set(one) == set(many)
            for key in one:
                assert torch.equal(one[key], many[key][c]), (c, key)
