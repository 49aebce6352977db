"""Per-frame global scene data — the GPUSceneData equivalent.

Reference: the GPUSceneData UBO (src/vk_types.h:93-102 / shaders/common.glsl:18-28)
built each frame in draw() (src/vk_engine_run.cpp:96-128), plus the CPU-side
light-matrix math (src/vk_engine_run.cpp:482-566).

In the TPU build this is a pytree of small arrays fed to the jitted render
function; the flag packing (sunlightColor.w = enableShadows,
sunlightDirection.w = shadowMode, vk_engine_run.cpp:124-125) is preserved so
the in-kernel shader code reads the same fields the GLSL does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import glmath as glm
from ..scene.camera import Camera

NUM_CASCADES = 4  # src/vk_types.h:16


def compute_split(n: float, f: float, i: int) -> float:
    """Practical split scheme, GPU Gems 3 ch.10 (vk_engine_run.cpp:546-552)."""
    p = i / NUM_CASCADES
    c_log = n * (f / n) ** p
    c_uni = n + (f - n) * p
    lam = 0.5
    return lam * c_log + (1.0 - lam) * c_uni


def frustum_corners_world(proj: np.ndarray, view: np.ndarray) -> np.ndarray:
    """All 8 NDC-cube corners unprojected to world (vk_engine_run.cpp:493-504).

    Note the reference samples z in {-1, +1} even though its projection is
    depth-0..1; corners at z=-1 land behind the eye.  Replicated as-is for
    parity.
    """
    inv = glm.inverse(proj @ view)
    corners = []
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                pt = inv @ np.array([2.0 * i - 1.0, 2.0 * j - 1.0, 2.0 * k - 1.0, 1.0],
                                    dtype=np.float32)
                corners.append(pt / pt[3])
    return np.stack(corners)


def compute_light_matrix(sunlight_direction: np.ndarray, camera: Camera) -> np.ndarray:
    """Single-matrix ortho light for shadow modes < 3 (vk_engine_run.cpp:482-491)."""
    light_pos = -sunlight_direction[:3] * 60.0
    light_view = glm.look_at_rh(light_pos, glm.vec3(0.0, 0.0, 0.0), glm.vec3(0.0, 1.0, 0.0))
    light_proj = glm.ortho_rh_zo(-100.0, 100.0, -100.0, 100.0, camera.z_near, camera.z_far)
    light_proj[1, 1] *= -1.0
    return light_proj @ light_view


def get_light_matrix(sunlight_direction: np.ndarray, camera: Camera, aspect: float,
                     z_near: float, z_far: float) -> np.ndarray:
    """Frustum-fitted ortho light matrix for one cascade (vk_engine_run.cpp:506-543)."""
    proj = glm.perspective_rh_zo(np.radians(camera.fov), aspect, z_near, z_far)
    corners = frustum_corners_world(proj, camera.view_matrix())

    center = corners[:, :3].mean(axis=0)
    light_dir = glm.normalize(-sunlight_direction[:3])
    light_view = glm.look_at_rh(center + light_dir, center, glm.vec3(0.0, 1.0, 0.0))

    trf = (light_view @ corners.T).T
    mins = trf[:, :3].min(axis=0)
    maxs = trf[:, :3].max(axis=0)
    min_z, max_z = float(mins[2]), float(maxs[2])

    z_mult = 10.0
    min_z = min_z * z_mult if min_z < 0 else min_z / z_mult
    max_z = max_z / z_mult if max_z < 0 else max_z * z_mult

    light_proj = glm.ortho_rh_zo(float(mins[0]), float(maxs[0]),
                                 float(mins[1]), float(maxs[1]), min_z, max_z)
    return light_proj @ light_view


def compute_csm_data(sunlight_direction: np.ndarray, camera: Camera, aspect: float):
    """4 cascade matrices + split distances (vk_engine_run.cpp:554-566)."""
    matrices = np.zeros((NUM_CASCADES, 4, 4), dtype=np.float32)
    distances = np.zeros(NUM_CASCADES, dtype=np.float32)
    for i in range(NUM_CASCADES):
        split = compute_split(camera.z_near, camera.z_far, i + 1)
        distances[i] = split
        cur_near = camera.z_near if i == 0 else distances[i - 1]
        matrices[i] = get_light_matrix(sunlight_direction, camera, aspect, cur_near, split)
    return matrices, distances


@dataclass
class RenderSettings:
    """The ImGui-mutable engine toggles (src/vk_engine.h:112-126).

    All default OFF except lighting, matching the reference.  These feed the
    jitted render function as traced scalars so toggling never re-compiles.
    """
    enable_shadows: bool = False
    shadow_mode: int = 0          # 0 Hard, 1 PCF, 2 PCSS, 3 CSM (vk_engine_run.cpp:219-220)
    enable_background: bool = False
    enable_postprocess: bool = False
    sunlight_direction: np.ndarray = field(
        default_factory=lambda: glm.vec4(0.5, -1.0, -0.5, 0.0))   # vk_engine.h:112
    sunlight_color: np.ndarray = field(
        default_factory=lambda: glm.vec4(1.0, 1.0, 1.0, 1.0))     # vk_engine.h:113
    ambient_color: np.ndarray = field(
        default_factory=lambda: glm.vec4(0.1, 0.1, 0.1, 1.0))     # vk_engine.h:114
    background_top: np.ndarray = field(
        default_factory=lambda: glm.vec4(1.0, 0.0, 0.0, 1.0))     # vk_engine_init.cpp:504
    background_bottom: np.ndarray = field(
        default_factory=lambda: glm.vec4(0.0, 0.0, 1.0, 1.0))     # vk_engine_init.cpp:505


def build_scene_data(camera: Camera, settings: RenderSettings, aspect: float) -> dict:
    """Assemble the per-frame GPUSceneData pytree (vk_engine_run.cpp:96-128)."""
    view = camera.view_matrix()
    proj = camera.projection_matrix(aspect)
    viewproj = proj @ view

    csm_mats, csm_dists = compute_csm_data(settings.sunlight_direction, camera, aspect)
    light_viewproj = csm_mats
    if settings.shadow_mode < 3:
        light_viewproj = csm_mats.copy()
        light_viewproj[0] = compute_light_matrix(settings.sunlight_direction, camera)

    sunlight_color = settings.sunlight_color.copy()
    sunlight_color[3] = 1.0 if settings.enable_shadows else 0.0
    sunlight_direction = settings.sunlight_direction.copy()
    sunlight_direction[3] = float(settings.shadow_mode)

    return {
        "view": view,
        "proj": proj,
        "viewproj": viewproj,
        # camPos = vec3(inverse(view)[3]) (mesh_pbr.frag:187), precomputed
        "cam_pos": glm.inverse(view)[:3, 3],
        "light_viewproj": light_viewproj.astype(np.float32),
        "cascade_distances": csm_dists,
        "ambient_color": settings.ambient_color.astype(np.float32),
        "sunlight_direction": sunlight_direction.astype(np.float32),
        "sunlight_color": sunlight_color.astype(np.float32),
    }
