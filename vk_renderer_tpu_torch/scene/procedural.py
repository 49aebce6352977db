"""Procedural assets — stand-ins for the gitignored reference assets.

The port's own copy of vk_renderer_tpu/scene/procedural.py (plain NumPy),
built on this package's scene/assembly.py and scene/types.py: every
builder's host scene equals the JAX package's array by array
(tests/test_torch_host.py).

The reference loads Sponza.gltf, cube.gltf and pisa_cube.ktx from an assets
directory that is NOT in its repo (.gitignore:3, paths at
src/vk_engine_init.cpp:650,677-678).  These builders produce equivalents:
- ``make_cube``: the Blender-default 2x2x2 cube (what cube.gltf's mesh
  node children[2] contains) used for config-2 and the skybox mesh.
- ``make_sky_cubemap``: procedural sky (any 6-face cubemap works for the
  skybox path; sampling math is what's under test).
- ``build_sponza_like``: a colonnade stress scene at Sponza scale
  (~260k triangles, multiple materials/textures, alpha-masked foliage and
  additive-transparent panes) — the flagship benchmark scene.
"""

from __future__ import annotations

import numpy as np

from .assembly import Material, MeshData, Node, SceneBuilder, Surface
from .types import PASS_OPAQUE, PASS_TRANSPARENT


# ----------------------------------------------------------------------------
# primitive mesh builders (positions CCW when viewed from outside)
# ----------------------------------------------------------------------------

def _quad(p0, p1, p2, p3, normal, uv_scale=1.0):
    """Two CCW triangles for the quad p0..p3 (counter-clockwise from front)."""
    pos = np.array([p0, p1, p2, p3], dtype=np.float32)
    nrm = np.tile(np.asarray(normal, np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return pos, nrm, uv, tris


def box_mesh(half_extents=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0), uv_scale=1.0):
    """Axis-aligned box: 24 verts, 12 tris, per-face normals/uvs."""
    hx, hy, hz = half_extents
    cx, cy, cz = center
    faces = [
        # +z
        ([-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz], [0, 0, 1]),
        # -z
        ([hx, -hy, -hz], [-hx, -hy, -hz], [-hx, hy, -hz], [hx, hy, -hz], [0, 0, -1]),
        # +x
        ([hx, -hy, hz], [hx, -hy, -hz], [hx, hy, -hz], [hx, hy, hz], [1, 0, 0]),
        # -x
        ([-hx, -hy, -hz], [-hx, -hy, hz], [-hx, hy, hz], [-hx, hy, -hz], [-1, 0, 0]),
        # +y
        ([-hx, hy, hz], [hx, hy, hz], [hx, hy, -hz], [-hx, hy, -hz], [0, 1, 0]),
        # -y
        ([-hx, -hy, -hz], [hx, -hy, -hz], [hx, -hy, hz], [-hx, -hy, hz], [0, -1, 0]),
    ]
    all_pos, all_nrm, all_uv, all_tris = [], [], [], []
    base = 0
    for p0, p1, p2, p3, n in faces:
        pos, nrm, uv, tris = _quad(p0, p1, p2, p3, n, uv_scale)
        all_pos.append(pos); all_nrm.append(nrm); all_uv.append(uv)
        all_tris.append(tris + base)
        base += 4
    pos = np.concatenate(all_pos) + np.asarray(center, np.float32)
    return (pos, np.concatenate(all_nrm), np.concatenate(all_uv),
            np.concatenate(all_tris))


def make_mesh(name: str, parts: list[tuple], materials: list[int]) -> MeshData:
    """Assemble (pos, nrm, uv, tris) parts into a MeshData, one surface per part."""
    positions, normals, uvs, colors, tris = [], [], [], [], []
    surfaces = []
    vtx_base, tri_base = 0, 0
    for (pos, nrm, uv, t), mat in zip(parts, materials):
        positions.append(pos); normals.append(nrm); uvs.append(uv)
        colors.append(np.ones((pos.shape[0], 4), np.float32))
        tris.append(t + vtx_base)
        surfaces.append(Surface(first_tri=tri_base, tri_count=t.shape[0], material=mat))
        vtx_base += pos.shape[0]
        tri_base += t.shape[0]
    pos_all = np.concatenate(positions)
    mn, mx = pos_all.min(axis=0), pos_all.max(axis=0)
    return MeshData(
        name=name, positions=pos_all, normals=np.concatenate(normals),
        uvs=np.concatenate(uvs), colors=np.concatenate(colors),
        tris=np.concatenate(tris), surfaces=surfaces,
        bounds_origin=((mn + mx) / 2).astype(np.float32),
        bounds_radius=float(np.linalg.norm((mx - mn) / 2)),
    )


def make_cube() -> MeshData:
    """Blender-default cube: 2x2x2 at origin — the skybox mesh
    (cube.gltf children[2], vk_engine_init.cpp:679)."""
    return make_mesh("cube", [box_mesh()], [0])


# ----------------------------------------------------------------------------
# procedural textures
# ----------------------------------------------------------------------------

def checker_texture(size: int, c0, c1, tiles: int = 8) -> np.ndarray:
    """u8 RGBA checker."""
    y, x = np.mgrid[0:size, 0:size]
    cell = ((x * tiles // size) + (y * tiles // size)) % 2
    img = np.where(cell[..., None] == 0, np.asarray(c0, np.uint8),
                   np.asarray(c1, np.uint8))
    return img.astype(np.uint8)


def noise_texture(size: int, base_rgb, seed: int, alpha_holes: bool = False) -> np.ndarray:
    """Low-frequency value-noise texture; optional alpha cutout pattern
    (for exercising the mesh_pbr.frag:193 alpha-discard path)."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0.4, 1.0, size=(size // 16, size // 16, 3))
    big = np.kron(small, np.ones((16, 16, 1)))
    rgb = np.clip(big * np.asarray(base_rgb, np.float32), 0, 1)
    if alpha_holes:
        hs = rng.uniform(0, 1, size=(size // 8, size // 8))
        a = np.kron(hs > 0.45, np.ones((8, 8))).astype(np.float32)
    else:
        a = np.ones((size, size), np.float32)
    out = np.concatenate([rgb, a[..., None]], axis=-1)
    return (out * 255).astype(np.uint8)


def make_sky_cubemap(face: int = 256) -> np.ndarray:
    """Procedural gradient sky, f32[6, F, F, 3] in Vulkan face order
    (+X,-X,+Y,-Y,+Z,-Z).  Direction-dependent: horizon haze + zenith blue +
    a sun disk, so sampling errors are visible in tests."""
    out = np.zeros((6, face, face, 3), np.float32)
    uv = (np.arange(face, dtype=np.float32) + 0.5) / face * 2.0 - 1.0
    u, v = np.meshgrid(uv, uv)
    dirs = {
        0: np.stack([np.ones_like(u), -v, -u], -1),   # +X
        1: np.stack([-np.ones_like(u), -v, u], -1),   # -X
        2: np.stack([u, np.ones_like(u), v], -1),     # +Y
        3: np.stack([u, -np.ones_like(u), -v], -1),   # -Y
        4: np.stack([u, -v, np.ones_like(u)], -1),    # +Z
        5: np.stack([-u, -v, -np.ones_like(u)], -1),  # -Z
    }
    sun = np.array([0.5, 0.6, -0.4])
    sun = sun / np.linalg.norm(sun)
    for f, d in dirs.items():
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.clip(d[..., 1] * 0.5 + 0.5, 0, 1)[..., None]
        col = (1 - t) * np.array([0.9, 0.8, 0.7]) + t * np.array([0.25, 0.45, 0.85])
        s = np.clip((d @ sun - 0.995) * 200, 0, 1)[..., None]
        out[f] = np.clip(col + s * np.array([2.0, 1.8, 1.2]), 0, 4).astype(np.float32)
    return out


# ----------------------------------------------------------------------------
# scenes
# ----------------------------------------------------------------------------

def build_cube_scene() -> SceneBuilder:
    """Config-2 scene: one cube in front of the camera, flat-shadeable."""
    b = SceneBuilder()
    tex = b.heap.add(checker_texture(256, (200, 200, 200, 255), (60, 60, 60, 255)),
                     srgb=True, mipmapped=True)
    mat = b.add_material(Material(
        color_factors=np.array([1, 0.6, 0.3, 1], np.float32),
        metal_rough_factors=np.array([0.0, 0.8, 0, 0], np.float32),
        albedo_id=tex))
    cube = make_mesh("cube", [box_mesh()], [mat])
    node = Node(mesh=cube)
    node.local_transform[:3, 3] = (0.0, 0.0, -5.0)
    b.root.add_child(node)
    b.cubemap = make_sky_cubemap(128)
    return b


def build_sponza_like(target_tris: int = 260_000, seed: int = 7) -> SceneBuilder:
    """Sponza-class stress scene: floor + colonnade of pillars with beams,
    hanging alpha-masked 'foliage' quads, and additive-transparent panes.
    Triangle count is raised to ``target_tris`` by subdividing the floor and
    pillar boxes.  Spatial extent ~ Sponza's (roughly 30 x 12 x 15 units)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # materials / textures
    floor_tex = b.heap.add(checker_texture(1024, (170, 150, 130, 255),
                                           (90, 80, 70, 255), tiles=32),
                           srgb=True, mipmapped=True)
    wall_tex = b.heap.add(noise_texture(1024, (0.9, 0.8, 0.7), 1), srgb=True, mipmapped=True)
    pillar_tex = b.heap.add(noise_texture(512, (0.8, 0.78, 0.75), 2), srgb=True, mipmapped=True)
    cloth_tex = b.heap.add(noise_texture(512, (0.8, 0.2, 0.2), 3), srgb=True, mipmapped=True)
    leaf_tex = b.heap.add(noise_texture(256, (0.2, 0.7, 0.2), 4, alpha_holes=True),
                          srgb=True, mipmapped=True)

    def mat(tex, rough, metal=0.0, pass_type=PASS_OPAQUE, color=(1, 1, 1, 1)):
        return b.add_material(Material(
            color_factors=np.array(color, np.float32),
            metal_rough_factors=np.array([metal, rough, 0, 0], np.float32),
            albedo_id=tex, pass_type=pass_type,
            can_discard=b.heap.min_alpha(tex) < 0.5))

    m_floor = mat(floor_tex, rough=0.7)
    m_wall = mat(wall_tex, rough=0.9)
    m_pillar = mat(pillar_tex, rough=0.6, metal=0.1)
    m_cloth = mat(cloth_tex, rough=1.0)
    m_leaf = mat(leaf_tex, rough=0.8)
    m_glass = mat(cloth_tex, rough=0.2, pass_type=PASS_TRANSPARENT,
                  color=(0.4, 0.6, 0.9, 0.35))

    def subdiv_quad(p0, p1, p3, normal, nx, ny, uv_scale):
        """Grid-subdivided quad spanning p0->(p1,p3); adds 2*nx*ny tris."""
        p0 = np.asarray(p0, np.float32); p1 = np.asarray(p1, np.float32)
        p3 = np.asarray(p3, np.float32)
        du = (p1 - p0) / nx
        dv = (p3 - p0) / ny
        gx, gy = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
        pos = p0[None, None] + gx[..., None] * du + gy[..., None] * dv
        pos = pos.reshape(-1, 3).astype(np.float32)
        nrm = np.tile(np.asarray(normal, np.float32), (pos.shape[0], 1))
        uv = np.stack([gx / nx, gy / ny], -1).reshape(-1, 2).astype(np.float32) * uv_scale
        idx = lambda i, j: i * (ny + 1) + j
        tris = []
        # wind CCW as seen from the declared normal side, else back-face
        # culling removes the face (the round-2 floor/ceiling were wound
        # against their normals and vanished — sky leaked through 27% of
        # the bench frame)
        flip = float(np.dot(np.cross(du, dv), np.asarray(normal))) < 0.0
        for i in range(nx):
            for j in range(ny):
                a, c2, c3, d = idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)
                if flip:
                    tris.append([a, c3, c2]); tris.append([a, d, c3])
                else:
                    tris.append([a, c2, c3]); tris.append([a, c3, d])
        return pos, nrm, uv, np.array(tris, np.int32)

    parts, mats = [], []

    # floor 30x15, heavily subdivided to reach the triangle budget
    floor_div = 160
    parts.append(subdiv_quad([-15, 0, -7.5], [15, 0, -7.5], [-15, 0, 7.5],
                             [0, 1, 0], floor_div, floor_div // 2, uv_scale=16))
    mats.append(m_floor)
    # ceiling
    parts.append(subdiv_quad([-15, 12, 7.5], [15, 12, 7.5], [-15, 12, -7.5],
                             [0, -1, 0], 60, 30, uv_scale=8))
    mats.append(m_wall)
    # side walls
    parts.append(subdiv_quad([-15, 0, -7.5], [15, 0, -7.5], [-15, 12, -7.5],
                             [0, 0, 1], 80, 32, uv_scale=8))
    mats.append(m_wall)
    parts.append(subdiv_quad([15, 0, 7.5], [-15, 0, 7.5], [15, 12, 7.5],
                             [0, 0, -1], 80, 32, uv_scale=8))
    mats.append(m_wall)
    # end walls
    parts.append(subdiv_quad([-15, 0, 7.5], [-15, 0, -7.5], [-15, 12, 7.5],
                             [1, 0, 0], 40, 32, uv_scale=4))
    mats.append(m_wall)
    parts.append(subdiv_quad([15, 0, -7.5], [15, 0, 7.5], [15, 12, -7.5],
                             [-1, 0, 0], 40, 32, uv_scale=4))
    mats.append(m_wall)

    # colonnade: two rows of pillars with subdivided shafts
    def pillar_parts(x, z):
        out = []
        shaft = box_mesh((0.35, 3.0, 0.35), (x, 3.0, z), uv_scale=2)
        out.append(shaft)
        cap = box_mesh((0.55, 0.25, 0.55), (x, 6.25, z))
        out.append(cap)
        base = box_mesh((0.55, 0.25, 0.55), (x, 0.25, z))
        out.append(base)
        return out

    for x in np.linspace(-13, 13, 14):
        for z in (-4.0, 4.0):
            for p in pillar_parts(x, z):
                parts.append(p); mats.append(m_pillar)
    # upper beams
    for z in (-4.0, 4.0):
        parts.append(box_mesh((14, 0.3, 0.5), (0, 6.8, z), uv_scale=8))
        mats.append(m_pillar)

    # hanging cloth banners
    for x in np.linspace(-11, 11, 8):
        parts.append(subdiv_quad([x - 0.8, 9.5, 0.0], [x + 0.8, 9.5, 0.0],
                                 [x - 0.8, 6.5, 0.0], [0, 0, 1], 12, 20, 1))
        mats.append(m_cloth)

    # alpha-masked foliage quads (crossed pairs)
    for _ in range(40):
        x = rng.uniform(-13, 13); z = rng.uniform(-6.5, 6.5)
        y = rng.uniform(0.8, 1.6)
        s = rng.uniform(0.5, 1.0)
        parts.append(subdiv_quad([x - s, 0, z], [x + s, 0, z], [x - s, 2 * y, z],
                                 [0, 0, 1], 2, 2, 1))
        mats.append(m_leaf)
        parts.append(subdiv_quad([x, 0, z - s], [x, 0, z + s], [x, 2 * y, z - s],
                                 [1, 0, 0], 2, 2, 1))
        mats.append(m_leaf)

    # additive-transparent panes
    for x in np.linspace(-9, 9, 4):
        parts.append(subdiv_quad([x - 1.2, 1.0, 2.0], [x + 1.2, 1.0, 2.0],
                                 [x - 1.2, 4.0, 2.0], [0, 0, 1], 4, 4, 1))
        mats.append(m_glass)

    # top up to the target count by refining the floor again if needed
    total = sum(p[3].shape[0] for p in parts)
    if total < target_tris:
        extra = target_tris - total
        div = max(int(np.sqrt(extra / 4)), 1)
        parts.append(subdiv_quad([-15, 0.001, -7.5], [15, 0.001, -7.5],
                                 [-15, 0.001, 7.5], [0, 1, 0], 2 * div, div, 16))
        mats.append(m_floor)

    mesh = make_mesh("sponza_like", parts, mats)
    b.root.add_child(Node(mesh=mesh))
    b.cubemap = make_sky_cubemap(256)
    return b
