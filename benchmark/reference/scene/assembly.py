"""Scene assembly: glTF / procedural meshes -> node graph -> SceneArrays.

Mirrors the reference's load-time pipeline:
- load_gltf (src/vk_loader.cpp:227-518): images -> bindless slots, materials
  -> MaterialInstance params (including the texture-ID swap quirk, see
  ``_build_material``), primitives -> one vertex/index pool per mesh with
  per-surface (startIndex, count, material), AABB -> bounding sphere,
  node hierarchy.
- Node::refreshTransform flattening into the RenderObject draw list
  (src/vk_types.h:148-163).

The output is a single SoA ``SceneArrays`` pytree: triangles bucketed into
[opaque | masked | transparent] ranges (replacing the reference's
opaque-first draw sort, vk_engine_run.cpp:454-458), object world matrices
and whole-mesh bounding spheres for the device-side frustum cull.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .gltf import GltfAsset
from .textures import make_checkerboard_u8, make_default_heap
from .types import PASS_OPAQUE, PASS_TRANSPARENT, SceneArrays


@dataclass
class Material:
    """MaterialInstance params (src/vk_materials.h:14-21)."""
    color_factors: np.ndarray
    metal_rough_factors: np.ndarray
    albedo_id: int = 0
    normal_id: int = 1
    metal_rough_id: int = 0
    pass_type: int = PASS_OPAQUE
    can_discard: bool = False   # albedo texture has texels with alpha < 0.5


@dataclass
class Surface:
    """GeoSurface (src/vk_types.h:106-110): a triangle range + material."""
    first_tri: int
    tri_count: int
    material: int   # index into SceneBuilder.materials


@dataclass
class MeshData:
    """MeshAsset analog: SoA vertex arrays + surfaces + bounds."""
    name: str
    positions: np.ndarray   # f32[V, 3]
    normals: np.ndarray
    uvs: np.ndarray
    colors: np.ndarray
    tris: np.ndarray        # i32[T, 3]
    surfaces: list[Surface]
    bounds_origin: np.ndarray
    bounds_radius: float


@dataclass
class Node:
    """Scene-graph node (src/vk_types.h:139-169)."""
    local_transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    mesh: MeshData | None = None
    children: list["Node"] = field(default_factory=list)

    def add_child(self, child: "Node") -> None:
        self.children.append(child)


@dataclass
class RenderObject:
    mesh: MeshData
    surface: Surface
    material: int
    world: np.ndarray


def flatten_nodes(root: Node) -> list[RenderObject]:
    """refreshTransform: world = parent @ local, one RenderObject per surface."""
    out: list[RenderObject] = []

    def visit(node: Node, parent_world: np.ndarray):
        world = (parent_world @ node.local_transform).astype(np.float32)
        if node.mesh is not None:
            for s in node.mesh.surfaces:
                out.append(RenderObject(node.mesh, s, s.material, world))
        for c in node.children:
            visit(c, world)

    visit(root, np.eye(4, dtype=np.float32))
    return out


class SceneBuilder:
    """Accumulates meshes/materials/textures; ``build()`` emits SceneArrays."""

    def __init__(self):
        self.heap, self.default_ids = make_default_heap()
        self.checkerboard_id: int | None = None
        self.materials: list[Material] = []
        self.root = Node()
        self.cubemap: np.ndarray | None = None
        # default material for meshes without one (vk_loader.cpp:369-375)
        self.default_material = self.add_material(Material(
            color_factors=np.ones(4, np.float32),
            metal_rough_factors=np.array([1, 1, 0, 0], np.float32)))

    # -- registration --------------------------------------------------------

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def error_texture(self) -> int:
        if self.checkerboard_id is None:
            self.checkerboard_id = self.heap.add(make_checkerboard_u8(),
                                                 srgb=False, mipmapped=False)
        return self.checkerboard_id

    # -- glTF ----------------------------------------------------------------

    def load_gltf(self, path: str, name: str = "scene") -> Node:
        """Replicates VulkanEngine::load_gltf (src/vk_loader.cpp:227-518)."""
        asset = GltfAsset.load(path)
        j = asset.json

        # images decode once (vk_loader.cpp:272-329); heap slots are
        # created per (image, sampler-mode) pair lazily below, so a glTF
        # texture's sampler state (vk_loader.cpp:253-270 — parsed by the
        # reference but never bound; honored here, VERDICT r4 task 6)
        # rides the slot
        decoded: dict[int, np.ndarray | None] = {}
        slot_cache: dict[tuple[int, int], int] = {}
        samplers = j.get("samplers", [])

        def image_slot(tex_index: int) -> int:
            gtex = j["textures"][tex_index]
            img_idx = gtex.get("source")
            if img_idx is None:
                return self.default_ids["white"]
            from .textures import gltf_sampler_mode
            mode = 0
            if "sampler" in gtex and gtex["sampler"] < len(samplers):
                mode = gltf_sampler_mode(samplers[gtex["sampler"]])
            key = (img_idx, mode)
            if key in slot_cache:
                return slot_cache[key]
            if img_idx not in decoded:
                decoded[img_idx] = asset.decode_image(img_idx)
            rgba = decoded[img_idx]
            slot = (self.error_texture() if rgba is None
                    else self.heap.add(rgba, srgb=True, mipmapped=True,
                                       sampler_mode=mode))
            slot_cache[key] = slot
            return slot

        # materials (vk_loader.cpp:331-367)
        material_ids: list[int] = []
        for mat in j.get("materials", []):
            material_ids.append(self.add_material(self._build_material(mat, image_slot)))
        if not material_ids:
            material_ids.append(self.default_material)

        # meshes (vk_loader.cpp:377-466)
        meshes: list[MeshData] = []
        for mi, mesh in enumerate(j.get("meshes", [])):
            mesh_name = f"{name}_{mesh.get('name', mi)}"
            meshes.append(self._build_mesh(asset, mesh, mesh_name, material_ids))

        # nodes (vk_loader.cpp:469-517)
        nodes: list[Node] = []
        for gnode in j.get("nodes", []):
            n = Node(local_transform=GltfAsset.node_local_transform(gnode))
            if "mesh" in gnode:
                n.mesh = meshes[gnode["mesh"]]
            nodes.append(n)
        for gnode, n in zip(j.get("nodes", []), nodes):
            for ci in gnode.get("children", []):
                n.add_child(nodes[ci])
        top = Node()
        child_set = {id(c) for gn in j.get("nodes", []) for c in
                     [nodes[ci] for ci in gn.get("children", [])]}
        for n in nodes:
            if id(n) not in child_set:
                top.add_child(n)
        self.root.add_child(top)
        return top

    def _build_material(self, mat: dict, image_slot) -> Material:
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        m = Material(
            color_factors=np.array(base, dtype=np.float32),
            metal_rough_factors=np.array(
                [pbr.get("metallicFactor", 1.0), pbr.get("roughnessFactor", 1.0), 0, 0],
                dtype=np.float32),
            pass_type=(PASS_TRANSPARENT if mat.get("alphaMode") == "BLEND"
                       else PASS_OPAQUE),
        )
        # Reference quirk (SURVEY.md quirk 1, vk_loader.cpp:343-363): defaults
        # albedoID=0 (flat normal due to the slot-0 overwrite), normalID=1,
        # metalRoughID=0; metallicRoughnessTexture lands in normalID (never
        # sampled) and normalTexture lands in metalRoughID (sampled as
        # metallic-roughness).  Replicated verbatim for per-pixel parity.
        m.albedo_id = 0
        m.normal_id = 1
        m.metal_rough_id = 0
        if "baseColorTexture" in pbr:
            m.albedo_id = image_slot(pbr["baseColorTexture"]["index"])
        if "metallicRoughnessTexture" in pbr:
            m.normal_id = image_slot(pbr["metallicRoughnessTexture"]["index"])
        if "normalTexture" in mat:
            m.metal_rough_id = image_slot(mat["normalTexture"]["index"])
        m.can_discard = self.heap.min_alpha(m.albedo_id) < 0.5
        return m

    def _build_mesh(self, asset: GltfAsset, mesh: dict, name: str,
                    material_ids: list[int]) -> MeshData:
        positions, normals, uvs, colors, tris = [], [], [], [], []
        surfaces: list[Surface] = []
        vtx_base = 0
        tri_base = 0
        min_pos = np.full(3, 1e5, np.float32)
        max_pos = np.full(3, -1e5, np.float32)

        for prim in mesh.get("primitives", []):
            if "indices" not in prim:
                continue
            idx = asset.read_accessor(prim["indices"]).reshape(-1).astype(np.int64)
            pos = asset.read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
            count = pos.shape[0]
            nrm = np.tile(np.array([[1, 0, 0]], np.float32), (count, 1))
            uv = np.zeros((count, 2), np.float32)
            col = np.ones((count, 4), np.float32)
            if "NORMAL" in prim["attributes"]:
                nrm = asset.read_accessor(prim["attributes"]["NORMAL"]).astype(np.float32)[:, :3]
            if "TEXCOORD_0" in prim["attributes"]:
                uv = asset.read_accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32)[:, :2]
            if "COLOR_0" in prim["attributes"]:
                c = asset.read_accessor(prim["attributes"]["COLOR_0"]).astype(np.float32)
                col = np.concatenate([c, np.ones((count, 1), np.float32)], axis=1) \
                    if c.shape[1] == 3 else c
            positions.append(pos); normals.append(nrm); uvs.append(uv); colors.append(col)
            t = (idx.reshape(-1, 3) + vtx_base).astype(np.int32)
            tris.append(t)
            mat = material_ids[prim["material"]] if "material" in prim else material_ids[0]
            surfaces.append(Surface(first_tri=tri_base, tri_count=t.shape[0], material=mat))
            min_pos = np.minimum(min_pos, pos.min(axis=0))
            max_pos = np.maximum(max_pos, pos.max(axis=0))
            vtx_base += count
            tri_base += t.shape[0]

        origin = (min_pos + max_pos) * 0.5
        extents = (max_pos - min_pos) * 0.5
        return MeshData(
            name=name,
            positions=np.concatenate(positions) if positions else np.zeros((0, 3), np.float32),
            normals=np.concatenate(normals) if normals else np.zeros((0, 3), np.float32),
            uvs=np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32),
            colors=np.concatenate(colors) if colors else np.zeros((0, 4), np.float32),
            tris=np.concatenate(tris) if tris else np.zeros((0, 3), np.int32),
            surfaces=surfaces,
            bounds_origin=origin.astype(np.float32),
            bounds_radius=float(np.linalg.norm(extents)),
        )

    # -- final assembly ------------------------------------------------------

    def build(self) -> SceneArrays:
        objects = flatten_nodes(self.root)

        # bucket objects: opaque (no discard possible) / masked / transparent
        def bucket(ro: RenderObject) -> int:
            m = self.materials[ro.material]
            if m.pass_type == PASS_TRANSPARENT:
                return 2
            return 1 if m.can_discard else 0

        ordered = sorted(range(len(objects)), key=lambda i: (bucket(objects[i]), i))

        positions, normals, uvs, colors, vert_obj = [], [], [], [], []
        tris, tri_material = [], []
        obj_world, obj_bounds = [], []
        counts = [0, 0, 0]
        vtx_cursor = 0
        # one vertex-block copy per (mesh, render-object); meshes instanced by
        # several nodes get duplicated blocks so vert_obj stays well-defined
        for oi, src_idx in enumerate(ordered):
            ro = objects[src_idx]
            mesh, surf = ro.mesh, ro.surface
            t = mesh.tris[surf.first_tri: surf.first_tri + surf.tri_count]
            used = np.unique(t.reshape(-1))
            remap = np.zeros(int(used.max()) + 1 if used.size else 1, dtype=np.int32)
            remap[used] = np.arange(used.size, dtype=np.int32)
            positions.append(mesh.positions[used])
            normals.append(mesh.normals[used])
            uvs.append(mesh.uvs[used])
            colors.append(mesh.colors[used])
            vert_obj.append(np.full(used.size, oi, dtype=np.int32))
            tris.append(remap[t] + vtx_cursor)
            tri_material.append(np.full(t.shape[0], ro.material, dtype=np.int32))
            counts[bucket(ro)] += t.shape[0]
            vtx_cursor += used.size
            obj_world.append(ro.world)
            obj_bounds.append(np.append(mesh.bounds_origin, mesh.bounds_radius))

        n_obj = max(len(objects), 1)
        mats = self.materials
        uvs_a = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)
        tris_a = np.concatenate(tris) if tris else np.zeros((0, 3), np.int32)
        mats_a = (np.concatenate(tri_material) if tri_material
                  else np.zeros(0, np.int32))

        # classify masked triangles by conservative sampled-alpha bounds
        # (textures.tri_alpha_bounds): never-pass triangles (amax < 0.5 —
        # the transparent regions of foliage atlases) sort to the END of
        # the masked range and are excluded from the camera's masked
        # bucket; they still cast shadows (the reference's shadow pass
        # has no fragment stage, vk_engine_init.cpp:434-456).  This both
        # thins the masked records and truncates the deep alpha-reject
        # peel chains at their source.  (The JAX package additionally
        # bakes alpha-state and alpha-quad tables here; the port's masked
        # pass samples the heap directly and needs neither.)
        n_masked_raster = counts[1]
        if counts[1] > 0:
            from .textures import tri_alpha_bounds
            lo, hi = counts[0], counts[0] + counts[1]
            mt = tris_a[lo:hi]
            mm = mats_a[lo:hi]
            tex_of = np.array([m.albedo_id for m in mats], np.int64)[mm]
            cu = uvs_a[mt.reshape(-1), 0].reshape(-1, 3)
            cv = uvs_a[mt.reshape(-1), 1].reshape(-1, 3)
            _, amax = tri_alpha_bounds(self.heap, tex_of, cu, cv)
            # the bounds model the default trilinear+REPEAT sampler;
            # custom-sampler albedo slots stay conservatively can-pass
            modes_of = np.array(self.heap._modes, np.int32)[tex_of]
            never = (amax < 0.5) & (modes_of == 0)
            order = np.argsort(never, kind="stable")   # can-pass first
            tris_a[lo:hi] = mt[order]
            mats_a[lo:hi] = mm[order]
            n_masked_raster = int(np.count_nonzero(~never))

        scene = SceneArrays(
            positions=np.concatenate(positions) if positions else np.zeros((0, 3), np.float32),
            normals=np.concatenate(normals) if normals else np.zeros((0, 3), np.float32),
            uvs=uvs_a,
            colors=np.concatenate(colors) if colors else np.zeros((0, 4), np.float32),
            vert_obj=np.concatenate(vert_obj) if vert_obj else np.zeros(0, np.int32),
            tris=tris_a,
            tri_material=mats_a,
            n_opaque=counts[0], n_masked=counts[1], n_transparent=counts[2],
            n_masked_raster=n_masked_raster,
            obj_world=(np.stack(obj_world) if obj_world
                       else np.eye(4, dtype=np.float32)[None]),
            obj_bounds=(np.stack(obj_bounds).astype(np.float32) if obj_bounds
                        else np.zeros((n_obj, 4), np.float32)),
            mat_color_factors=np.stack([m.color_factors for m in mats]).astype(np.float32),
            mat_metal_rough=np.stack([m.metal_rough_factors for m in mats]).astype(np.float32),
            mat_tex_ids=np.array([[m.albedo_id, m.normal_id, m.metal_rough_id]
                                  for m in mats], dtype=np.int32),
            textures=self.heap.build(),
            cubemap=self.cubemap,
        )
        return scene
