"""Minimal-but-complete glTF 2.0 parser (host side, no third-party gltf lib).

Covers what the reference's fastgltf usage covers (src/vk_loader.cpp:227-518):
- .gltf JSON + external/embedded buffers, and .glb binary container
- accessors: all component types, normalized attributes, byteStride views
- images: external URIs, data URIs, bufferViews — PNG decoded by the
  port's own decoder (utils/image.decode_png: zlib inflate + a small C
  row-unfilter), RGBA8 output; the JAX package decodes with PIL
- samplers, materials (pbrMetallicRoughness + alphaMode + normalTexture),
- meshes/primitives with POSITION / NORMAL / TEXCOORD_0 / COLOR_0,
- node hierarchy with matrix or TRS transforms (vk_loader.cpp:469-517).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}
_NORM_SCALE = {np.int8: 127.0, np.uint8: 255.0, np.int16: 32767.0, np.uint16: 65535.0}


class GltfAsset:
    """Parsed glTF: raw JSON dict + resolved binary buffers + decoded images."""

    def __init__(self, json_dict: dict, buffers: list[bytes], base_dir: str):
        self.json = json_dict
        self.buffers = buffers
        self.base_dir = base_dir

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "GltfAsset":
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return cls._load_glb(data, base_dir)
        j = json.loads(data)
        buffers = [cls._resolve_buffer_uri(b.get("uri"), base_dir, b["byteLength"])
                   for b in j.get("buffers", [])]
        return cls(j, buffers, base_dir)

    @classmethod
    def _load_glb(cls, data: bytes, base_dir: str) -> "GltfAsset":
        magic, version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67 and version == 2, "bad GLB header"
        offset = 12
        j = None
        bin_chunk = None
        while offset < len(data):
            chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8: offset + 8 + chunk_len]
            if chunk_type == 0x4E4F534A:      # 'JSON'
                j = json.loads(chunk)
            elif chunk_type == 0x004E4942:    # 'BIN\0'
                bin_chunk = bytes(chunk)
            offset += 8 + chunk_len + (-chunk_len % 4)
        buffers = []
        for b in j.get("buffers", []):
            if "uri" in b:
                buffers.append(cls._resolve_buffer_uri(b["uri"], base_dir, b["byteLength"]))
            else:
                buffers.append(bin_chunk)
        return cls(j, buffers, base_dir)

    @staticmethod
    def _resolve_buffer_uri(uri: str | None, base_dir: str, byte_length: int) -> bytes:
        if uri is None:
            raise ValueError("buffer with no uri outside GLB")
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(base_dir, uri), "rb") as f:
            return f.read()

    # -- accessors -----------------------------------------------------------

    def read_accessor(self, index: int) -> np.ndarray:
        """Accessor -> np array [count, n] (float32 for normalized/float,
        original int dtype otherwise).  Handles byteStride."""
        acc = self.json["accessors"][index]
        count = acc["count"]
        n = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        item = np.dtype(dtype).itemsize * n

        if "bufferView" not in acc:
            out = np.zeros((count, n), dtype=dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", item)
            if stride == item:
                out = np.frombuffer(buf, dtype=dtype, count=count * n, offset=start)
                out = out.reshape(count, n)
            else:
                raw = np.frombuffer(buf, dtype=np.uint8)
                rows = np.stack([
                    raw[start + i * stride: start + i * stride + item] for i in range(count)
                ])
                out = rows.view(dtype).reshape(count, n)

        if acc.get("sparse"):
            out = out.copy()
            sp = acc["sparse"]
            idx_acc = {"componentType": sp["indices"]["componentType"],
                       "type": "SCALAR", "count": sp["count"],
                       "bufferView": sp["indices"]["bufferView"],
                       "byteOffset": sp["indices"].get("byteOffset", 0)}
            val_acc = {"componentType": acc["componentType"], "type": acc["type"],
                       "count": sp["count"], "bufferView": sp["values"]["bufferView"],
                       "byteOffset": sp["values"].get("byteOffset", 0)}
            self.json["accessors"].append(idx_acc)
            self.json["accessors"].append(val_acc)
            ids = self.read_accessor(len(self.json["accessors"]) - 2).reshape(-1)
            vals = self.read_accessor(len(self.json["accessors"]) - 1)
            del self.json["accessors"][-2:]
            out[ids.astype(np.int64)] = vals

        if acc.get("normalized") and dtype in _NORM_SCALE:
            out = np.maximum(out.astype(np.float32) / _NORM_SCALE[dtype], -1.0)
        return out

    # -- images --------------------------------------------------------------

    def decode_image(self, index: int) -> np.ndarray | None:
        """Image -> u8[H, W, 4], or None on a corrupt image (caller
        substitutes the error checkerboard, vk_loader.cpp:323-328).
        Only PNG is decoded: any other container raises
        NotImplementedError rather than silently rendering the
        checkerboard where the JAX package (PIL) would decode it."""
        from ..utils.image import decode_png, is_png

        img = self.json["images"][index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote
                try:
                    with open(os.path.join(self.base_dir, unquote(uri)),
                              "rb") as f:
                        raw = f.read()
                except OSError:
                    return None
        else:
            bv = self.json["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0)
            raw = bytes(buf[start: start + bv["byteLength"]])
        if not is_png(raw):
            raise NotImplementedError(
                f"image {index}: only PNG images are decoded by the port")
        try:
            return decode_png(raw)
        except ValueError:
            return None

    # -- node transforms -----------------------------------------------------

    @staticmethod
    def node_local_transform(node: dict) -> np.ndarray:
        """Matrix or T*R*S, as fastgltf delivers it (vk_loader.cpp:474-498)."""
        if "matrix" in node:
            # glTF matrices are column-major
            return np.array(node["matrix"], dtype=np.float32).reshape(4, 4).T
        t = np.array(node.get("translation", [0, 0, 0]), dtype=np.float32)
        q = np.array(node.get("rotation", [0, 0, 0, 1]), dtype=np.float32)  # xyzw
        s = np.array(node.get("scale", [1, 1, 1]), dtype=np.float32)
        x, y, z, w = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y), 0],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x), 0],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], dtype=np.float32)
        tm = np.eye(4, dtype=np.float32); tm[:3, 3] = t
        sm = np.diag(np.append(s, 1.0)).astype(np.float32)
        return tm @ rot @ sm
