"""Minimal GLB writer — builds valid binary glTF for fixtures and
procedural benchmark scenes (the reference's real test scenes are not
distributed; .gitignore:4 excludes sponza.glb/minecraft.glb)."""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Sequence

import numpy as np

from sycl_ray_tracer_torch.utils.gltf import CHUNK_BIN, CHUNK_JSON, GLB_MAGIC


class GlbBuilder:
    def __init__(self):
        self.blob = bytearray()
        self.buffer_views: List[dict] = []
        self.accessors: List[dict] = []
        self.meshes: List[dict] = []
        self.materials: List[dict] = []
        self.nodes: List[dict] = []
        self.cameras: List[dict] = []
        self.images: List[dict] = []
        self.textures: List[dict] = []
        self.scene_extras: dict = {}
        self.extensions_used: List[str] = []

    # -- low level ------------------------------------------------------
    def _add_view(self, data: bytes) -> int:
        while len(self.blob) % 4:
            self.blob.append(0)
        off = len(self.blob)
        self.blob.extend(data)
        self.buffer_views.append(
            {"buffer": 0, "byteOffset": off, "byteLength": len(data)})
        return len(self.buffer_views) - 1

    def _add_accessor(self, arr: np.ndarray, acc_type: str,
                      component: int, minmax: bool = False) -> int:
        view = self._add_view(arr.tobytes())
        acc = {"bufferView": view, "componentType": component,
               "count": int(arr.shape[0]), "type": acc_type}
        if minmax:
            acc["min"] = [float(x) for x in arr.min(0)]
            acc["max"] = [float(x) for x in arr.max(0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    # -- authoring ------------------------------------------------------
    def add_material(self, base_color=(0.8, 0.8, 0.8), metallic=0.0,
                     roughness=0.5, emissive=None, emissive_strength=None,
                     ior=None, transmission=None, name="mat",
                     base_color_texture: Optional[int] = None) -> int:
        mat: dict = {
            "name": name,
            "pbrMetallicRoughness": {
                "baseColorFactor": list(base_color) + [1.0],
                "metallicFactor": float(metallic),
                "roughnessFactor": float(roughness),
            },
        }
        if base_color_texture is not None:
            mat["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": base_color_texture}
        ext = {}
        if emissive is not None:
            mat["emissiveFactor"] = list(emissive)
        if emissive_strength is not None:
            ext["KHR_materials_emissive_strength"] = {
                "emissiveStrength": float(emissive_strength)}
        if ior is not None:
            ext["KHR_materials_ior"] = {"ior": float(ior)}
        if transmission is not None:
            ext["KHR_materials_transmission"] = {
                "transmissionFactor": float(transmission)}
        if ext:
            mat["extensions"] = ext
            for k in ext:
                if k not in self.extensions_used:
                    self.extensions_used.append(k)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture_png(self, png_bytes: bytes) -> int:
        view = self._add_view(png_bytes)
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_mesh(self, positions: np.ndarray, normals: np.ndarray,
                 uvs: np.ndarray, indices: np.ndarray,
                 material: Optional[int]) -> int:
        pos_acc = self._add_accessor(
            positions.astype(np.float32), "VEC3", 5126, minmax=True)
        nrm_acc = self._add_accessor(normals.astype(np.float32), "VEC3", 5126)
        uv_acc = self._add_accessor(uvs.astype(np.float32), "VEC2", 5126)
        idx = indices.astype(np.uint32).reshape(-1, 1)
        idx_acc = self._add_accessor(idx, "SCALAR", 5125)
        prim = {"attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc,
                               "TEXCOORD_0": uv_acc},
                "indices": idx_acc}
        if material is not None:
            prim["material"] = material
        self.meshes.append({"primitives": [prim]})
        return len(self.meshes) - 1

    def add_node(self, mesh: Optional[int] = None,
                 translation: Optional[Sequence[float]] = None,
                 rotation: Optional[Sequence[float]] = None,
                 scale: Optional[Sequence[float]] = None,
                 camera: Optional[int] = None,
                 children: Optional[List[int]] = None) -> int:
        node: dict = {}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if translation is not None:
            node["translation"] = list(translation)
        if rotation is not None:
            node["rotation"] = list(rotation)
        if scale is not None:
            node["scale"] = list(scale)
        if children:
            node["children"] = children
        self.nodes.append(node)
        return len(self.nodes) - 1

    def add_camera(self, yfov: float, aspect: float = 16.0 / 9.0) -> int:
        self.cameras.append({
            "type": "perspective",
            "perspective": {"yfov": float(yfov), "aspectRatio": float(aspect),
                            "znear": 0.01},
        })
        return len(self.cameras) - 1

    def set_sky(self, color, strength: Optional[float] = None):
        self.scene_extras["sky_color"] = list(color)
        if strength is not None:
            self.scene_extras["sky_strength"] = float(strength)

    # -- output ---------------------------------------------------------
    def tobytes(self, root_nodes: Optional[List[int]] = None) -> bytes:
        if root_nodes is None:
            child_set = {c for n in self.nodes for c in n.get("children", [])}
            root_nodes = [i for i in range(len(self.nodes))
                          if i not in child_set]
        scene = {"nodes": root_nodes}
        if self.scene_extras:
            scene["extras"] = self.scene_extras
        gltf = {
            "asset": {"version": "2.0", "generator": "sycl_ray_tracer_torch"},
            "scene": 0,
            "scenes": [scene],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self.blob)}],
        }
        if self.materials:
            gltf["materials"] = self.materials
        if self.cameras:
            gltf["cameras"] = self.cameras
        if self.images:
            gltf["images"] = self.images
            gltf["textures"] = self.textures
            gltf["samplers"] = [{}]
        if self.extensions_used:
            gltf["extensionsUsed"] = self.extensions_used

        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        blob = bytes(self.blob)
        blob += b"\x00" * ((-len(blob)) % 4)
        total = 12 + 8 + len(js) + 8 + len(blob)
        out = struct.pack("<III", GLB_MAGIC, 2, total)
        out += struct.pack("<II", len(js), CHUNK_JSON) + js
        out += struct.pack("<II", len(blob), CHUNK_BIN) + blob
        return out

    def write(self, path: str, root_nodes: Optional[List[int]] = None):
        with open(path, "wb") as f:
            f.write(self.tobytes(root_nodes))
