"""Shared-BLAS instancing ingest: a .glb as unique primitives plus an
instance list.

The default ingest (utils/gltf.py, through the native core) bakes every
glTF instance to world space, so R instances of one mesh cost R times
its geometry. The reference instead shares one Embree BLAS per
primitive and instances it per node transform (scene.cpp:435-439,
487-493). This module parses the .glb into UNIQUE primitives in local
space plus (primitive id, world matrix) per instance;
models/instanced.py builds one local BVH per unique primitive and a
global tree over the instances, and the traverse5 kernel transforms
the rays into instance space per leaf.

The native core returns only baked world geometry, so this module
keeps its own copy of the glTF helpers the loader needs (those of the
JAX package's utils/gltf.py); the parsing contract and its documented
deviations are those of the baked ingest, and bake() reproduces the
baked ingest bit for bit.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from sycl_ray_tracer_torch.utils.gltf import (CHUNK_BIN, CHUNK_JSON,
                                              GLB_MAGIC, MAT_DIELECTRIC,
                                              MAT_DIFFUSE, MAT_METALLIC,
                                              TEX_RES, HostMaterialTable,
                                              HostScene, decode_image_bytes)

# image_manager.hpp:12-14: at most 128 images
MAX_IMAGES = 128
DEFAULT_SKY = (0.5, 0.7, 1.0)  # scene.hpp default sky_color

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COMPONENTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclass
class UniquePrim:
    tri_v: np.ndarray   # [T, 3, 3] LOCAL-space vertices
    tri_n: np.ndarray   # [T, 3, 3] LOCAL-space shading normals
    tri_uv: np.ndarray  # [T, 3, 2]
    tri_mat: np.ndarray  # [T] int32


@dataclass
class InstancedHostScene:
    prims: List[UniquePrim]
    inst_prim: np.ndarray    # [I] int32 unique-prim index
    inst_mat: np.ndarray     # [I, 4, 4] float64 world matrices
    materials: HostMaterialTable
    textures: np.ndarray
    sky_color: np.ndarray
    camera_position: np.ndarray
    camera_direction: np.ndarray
    camera_focal_length: float

    @property
    def num_instances(self) -> int:
        return int(self.inst_prim.shape[0])

    @property
    def num_unique_triangles(self) -> int:
        return int(sum(p.tri_v.shape[0] for p in self.prims))

    @property
    def num_world_triangles(self) -> int:
        counts = np.array([p.tri_v.shape[0] for p in self.prims], np.int64)
        return int(counts[self.inst_prim].sum()) if self.prims else 0

    def bake(self) -> HostScene:
        """World-space bake: the representation of the baked ingest
        (utils/gltf.py load_glb), for the tests and the baked render."""
        tv, tn, tu, tm = [], [], [], []
        for p, m4 in zip(self.inst_prim, self.inst_mat):
            pr = self.prims[p]
            m3 = m4[:3, :3]
            nm = _invert3x3_transpose(m3)
            v = pr.tri_v.astype(np.float64)
            tv.append((v @ m3.T + m4[:3, 3]).astype(np.float32))
            n = pr.tri_n.astype(np.float64) @ nm.T
            tn.append(n.astype(np.float32))
            tu.append(pr.tri_uv)
            tm.append(pr.tri_mat)
        z3 = np.zeros((0, 3, 3), np.float32)
        return HostScene(
            tri_v=np.concatenate(tv) if tv else z3,
            tri_n=np.concatenate(tn) if tn else z3,
            tri_uv=(np.concatenate(tu) if tu
                    else np.zeros((0, 3, 2), np.float32)),
            tri_mat=(np.concatenate(tm) if tm
                     else np.zeros((0,), np.int32)),
            materials=self.materials, textures=self.textures,
            sky_color=self.sky_color,
            camera_position=self.camera_position,
            camera_direction=self.camera_direction,
            camera_focal_length=self.camera_focal_length)


def _parse_glb_container(data: bytes) -> Tuple[dict, bytes]:
    if len(data) < 12:
        raise ValueError("not a GLB file: too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError("not a GLB file: bad magic")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    off = 12
    gltf_json: Optional[dict] = None
    blob = b""
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == CHUNK_JSON and gltf_json is None:
            gltf_json = json.loads(chunk)
        elif ctype == CHUNK_BIN and not blob:
            blob = chunk
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, blob


def _read_accessor(gltf: dict, blob: bytes, accessor_index: int
                   ) -> np.ndarray:
    """Decode one accessor to [count, ncomp] (SCALAR -> [count, 1])."""
    acc = gltf["accessors"][accessor_index]
    ncomp = _TYPE_COMPONENTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:  # spec: zero-filled when absent
        return np.zeros((count, ncomp), dtype=dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    tight = ncomp * itemsize
    stride = view.get("byteStride", 0) or tight
    if stride == tight:
        out = np.frombuffer(blob, dtype=dtype, count=count * ncomp,
                            offset=base)
        return out.reshape(count, ncomp).copy()
    # Strided: slice per element via as_strided on a bytes view.
    raw = np.frombuffer(blob, dtype=np.uint8,
                        count=stride * (count - 1) + tight, offset=base)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(count, tight), strides=(stride, 1))
    return strided.copy().view(dtype).reshape(count, ncomp)


def _local_matrix(node: dict) -> np.ndarray:
    """TRS (or explicit matrix) -> 4x4, glTF column-major convention
    (ref: scene.cpp:18-21 local_matrix)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(np.asarray(node["scale"], np.float64))
    if "rotation" in node:
        x, y, z, w = [float(v) for v in node["rotation"]]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = np.asarray(node["translation"], np.float64)
    return m


def _invert3x3_transpose(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose normal matrix via the adjugate, op for op as
    native/srt_native.cpp invert3x3_transpose, so that bake() and the
    baked ingest agree bit for bit. Works on [..., 3, 3] stacks. A
    matrix with det == 0 (a zero-scale node) gives zeros, as in the
    native core."""
    a = np.asarray(m, np.float64)
    det = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                           - a[..., 1, 2] * a[..., 2, 1])
           - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                             - a[..., 1, 2] * a[..., 2, 0])
           + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                             - a[..., 1, 1] * a[..., 2, 0]))
    with np.errstate(divide="ignore"):
        inv_det = np.where(det != 0.0, 1.0 / det, 0.0)
    inv = np.stack([
        np.stack([a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                  -(a[..., 0, 1] * a[..., 2, 2]
                    - a[..., 0, 2] * a[..., 2, 1]),
                  a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]],
                 axis=-1),
        np.stack([-(a[..., 1, 0] * a[..., 2, 2]
                    - a[..., 1, 2] * a[..., 2, 0]),
                  a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                  -(a[..., 0, 0] * a[..., 1, 2]
                    - a[..., 0, 2] * a[..., 1, 0])], axis=-1),
        np.stack([a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                  -(a[..., 0, 0] * a[..., 2, 1]
                    - a[..., 0, 1] * a[..., 2, 0]),
                  a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]],
                 axis=-1),
    ], axis=-2) * inv_det[..., None, None]
    return np.swapaxes(inv, -1, -2)


def _node_world_matrices(gltf: dict, scene_nodes: List[int],
                         global_scale: np.ndarray) -> Dict[int, np.ndarray]:
    """World matrix per reachable node, composed as
    Scene::node_global_matrix (scene.cpp:137-146): every node's own
    chain ends with an innermost scale(global_scale)."""
    nodes = gltf.get("nodes", [])
    scale_m = np.diag(np.concatenate([global_scale, [1.0]]))
    world: Dict[int, np.ndarray] = {}

    def visit(idx: int, parent: np.ndarray):
        chain = parent @ _local_matrix(nodes[idx])
        world[idx] = chain @ scale_m
        for child in nodes[idx].get("children", []):
            visit(child, chain)

    for root in scene_nodes:
        visit(root, np.eye(4))
    return world


def _decode_image(gltf: dict, blob: bytes, image: dict, name: str
                  ) -> np.ndarray:
    """Extract an embedded image's bytes and decode them
    (utils/gltf.py decode_image_bytes)."""
    if "bufferView" in image:
        view = gltf["bufferViews"][image["bufferView"]]
        base = view.get("byteOffset", 0)
        raw = blob[base:base + view["byteLength"]]
    elif "uri" in image and image["uri"].startswith("data:"):
        import base64
        raw = base64.b64decode(image["uri"].split(",", 1)[1])
    else:
        raise ValueError(
            "external image URIs are not supported in .glb ingest")
    return decode_image_bytes(raw, name)


def _default_material() -> dict:
    # Deviation: reference asserts on missing material (scene.cpp:176).
    return {"pbrMetallicRoughness": {
        "baseColorFactor": [0.8, 0.8, 0.8, 1.0],
        "metallicFactor": 0.0,
        "roughnessFactor": 0.5,
    }}


def _classify_materials(gltf: dict) -> HostMaterialTable:
    """Reference classification rules, scene.cpp:188-254."""
    gltf_mats = list(gltf.get("materials", []))
    gltf_mats.append(_default_material())  # slot M-1 = default material
    m = len(gltf_mats)
    mtype = np.zeros(m, np.uint8)
    albedo = np.ones((m, 3), np.float32)
    tex_id = np.full(m, -1, np.int32)
    roughness = np.zeros(m, np.float32)
    ior = np.full(m, 1.5, np.float32)
    emissive = np.zeros((m, 3), np.float32)

    textures = gltf.get("textures", [])
    for i, mat in enumerate(gltf_mats):
        pbr = mat.get("pbrMetallicRoughness", {})
        base_color = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
        ext = mat.get("extensions", {})

        emissive_factor = np.asarray(
            mat.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float32)
        strength = 0.0
        if "KHR_materials_emissive_strength" in ext:
            strength = float(ext["KHR_materials_emissive_strength"].get(
                "emissiveStrength", 1.0))
        emissive[i] = emissive_factor * strength

        base_tex = -1
        bct = pbr.get("baseColorTexture")
        if bct is not None and bct.get("index", -1) > -1:
            base_tex = int(textures[bct["index"]].get("source", -1))

        if "KHR_materials_ior" in ext and "KHR_materials_transmission" in ext:
            mtype[i] = MAT_DIELECTRIC
            ior[i] = float(ext["KHR_materials_ior"].get("ior", 1.5))
            emissive[i] = 0.0  # dielectric never emits (material.hpp:158-160)
        elif float(pbr.get("metallicFactor", 1.0)) > 0.01:
            mtype[i] = MAT_METALLIC
            albedo[i] = base_color
            tex_id[i] = base_tex
            roughness[i] = float(pbr.get("roughnessFactor", 1.0))
        else:
            mtype[i] = MAT_DIFFUSE
            albedo[i] = base_color
            tex_id[i] = base_tex

    return HostMaterialTable(mtype=mtype, albedo=albedo, tex_id=tex_id,
                             roughness=roughness, ior=ior,
                             emissive=emissive)


def _geometric_normals(v: np.ndarray) -> np.ndarray:
    """Per-face normals [N,3] from positions [N,3,3] (fallback)."""
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-20)


def _extract_camera(gltf, world, camera_node, tri_v):
    """Camera pose per scene.cpp:109-128; deterministic bbox default
    when no camera node exists (deviation: the reference would index
    nodes[-1])."""
    if camera_node is not None and camera_node in world:
        m = world[camera_node]
        pos = m[:3, 3].copy()
        # rotation applied to glTF forward (0,0,-1); use the rotation
        # part of the world matrix with scale removed.
        r = m[:3, :3]
        r = r / np.maximum(np.linalg.norm(r, axis=0, keepdims=True), 1e-20)
        direction = r @ np.array([0.0, 0.0, -1.0])
        direction = direction / max(np.linalg.norm(direction), 1e-20)
        cam_ref = gltf["nodes"][camera_node]["camera"]
        persp = gltf.get("cameras", [{}])[cam_ref].get("perspective", {})
        yfov = float(persp.get("yfov", np.deg2rad(45.0)))
        focal = 1.0 / np.tan(yfov / 2.0)  # scene.cpp:127
        return pos, direction, focal

    # Default: frame the scene bbox from +Z.
    if tri_v.size:
        lo = tri_v.reshape(-1, 3).min(0)
        hi = tri_v.reshape(-1, 3).max(0)
        center = 0.5 * (lo + hi)
        extent = float(np.max(hi - lo))
    else:
        center = np.zeros(3)
        extent = 1.0
    pos = center + np.array([0.0, 0.0, 2.0 * max(extent, 1e-6)])
    direction = np.array([0.0, 0.0, -1.0])
    focal = 1.0 / np.tan(np.deg2rad(45.0) / 2.0)
    return pos, direction, focal


def load_glb_instanced(path_or_bytes, global_scale=(1.0, 1.0, 1.0)
                       ) -> InstancedHostScene:
    """Parse a .glb (path or bytes) into unique primitives + instance
    transforms. The global scale rides the world matrices (where
    _node_world_matrices applies it), so local geometry stays as
    authored."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    gltf, blob = _parse_glb_container(data)
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    scene = scenes[scene_idx if 0 <= scene_idx < len(scenes) else 0]
    scene_nodes = scene.get("nodes", [])

    extras = scene.get("extras", {})
    sky = np.asarray(extras.get("sky_color", DEFAULT_SKY),
                     np.float32).reshape(-1)[:3]
    if sky.shape[0] != 3:
        sky = np.asarray(DEFAULT_SKY, np.float32)
    if "sky_strength" in extras:
        sky = sky * np.float32(extras["sky_strength"])

    world = _node_world_matrices(
        gltf, scene_nodes, np.asarray(global_scale, np.float64))
    materials = _classify_materials(gltf)
    default_mat_index = len(materials.mtype) - 1

    images = gltf.get("images", [])[:MAX_IMAGES]
    if images:
        textures = np.stack([_decode_image(gltf, blob, im, f"image {i}")
                             for i, im in enumerate(images)])
    else:
        textures = np.zeros((1, TEX_RES, TEX_RES, 4), np.uint8)

    nodes = gltf.get("nodes", [])
    meshes = gltf.get("meshes", [])

    prims: List[UniquePrim] = []
    prim_key_to_id = {}
    inst_prim: List[int] = []
    inst_mat: List[np.ndarray] = []
    camera_node: Optional[int] = None

    for node_idx, mat4 in world.items():
        node = nodes[node_idx]
        if "camera" in node and camera_node is None:
            camera_node = node_idx
        if "mesh" not in node:
            continue
        mesh_idx = node["mesh"]
        mesh = meshes[mesh_idx]
        for prim_idx, prim in enumerate(mesh.get("primitives", [])):
            key = (mesh_idx, prim_idx)
            if key not in prim_key_to_id:
                attrs = prim.get("attributes", {})
                if "POSITION" not in attrs:
                    raise ValueError(
                        "primitive without POSITION attribute")
                pos = _read_accessor(
                    gltf, blob, attrs["POSITION"]).astype(np.float64)
                if "indices" in prim:
                    idx = _read_accessor(
                        gltf, blob, prim["indices"]).reshape(-1)
                    idx = idx.astype(np.int64)
                else:
                    idx = np.arange(pos.shape[0], dtype=np.int64)
                if idx.size % 3 != 0:
                    raise ValueError("index count not divisible by 3")
                v = pos[idx].reshape(-1, 3, 3).astype(np.float32)
                if "NORMAL" in attrs:
                    nrm = _read_accessor(
                        gltf, blob, attrs["NORMAL"]).astype(np.float64)
                    n = nrm[idx].reshape(-1, 3, 3).astype(np.float32)
                else:
                    gn = _geometric_normals(v)
                    n = np.repeat(gn[:, None, :], 3, axis=1)
                if "TEXCOORD_0" in attrs:
                    uv = _read_accessor(
                        gltf, blob,
                        attrs["TEXCOORD_0"]).astype(np.float32)
                    uv = uv[idx].reshape(-1, 3, 2)
                else:
                    uv = np.zeros((v.shape[0], 3, 2), np.float32)
                mat_index = prim.get("material", -1)
                if mat_index < 0:
                    mat_index = default_mat_index
                prim_key_to_id[key] = len(prims)
                prims.append(UniquePrim(
                    tri_v=v, tri_n=n, tri_uv=uv,
                    tri_mat=np.full(v.shape[0], mat_index, np.int32)))
            inst_prim.append(prim_key_to_id[key])
            inst_mat.append(mat4)

    inst_prim_a = np.asarray(inst_prim, np.int32)
    inst_mat_a = (np.stack(inst_mat) if inst_mat
                  else np.zeros((0, 4, 4), np.float64))

    # camera extraction needs world tris only for the no-camera
    # fallback framing; hand it the instance root boxes instead of a
    # full bake
    if camera_node is not None:
        ref_tris = np.zeros((0, 3, 3), np.float32)
    else:
        pts = []
        for p, m4 in zip(inst_prim_a, inst_mat_a):
            v = prims[p].tri_v.reshape(-1, 3).astype(np.float64)
            lo = v.min(0) if v.size else np.zeros(3)
            hi = v.max(0) if v.size else np.zeros(3)
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            w = corners @ m4[:3, :3].T + m4[:3, 3]
            pts.append(w.astype(np.float32))
        allp = (np.concatenate(pts) if pts
                else np.zeros((0, 3), np.float32))
        # 8 corner points per instance stand in for tri rows
        ref_tris = np.repeat(allp[:, None, :], 3, axis=1)
    cam_pos, cam_dir, focal = _extract_camera(
        gltf, world, camera_node, ref_tris)

    return InstancedHostScene(
        prims=prims, inst_prim=inst_prim_a, inst_mat=inst_mat_a,
        materials=materials, textures=textures,
        sky_color=sky.astype(np.float32),
        camera_position=cam_pos.astype(np.float32),
        camera_direction=cam_dir.astype(np.float32),
        camera_focal_length=float(focal))
