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
parses the file with the glTF helpers of the Python ingest
(utils/gltf.py); the parsing contract and its documented deviations
are those of the baked ingest, and bake() reproduces the baked ingest
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from sycl_ray_tracer_torch.utils.gltf import (HostMaterialTable, HostScene,
                                              _extract_camera,
                                              _geometric_normals,
                                              _invert3x3_transpose,
                                              _parse_glb_container,
                                              _read_bytes, _read_primitive,
                                              _read_scene)


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


def load_glb_instanced(path_or_bytes, global_scale=(1.0, 1.0, 1.0)
                       ) -> InstancedHostScene:
    """Parse a .glb (path or bytes) into unique primitives + instance
    transforms. The global scale rides the world matrices (where
    _node_world_matrices applies it), so local geometry stays as
    authored."""
    gltf, blob = _parse_glb_container(_read_bytes(path_or_bytes))
    world, sky, materials, textures = _read_scene(gltf, blob, global_scale)
    default_mat_index = len(materials.mtype) - 1
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
                pos, idx, nrm, uv, mat_index = _read_primitive(gltf, blob,
                                                               prim)
                v = pos[idx].reshape(-1, 3, 3).astype(np.float32)
                if nrm is not None:
                    n = nrm[idx].reshape(-1, 3, 3).astype(np.float32)
                else:
                    n = np.repeat(_geometric_normals(v)[:, None, :], 3,
                                  axis=1)
                uv = (uv[idx].reshape(-1, 3, 2) if uv is not None
                      else np.zeros((v.shape[0], 3, 2), np.float32))
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
        materials=materials, textures=textures, sky_color=sky,
        camera_position=cam_pos.astype(np.float32),
        camera_direction=cam_dir.astype(np.float32),
        camera_focal_length=float(focal))
