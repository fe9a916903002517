"""Device scene: the tables the wavefront main path reads, on one device.

Built on the host from a HostScene (utils/gltf.py) and moved to
`device` once:

Intersection (ops/traverse8.py, csrc/traverse8.cuh):
  bvh_nodes      [NI, 48] f32  SAH BVH8 child boxes, component-major
                               (8 lanes each of lo.x lo.y lo.z hi.x
                               hi.y hi.z)
  bvh_child_ids  [NI, 8]  i32  internal child = row, leaf child =
                               NI + leaf_row, empty slot = 0 with a
                               point-at-infinity box
  bvh_woop       [L*8, 12] f32 one 48-byte record per SAH triangle
                               slot: Woop M row-major (9), then tr (3);
                               dead and padding slots can never hit
  bvh_remap      [L*8]    i64  SAH slot -> canonical Morton slot
Shading (models/trace.py, models/materials.py), in Morton-slot order:
  shade_tbl      [LK, 16] f32  cols 0-8 unit vertex normals, 9-14 uv,
                               15 material id
  mat_*          [M] / [M, 3]  material tables (type, albedo, texture
                               id, roughness, ior, emissive)
  tex_packed     [T*res*res] i32  RGBA8 texels packed little-endian
                               into one int32 each (read with masks)
  sky_color [3], scene_lo [3], scene_hi [3] (bounds for the sort key)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sycl_ray_tracer_torch.ops import sah as _sah
from sycl_ray_tracer_torch.ops import wbvh, woop
from sycl_ray_tracer_torch.ops.traverse8 import STACK
from sycl_ray_tracer_torch.utils.gltf import HostScene

LEAF_SIZE = 8


@dataclasses.dataclass
class DeviceScene:
    bvh_nodes: torch.Tensor
    bvh_child_ids: torch.Tensor
    bvh_woop: torch.Tensor
    bvh_remap: torch.Tensor
    shade_tbl: torch.Tensor
    mat_type: torch.Tensor
    mat_albedo: torch.Tensor
    mat_tex: torch.Tensor
    mat_rough: torch.Tensor
    mat_ior: torch.Tensor
    mat_emissive: torch.Tensor
    tex_packed: torch.Tensor
    sky_color: torch.Tensor
    scene_lo: torch.Tensor
    scene_hi: torch.Tensor
    sah_ni: int
    bvh_depth: int
    tex_res: int
    has_textures: bool
    num_triangles: int


def _inverse_order(order: np.ndarray, n: int) -> np.ndarray:
    """original tri id -> canonical Morton slot (inverse of `order`,
    skipping the -1 padding slots)."""
    inv = np.zeros((n,), np.int64)
    valid = order >= 0
    inv[order[valid]] = np.nonzero(valid)[0]
    return inv


def build_device_scene(host: HostScene, device="cpu") -> DeviceScene:
    """SAH BVH8 build (native, host), Woop tables, shading tables in the
    canonical Morton order, all moved to `device` once."""
    n = host.num_triangles
    if n == 0:
        raise ValueError("scene has no triangles")
    k = LEAF_SIZE
    sahb = _sah.build_sah(host.tri_v, k)
    if 7 * sahb.depth + 1 > STACK:
        raise ValueError(
            f"SAH tree depth {sahb.depth} needs a traversal stack of "
            f"{7 * sahb.depth + 1} entries; the kernel has {STACK}")
    rows = _sah.leaf_rows(host.tri_v, sahb.order, k)
    M, tr, _ = woop.woop_from_leaf_rows(rows, k)
    woop_tbl = np.concatenate([M.reshape(-1, 9), tr.reshape(-1, 3)], axis=1)

    order = wbvh.build_np(host.tri_v, k)
    remap = np.where(sahb.order >= 0,
                     _inverse_order(order, n)[np.maximum(sahb.order, 0)], -1)

    safe = np.maximum(order, 0)
    validm = order >= 0
    tri_n = host.tri_n[safe]
    # unit vertex normals (the reference normalizes the interpolated
    # normal, trace_ray.hpp:52-55)
    ln = np.linalg.norm(tri_n, axis=-1, keepdims=True)
    tri_n = (tri_n / np.maximum(ln, 1e-20)).astype(np.float32)
    tri_n[~validm] = 0.0
    tri_uv = host.tri_uv[safe].astype(np.float32)
    tri_uv[~validm] = 0.0
    tri_mat = host.tri_mat[safe].astype(np.float32)
    tri_mat[~validm] = 0.0
    lk = order.shape[0]
    shade = np.concatenate([tri_n.reshape(lk, 9), tri_uv.reshape(lk, 6),
                            tri_mat[:, None]], axis=1)

    tex = host.textures.astype(np.uint32)
    packed = (tex[..., 0] | (tex[..., 1] << 8) | (tex[..., 2] << 16)
              | (tex[..., 3] << 24)).reshape(-1).view(np.int32)
    m = host.materials
    verts = host.tri_v.reshape(-1, 3)

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return DeviceScene(
        bvh_nodes=dev(sahb.children),
        bvh_child_ids=dev(sahb.child_ids),
        bvh_woop=dev(woop_tbl),
        bvh_remap=dev(remap, torch.int64),
        shade_tbl=dev(shade),
        mat_type=dev(m.mtype, torch.int64),
        mat_albedo=dev(m.albedo, torch.float32),
        mat_tex=dev(m.tex_id, torch.int64),
        mat_rough=dev(m.roughness, torch.float32),
        mat_ior=dev(m.ior, torch.float32),
        mat_emissive=dev(m.emissive, torch.float32),
        tex_packed=dev(packed),
        sky_color=dev(host.sky_color, torch.float32),
        scene_lo=dev(verts.min(0), torch.float32),
        scene_hi=dev(verts.max(0), torch.float32),
        sah_ni=sahb.num_internal,
        bvh_depth=sahb.depth,
        tex_res=int(host.textures.shape[1]),
        has_textures=bool((np.asarray(m.tex_id) >= 0).any()),
        num_triangles=n,
    )
