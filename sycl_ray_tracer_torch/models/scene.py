"""Device scene: the tables the wavefront main path reads, on one device.

Built on the host from a HostScene (utils/gltf.py) by
build_device_scene, or from an InstancedHostScene
(utils/instanced.py) by models/instanced.py:build_instanced_device_scene,
and moved to `device` (the card unless the caller asks for the CPU)
once.

Baked scenes at leaf_size 8, intersected by ops/traverse8.py
(csrc/traverse8.cuh):
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
Baked scenes at any other leaf_size K (has_heap), intersected by
ops/traverse1.py (csrc/traverse1.cuh) on the implicit Morton heap of
ops/wbvh.py, whose hit ids are canonical Morton slots (no remap):
  bvh_children   [NI, 48] f32  the heap's child boxes (as bvh_nodes)
  bvh_leaves     [ceil(N/K), 9K] f32  the real leaves, component-major
                               (v0, e1, e2; component c of slot j at
                               c*K + j)
  bvh_ni = NI, bvh_depth, leaf_size = K
Baked scenes at any K built with intersector="lbvh", walked by
ops/traverse.py (plain torch) on the binary LBVH of ops/lbvh.py, whose
leaves are the K-slot leaves of the canonical Morton order (8^depth of
them, a power of two), so hit ids need no remap; no other tree is built:
  lbvh_lo, lbvh_hi [2L, 3] f32  the binary heap's boxes (row 0 unused)
  lbvh_v0, lbvh_e1, lbvh_e2 [L*K, 3] f32  per slot v0, v1 - v0 and
                               v2 - v0 (zero on padding slots)
Two-level instanced scenes (has_instances), intersected by
ops/traverse5.py in itf mode (csrc/traverse5.cuh); bvh_woop is None:
  bvh_nodes      [NI, 48] f32  one global tree: a TLAS over the
  bvh_child_ids  [NI, 8]  i32  instances' world boxes, then per instance
                               a copy of its primitive's local internal
                               nodes with conservatively transformed
                               boxes; leaf children are global leaves
  bvh_mt         [S8, 9]  f32  shared Moller-Trumbore rows (v0, e1, e2)
                               of every unique primitive's local SAH
                               leaves, in local space
  inst_leaf_slot [Lg]     i32  global leaf -> its shared leaf
  inst_xf        [Lg, 12] f32  global leaf -> its instance's world ->
                               local transform (M row-major, then t)
  bvh_remap      [Lg*8]   i64  global slot -> inst * S8 + shared row
  inst_nmat      [I, 9]   f32  per instance, the inverse transpose of
                               its 3x3 matrix (rotates local normals to
                               world); inst_s8 = S8
Shading (models/trace.py, models/materials.py), in Morton-slot order
(instanced: in shared-row order, normals in local space):
  shade_tbl      [LK, 16] f32  one row per slot of the 8^depth-leaf
                               Morton heap of leaf_size K (LK =
                               8^depth * K; the same row for a triangle
                               at every K): cols 0-8 unit vertex
                               normals, 9-14 uv,
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

from sycl_ray_tracer_torch.ops import kernels, lbvh, wbvh, woop
from sycl_ray_tracer_torch.ops import sah as _sah
from sycl_ray_tracer_torch.utils.gltf import HostScene, load_glb

LEAF_SIZE = 8
INTERSECTORS = ("auto", "lbvh")


@dataclasses.dataclass
class DeviceScene:
    bvh_nodes: torch.Tensor | None
    bvh_child_ids: torch.Tensor | None
    bvh_woop: torch.Tensor | None
    bvh_remap: torch.Tensor | None
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
    leaf_size: int = LEAF_SIZE
    # Morton-heap scenes only (leaf_size != 8)
    bvh_children: torch.Tensor | None = None
    bvh_leaves: torch.Tensor | None = None
    bvh_ni: int = 0
    # two-level instanced scenes only (models/instanced.py)
    bvh_mt: torch.Tensor | None = None
    inst_leaf_slot: torch.Tensor | None = None
    inst_xf: torch.Tensor | None = None
    inst_nmat: torch.Tensor | None = None
    inst_s8: int = 0
    # "lbvh": the binary-LBVH cross-check intersector (ops/traverse.py)
    intersector: str = "auto"
    lbvh_lo: torch.Tensor | None = None
    lbvh_hi: torch.Tensor | None = None
    lbvh_v0: torch.Tensor | None = None
    lbvh_e1: torch.Tensor | None = None
    lbvh_e2: torch.Tensor | None = None

    @property
    def has_instances(self) -> bool:
        return self.inst_xf is not None

    @property
    def has_heap(self) -> bool:
        return self.bvh_leaves is not None


def _inverse_order(order: np.ndarray, n: int) -> np.ndarray:
    """original tri id -> canonical Morton slot (inverse of `order`,
    skipping the -1 padding slots)."""
    inv = np.zeros((n,), np.int64)
    valid = order >= 0
    inv[order[valid]] = np.nonzero(valid)[0]
    return inv


def check_stack(depth: int) -> None:
    """Refuse a tree whose internal depth could overflow the kernels'
    per-ray stack (7*depth + 1 entries: depth 18 at most)."""
    if 7 * depth + 1 > kernels.STACK:
        raise ValueError(
            f"tree depth {depth} needs a traversal stack of "
            f"{7 * depth + 1} entries; the kernels have {kernels.STACK}")


def pack_texels(textures: np.ndarray) -> np.ndarray:
    """[T, res, res, 4] uint8 -> [T*res*res] int32, one RGBA8 texel per
    int32 (little-endian)."""
    tex = textures.astype(np.uint32)
    return (tex[..., 0] | (tex[..., 1] << 8) | (tex[..., 2] << 16)
            | (tex[..., 3] << 24)).reshape(-1).view(np.int32)


def build_device_scene(host: HostScene, leaf_size: int = LEAF_SIZE,
                       device="cuda", intersector: str = "auto"
                       ) -> DeviceScene:
    """The traversal tables of `leaf_size` (8: SAH BVH8 built natively on
    the host, with Woop leaves; any other K >= 1: the Morton heap of
    K-slot leaves; with intersector="lbvh", at any K: the binary LBVH
    over the leaves of the Morton order), and the shading tables in the
    canonical Morton order, all moved to `device` once. Raises on a
    machine without CUDA unless given device="cpu"."""
    device = kernels.resolve_device(device)
    if intersector not in INTERSECTORS:
        raise ValueError(f"intersector must be one of {INTERSECTORS}, not "
                         f"{intersector!r}")
    n = host.num_triangles
    if n == 0:
        raise ValueError("scene has no triangles")
    k = int(leaf_size)
    if k < 1:
        raise ValueError(f"leaf_size must be at least 1, not {k}")

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    if intersector == "lbvh":
        order = wbvh.morton_order(host.tri_v, k)
        valid = order >= 0
        sv = host.tri_v[np.maximum(order, 0)].astype(np.float32)
        sv[~valid] = 0.0
        lo, hi = lbvh.fit_nodes(dev(sv), dev(valid), sv.shape[0] // k, k)
        tree = dict(
            bvh_nodes=None, bvh_child_ids=None, bvh_woop=None,
            bvh_remap=None, sah_ni=0, bvh_depth=wbvh.plan(n, k)[0],
            intersector=intersector, lbvh_lo=lo, lbvh_hi=hi,
            lbvh_v0=dev(sv[:, 0]), lbvh_e1=dev(sv[:, 1] - sv[:, 0]),
            lbvh_e2=dev(sv[:, 2] - sv[:, 0]))
    elif k == LEAF_SIZE:
        sahb = _sah.build_sah(host.tri_v, k)
        check_stack(sahb.depth)
        rows = _sah.leaf_rows(host.tri_v, sahb.order, k)
        M, tr, _ = woop.woop_from_leaf_rows(rows, k)
        order = wbvh.morton_order(host.tri_v, k)
        remap = np.where(sahb.order >= 0,
                         _inverse_order(order, n)[np.maximum(sahb.order, 0)],
                         -1)
        tree = dict(
            bvh_nodes=dev(sahb.children),
            bvh_child_ids=dev(sahb.child_ids),
            bvh_woop=dev(np.concatenate([M.reshape(-1, 9),
                                         tr.reshape(-1, 3)], axis=1)),
            bvh_remap=dev(remap, torch.int64),
            sah_ni=sahb.num_internal, bvh_depth=sahb.depth)
    else:
        heap = wbvh.build_np(host.tri_v, k)
        check_stack(heap.depth)
        order = heap.order
        tree = dict(
            bvh_nodes=None, bvh_child_ids=None, bvh_woop=None,
            bvh_remap=None, sah_ni=0, bvh_depth=heap.depth,
            bvh_children=dev(heap.children), bvh_leaves=dev(heap.leaves),
            bvh_ni=heap.num_internal)

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

    m = host.materials
    verts = host.tri_v.reshape(-1, 3)
    return DeviceScene(
        **tree,
        shade_tbl=dev(shade),
        mat_type=dev(m.mtype, torch.int64),
        mat_albedo=dev(m.albedo, torch.float32),
        mat_tex=dev(m.tex_id, torch.int64),
        mat_rough=dev(m.roughness, torch.float32),
        mat_ior=dev(m.ior, torch.float32),
        mat_emissive=dev(m.emissive, torch.float32),
        tex_packed=dev(pack_texels(host.textures)),
        sky_color=dev(host.sky_color, torch.float32),
        scene_lo=dev(verts.min(0), torch.float32),
        scene_hi=dev(verts.max(0), torch.float32),
        tex_res=int(host.textures.shape[1]),
        has_textures=bool((np.asarray(m.tex_id) >= 0).any()),
        num_triangles=n,
        leaf_size=k,
    )


def load_scene(path: str, leaf_size: int = LEAF_SIZE,
               device="cuda", intersector: str = "auto",
               global_scale=(1.0, 1.0, 1.0)) -> tuple:
    """.glb path -> (DeviceScene, HostScene), at global_scale."""
    host = load_glb(path, global_scale)
    return build_device_scene(host, leaf_size, device=device,
                              intersector=intersector), host
