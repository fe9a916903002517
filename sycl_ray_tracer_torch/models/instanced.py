"""Two-level (shared-BLAS) instanced scene build.

The counterpart of the reference's Embree BLAS per primitive + TLAS of
instances (scene.cpp:404-439, 487-507), laid out for the traverse5
kernel (ops/traverse5.py, itf mode):

- ONE local-space SAH BVH8 per unique primitive (built once), whose
  leaves' Moller-Trumbore rows are shared by every instance (bvh_mt);
- ONE global BVH8: a TLAS over the instances' world boxes, then per
  instance a copy of its primitive's local INTERNAL nodes with
  conservatively transformed boxes (center/half-extent |M| form). Only
  node boxes are per instance; leaf rows, shading rows and materials
  are per unique triangle;
- per global leaf, its shared leaf (inst_leaf_slot) and the world ->
  local transform of its instance (inst_xf): the kernel maps the ray
  into instance space for that leaf, leaving d unnormalized so that t
  stays world-valid;
- hit ids composed as inst * S8 + shared row (S8 = shared slots)
  through bvh_remap; shade_lanes decomposes them and rotates the
  interpolated LOCAL normal by the instance's inverse transpose
  (inst_nmat, models/trace.py).

The tables are those of the JAX package's
models/instanced.py:build_instanced_device_scene (the tests unpack its
TPU tiles and compare), built per unique primitive with numpy instead
of per instance in Python.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sycl_ray_tracer_torch.models.scene import (LEAF_SIZE, DeviceScene,
                                                check_stack, pack_texels)
from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops import sah as _sah
from sycl_ray_tracer_torch.utils.gltf import _invert3x3_transpose
from sycl_ray_tracer_torch.utils.instanced import InstancedHostScene

_INF = np.float32(3.0e38)


def _transform_children(children: np.ndarray, m3: np.ndarray,
                        tr: np.ndarray) -> np.ndarray:
    """Conservative world boxes of local child AABBs [NI, 48] (6 comps
    x 8 children) under I transforms m3 [I, 3, 3], tr [I, 3]:
    c' = M c + t, h' = |M| h, as [I, NI, 48]. Empty slots (lo >= _INF,
    the SAH build's point-at-infinity form) stay empty."""
    ni = children.shape[0]
    b = children.reshape(ni, 6, 8)
    lo = b[:, 0:3].transpose(0, 2, 1)      # [NI, 8, 3]
    hi = b[:, 3:6].transpose(0, 2, 1)
    empty = lo[:, :, 0] >= _INF
    lo = np.where(empty[:, :, None], 0.0, lo)
    hi = np.where(empty[:, :, None], 0.0, hi)
    c = (lo + hi) * 0.5
    h = (hi - lo) * 0.5
    m3t = m3.transpose(0, 2, 1)[:, None]   # [I, 1, 3, 3]
    c2 = c[None] @ m3t + tr[:, None, None, :]
    h2 = h[None] @ np.abs(m3t)
    lo2 = (c2 - h2).astype(np.float32)     # [I, NI, 8, 3]
    hi2 = (c2 + h2).astype(np.float32)
    lo2[:, empty] = _INF
    hi2[:, empty] = _INF
    out = np.empty((m3.shape[0], ni, 6, 8), np.float32)
    out[:, :, 0:3] = lo2.transpose(0, 1, 3, 2)
    out[:, :, 3:6] = hi2.transpose(0, 1, 3, 2)
    return out.reshape(-1, ni, 48)


def _build_tlas(boxes: np.ndarray) -> Tuple[list, int]:
    """8-ary TLAS over instance world boxes [R, 6] (lo3, hi3), split in
    Morton order of the box centers.

    Returns (nodes, depth): nodes is a list of (child_boxes [8, 6],
    child_refs [8]) where a ref >= 0 is another TLAS node index and
    ref < 0 encodes ~instance_index; depth counts the TLAS levels. The
    root is node 0; a root exists even for R == 1."""
    r = boxes.shape[0]
    cent = (boxes[:, 0:3] + boxes[:, 3:6]) * 0.5
    lo = cent.min(0)
    span = np.maximum(cent.max(0) - lo, 1e-12)
    q = np.clip(((cent - lo) / span * 1023), 0, 1023).astype(np.uint64)
    morton = np.zeros(r, np.uint64)
    for i in range(10):
        for a in range(3):
            morton |= ((q[:, a] >> np.uint64(i)) & np.uint64(1)) << \
                np.uint64(3 * i + (2 - a))
    order = np.argsort(morton, kind="stable")

    nodes: list = []
    depth = 0

    def rec(idx: np.ndarray, force_node: bool, level: int):
        nonlocal depth
        n = idx.shape[0]
        if n == 1 and not force_node:
            b = boxes[idx[0]]
            return ~int(idx[0]), b
        depth = max(depth, level)
        my = len(nodes)
        nodes.append(None)
        cb = np.full((8, 6), _INF, np.float32)
        cr = np.zeros((8,), np.int64)
        step = -(-n // 8)
        j = 0
        lo_u = np.full(3, _INF, np.float32)
        hi_u = np.full(3, -_INF, np.float32)
        for s in range(0, n, step):
            ref, bx = rec(idx[s: s + step], False, level + 1)
            cb[j] = bx
            cr[j] = ref
            lo_u = np.minimum(lo_u, bx[0:3])
            hi_u = np.maximum(hi_u, bx[3:6])
            j += 1
        nodes[my] = (cb, cr)
        return my, np.concatenate([lo_u, hi_u])

    rec(order, True, 1)
    return nodes, depth


def build_instanced_device_scene(ih: InstancedHostScene, device="cuda",
                                 intersector: str = "auto") -> DeviceScene:
    """Local SAH BVH8s (native, host), the global tree, the shared MT
    and shading tables and the per-leaf instance tables, all moved to
    `device` once (see the module docstring and models/scene.py).
    Raises on a machine without CUDA unless given device="cpu". There
    is no binary-LBVH path for two-level scenes (nor in the JAX
    package): intersector="lbvh" raises; bake the scene instead."""
    if intersector != "auto":
        raise ValueError("two-level instanced scenes have only the "
                         "intersector 'auto'; bake the scene "
                         "(InstancedHostScene.bake) for 'lbvh'")
    device = kernels.resolve_device(device)
    k = LEAF_SIZE
    n_prims = len(ih.prims)
    r = ih.num_instances
    if r == 0 or n_prims == 0:
        raise ValueError("instanced scene has no instances")

    # --- per-unique-primitive local BVH8 + shared leaf rows ---
    built = [_sah.build_sah(p.tri_v, k) for p in ih.prims]
    rows = [_sah.leaf_rows(p.tri_v, b.order, k)
            for p, b in zip(ih.prims, built)]
    nl_prim = np.array([b.num_leaves for b in built], np.int64)
    ni_prim = np.array([b.num_internal for b in built], np.int64)
    sbase = np.concatenate([[0], np.cumsum(nl_prim)[:-1]])
    s8 = int(nl_prim.sum()) * k
    # composed hit ids (inst * S8 + shared row) are int64 from bvh_remap
    # on, so a large unique primitive (a world's water mesh) instanced
    # among many small ones fits; the walk's own ids, the global slots,
    # are int32 and checked below
    if r * s8 >= (1 << 63):
        raise ValueError(
            f"instances({r}) x shared rows({s8}) overflow int64 "
            "composed hit ids")
    mt = _sah.slot_rows(np.concatenate(rows), k)

    # --- per-instance transforms ---
    m4 = np.asarray(ih.inst_mat, np.float64)
    m3 = m4[:, :3, :3]
    m4i = np.linalg.inv(m4)
    inv_m = np.concatenate([m4i[:, :3, :3].reshape(r, 9), m4i[:, :3, 3]],
                           axis=1).astype(np.float32)
    nmat = _invert3x3_transpose(m3).reshape(r, 9).astype(np.float32)

    # transformed local internal nodes and instance world root boxes
    groups = [np.nonzero(ih.inst_prim == p)[0] for p in range(n_prims)]
    tchildren = [None] * n_prims
    root_boxes = np.empty((r, 6), np.float32)
    for p, idx in enumerate(groups):
        tc = _transform_children(built[p].children, m3[idx], m4[idx, :3, 3])
        bb = tc.reshape(idx.size, -1, 6, 8)
        real = bb[:, :, 0, :] < _INF                # [Ig, NI, 8]
        root_boxes[idx, 0:3] = np.where(real[:, :, None, :], bb[:, :, 0:3],
                                        _INF).min((1, 3))
        root_boxes[idx, 3:6] = np.where(real[:, :, None, :], bb[:, :, 3:6],
                                        -_INF).max((1, 3))
        tchildren[p] = tc

    tlas_nodes, tlas_depth = _build_tlas(root_boxes)
    ni_tlas = len(tlas_nodes)
    inst_ni = ni_prim[ih.inst_prim]
    inst_nl = nl_prim[ih.inst_prim]
    ibase = ni_tlas + np.concatenate([[0], np.cumsum(inst_ni)[:-1]])
    lbase = np.concatenate([[0], np.cumsum(inst_nl)[:-1]])
    ni_global = int(ni_tlas + inst_ni.sum())
    l_global = int(inst_nl.sum())
    if ni_global + l_global >= (1 << 31) or l_global * k >= (1 << 31):
        raise ValueError("instanced tree exceeds int32 node or slot ids")
    depth = tlas_depth + max(b.depth for b in built)
    check_stack(depth)

    # --- global children/ids arrays ---
    children_g = np.zeros((ni_global, 48), np.float32)
    ids_g = np.zeros((ni_global, 8), np.int32)
    cb = np.stack([n[0] for n in tlas_nodes])       # [T, 8, 6]
    cr = np.stack([n[1] for n in tlas_nodes])       # [T, 8]
    children_g[:ni_tlas] = cb.transpose(0, 2, 1).reshape(ni_tlas, 48)
    gid = np.where(cr >= 0, cr, ibase[np.clip(~cr, 0, r - 1)])
    gid[cb[:, :, 0] >= _INF] = 0
    ids_g[:ni_tlas] = gid.astype(np.int32)
    for p, idx in enumerate(groups):
        b = built[p]
        ni_l = b.num_internal
        lids = b.child_ids.astype(np.int64)[None]   # [1, NI, 8]
        gids = np.where(lids >= ni_l,
                        ni_global + lbase[idx, None, None] + (lids - ni_l),
                        ibase[idx, None, None] + lids)
        tc = tchildren[p]
        gids[tc.reshape(idx.size, ni_l, 6, 8)[:, :, 0, :] >= _INF] = 0
        rows_g = (ibase[idx, None] + np.arange(ni_l)).reshape(-1)
        children_g[rows_g] = tc.reshape(-1, 48)
        ids_g[rows_g] = gids.reshape(-1, 8).astype(np.int32)

    # --- per global leaf: shared leaf and instance transform ---
    leaf_inst = np.repeat(np.arange(r), inst_nl)
    leaf_shared = (sbase[ih.inst_prim][leaf_inst]
                   + np.arange(l_global) - lbase[leaf_inst])

    # --- composed hit remap: global slot -> inst * S8 + shared row ---
    remap = (leaf_inst[:, None] * s8 + leaf_shared[:, None] * k
             + np.arange(k)[None, :]).reshape(-1)

    # --- shared shading tables (LOCAL-space normals) ---
    tri_n_parts, tri_uv_parts, tri_mat_parts = [], [], []
    for b, p in zip(built, ih.prims):
        order = np.asarray(b.order)
        safe = np.maximum(order, 0)
        valid = order >= 0
        tn = p.tri_n[safe]
        ln = np.linalg.norm(tn, axis=-1, keepdims=True)
        tn = (tn / np.maximum(ln, 1e-20)).astype(np.float32)
        tn[~valid] = 0.0
        tu = p.tri_uv[safe].astype(np.float32)
        tu[~valid] = 0.0
        tm = p.tri_mat[safe].astype(np.int32)
        tm[~valid] = 0
        tri_n_parts.append(tn)
        tri_uv_parts.append(tu)
        tri_mat_parts.append(tm)
    tri_n = np.concatenate(tri_n_parts)
    tri_uv = np.concatenate(tri_uv_parts)
    tri_mat = np.concatenate(tri_mat_parts)
    shade = np.concatenate([tri_n.reshape(s8, 9), tri_uv.reshape(s8, 6),
                            tri_mat[:, None].astype(np.float32)], axis=1)

    m = ih.materials

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return DeviceScene(
        bvh_nodes=dev(children_g),
        bvh_child_ids=dev(ids_g),
        bvh_woop=None,
        bvh_remap=dev(remap, torch.int64),
        shade_tbl=dev(shade),
        mat_type=dev(m.mtype, torch.int64),
        mat_albedo=dev(m.albedo, torch.float32),
        mat_tex=dev(m.tex_id, torch.int64),
        mat_rough=dev(m.roughness, torch.float32),
        mat_ior=dev(m.ior, torch.float32),
        mat_emissive=dev(m.emissive, torch.float32),
        tex_packed=dev(pack_texels(ih.textures)),
        sky_color=dev(ih.sky_color, torch.float32),
        scene_lo=dev(root_boxes[:, 0:3].min(0), torch.float32),
        scene_hi=dev(root_boxes[:, 3:6].max(0), torch.float32),
        sah_ni=ni_global,
        bvh_depth=depth,
        tex_res=int(ih.textures.shape[1]),
        has_textures=bool((np.asarray(m.tex_id) >= 0).any()),
        num_triangles=ih.num_world_triangles,
        bvh_mt=dev(mt, torch.float32),
        inst_leaf_slot=dev(leaf_shared, torch.int32),
        inst_xf=dev(inv_m[leaf_inst]),
        inst_nmat=dev(nmat),
        inst_s8=s8,
    )
