"""The Morton-heap BVH8 (numpy): canonical triangle order and the split
tables of the heap intersector.

The JAX package sorts triangles by the Morton code of their centroids
into an implicit complete 8-ary heap of K-triangle leaves, and every
shading table is stored in that order. The port keeps the order as the
canonical triangle identity, so hit ids mean the same thing in both
packages and at every K: slot s of the order is the s-th triangle of
one stable sort, followed by padding.

Scenes built with leaf_size != 8 also traverse the heap
(ops/traverse1.py): the children of internal node i are 8i+1..8i+8,
computed and never stored, and node NI + l is leaf l. Its tables are
those of the JAX package's wbvh.build_np without the unified `nodes`
table, which only its XLA traversal reads:

  children [NI, 48] f32  child boxes component-major (8 lanes each of
                         lo.x lo.y lo.z hi.x hi.y hi.z); a child whose
                         subtree holds no triangle has the point box at
                         (3e38, 3e38, 3e38)
  leaves   [ceil(N/K), 9K] f32  the real (non-padding) leaves only,
                         component-major: component c (v0.xyz, e1.xyz,
                         e2.xyz) of slot j at c*K + j; padding slots of
                         the last leaf are zero (det = 0, never hit)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_INF = np.float32(3.0e38)


class HeapBvh(NamedTuple):
    children: np.ndarray   # [NI, 48] f32
    leaves: np.ndarray     # [ceil(N/K), 9K] f32
    order: np.ndarray      # [8^depth * K] i32: slot -> triangle, -1 pad
    num_internal: int
    depth: int
    leaf_size: int


def _ceil_log8(n: int) -> int:
    d = 0
    c = 1
    while c < n:
        c *= 8
        d += 1
    return d


def plan(num_tris: int, leaf_size: int):
    """Static heap dimensions for `num_tris` triangles:
    (depth, num_internal, num_leaves, row_width)."""
    depth = max(_ceil_log8(max(-(-num_tris // leaf_size), 1)), 1)
    l_leaves = 8 ** depth
    ni = (8 ** depth - 1) // 7
    width = max(48, 9 * leaf_size)
    return depth, ni, l_leaves, width


def morton30_np(p: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points p [N, 3] inside the box (lo, hi)."""
    def expand(x):
        x = x.astype(np.uint32) & np.uint32(0x3FF)
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x
    extent = np.maximum((hi - lo).astype(np.float32), np.float32(1e-20))
    q = np.clip((p - lo).astype(np.float32) / extent,
                np.float32(0.0), np.float32(1.0 - 1e-7))
    cell = (q * np.float32(1024.0)).astype(np.uint32)
    return ((expand(cell[:, 0]) << 2) | (expand(cell[:, 1]) << 1)
            | expand(cell[:, 2]))


def morton_order(tri_v: np.ndarray, leaf_size: int = 8) -> np.ndarray:
    """Morton slot -> original triangle id, [L*K] int32 with -1 for the
    padding slots of the 8^depth-leaf heap. Equal to the `order` field
    of the JAX package's wbvh.build_np (stable sort on tied codes)."""
    tri_v = np.asarray(tri_v, np.float32)
    n = tri_v.shape[0]
    _, _, l_leaves, _ = plan(n, leaf_size)
    if n:
        centroids = tri_v.mean(axis=1, dtype=np.float32)
        codes = morton30_np(centroids, centroids.min(axis=0),
                            centroids.max(axis=0))
        perm = np.argsort(codes, kind="stable").astype(np.int32)
    else:
        perm = np.zeros((0,), np.int32)
    pad = l_leaves * leaf_size - n
    return np.concatenate([perm, np.full((pad,), -1, np.int32)])


def build_np(tri_v: np.ndarray, leaf_size: int) -> HeapBvh:
    """The heap's split tables, equal to those of the JAX package's
    wbvh.build_np (children, leaves, order, num_internal, depth)."""
    tri_v = np.asarray(tri_v, np.float32)
    n = tri_v.shape[0]
    k = leaf_size
    depth, ni, l_leaves, _ = plan(n, k)
    order = morton_order(tri_v, k)
    valid = order >= 0
    sorted_v = tri_v[np.maximum(order, 0)] if n else np.zeros(
        (l_leaves * k, 3, 3), np.float32)
    sorted_v[~valid] = 0.0

    # leaf boxes (inverted while fitting), then binary levels bottom-up
    lo_tri = np.where(valid[:, None], sorted_v.min(axis=1), _INF)
    hi_tri = np.where(valid[:, None], sorted_v.max(axis=1), -_INF)
    lvl_lo = [lo_tri.reshape(l_leaves, k, 3).min(axis=1)]
    lvl_hi = [hi_tri.reshape(l_leaves, k, 3).max(axis=1)]
    while lvl_lo[0].shape[0] > 1:
        lvl_lo.insert(0, np.minimum(lvl_lo[0][0::2], lvl_lo[0][1::2]))
        lvl_hi.insert(0, np.maximum(lvl_hi[0][0::2], lvl_hi[0][1::2]))

    # every third binary level is one heap level: its 8^(d+1) boxes are
    # the children of the 8^d internal nodes of depth d
    blocks = []
    for d in range(depth):
        bl = lvl_lo[3 * (d + 1)].copy()
        bh = lvl_hi[3 * (d + 1)].copy()
        empty = bh[:, 0] < bl[:, 0]
        bl[empty] = _INF
        bh[empty] = _INF
        bl8 = bl.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        bh8 = bh.reshape(8 ** d, 8, 3).transpose(0, 2, 1).reshape(-1, 24)
        blocks.append(np.concatenate([bl8, bh8], axis=1))
    children = np.concatenate(blocks, axis=0)

    v0 = sorted_v[:, 0, :]
    comps = np.concatenate([v0, sorted_v[:, 1, :] - v0,
                            sorted_v[:, 2, :] - v0], axis=1)   # [L*K, 9]
    l_real = max(-(-n // k), 1)
    leaves = np.ascontiguousarray(
        comps.reshape(l_leaves, k, 9)[:l_real].transpose(0, 2, 1).reshape(
            l_real, 9 * k))
    return HeapBvh(children=children, leaves=leaves, order=order,
                   num_internal=ni, depth=depth, leaf_size=k)


def heap_child_ids_np(ni: int) -> np.ndarray:
    """[NI, 8] int32 child ids of the implicit heap (8i+1..8i+8)."""
    i = np.arange(ni, dtype=np.int64)[:, None]
    return (8 * i + 1 + np.arange(8, dtype=np.int64)[None, :]).astype(
        np.int32)
