"""Canonical Morton triangle order (numpy).

The JAX package sorts triangles by the Morton code of their centroids
into an implicit 8-ary heap of K-triangle leaves, and every shading
table is stored in that order. The port keeps the order as the
canonical triangle identity (so hit ids mean the same thing in both
packages) but traverses the SAH tree instead; it needs only the order
part of the JAX build_np.
"""

from __future__ import annotations

import numpy as np


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


def build_np(tri_v: np.ndarray, leaf_size: int = 8) -> np.ndarray:
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
