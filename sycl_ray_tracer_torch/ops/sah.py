"""Binned-SAH BVH8: binding to the native build (native/srt_bvh.cpp).

The native code does a top-down binary binned-SAH split, collapses the
binary tree to 8-wide nodes and emits component-major child boxes
[NI, 48], child ids [NI, 8] (internal child = its row; leaf child =
NI + leaf_row; empty slot = id 0 with a point-at-infinity box) and the
leaf order [L*K] of original triangle ids (-1 padding).

Spatial splits (SBVH, Stich et al. 2009; the analog of Embree's
RTC_BUILD_QUALITY_HIGH) are opt-in, with SRT_SBVH=1 as in the JAX
package: a triangle that straddles an overlap-heavy split plane is
clipped to each side and referenced from both, so `order` may repeat a
triangle id, and a leaf box may bound only a fragment of a triangle it
holds. Every slot of a duplicated triangle gets the same leaf rows, so
its copies hit at a bit-equal t and remap to one Morton slot.

Triangle identity: the intersector reports hits in SAH-slot space
(leaf_row * K + j); models/scene.py builds the remap to the canonical
Morton slots that every shading table uses.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np

from sycl_ray_tracer_torch.utils import native_loader

_INF = np.float32(3.0e38)

# The JAX package's SBVH settings (its SRT_SBVH_ALPHA / SRT_SBVH_FACTOR
# defaults): the overlap threshold as a fraction of the root's surface
# area, and the reference budget as a multiple of the triangle count.
SBVH_ALPHA = 1e-5
SBVH_FACTOR = 1.4


class SahBvh(NamedTuple):
    children: np.ndarray   # [NI, 48] component-major child boxes
    child_ids: np.ndarray  # [NI, 8] int32 (leaf child = NI + leaf_row)
    order: np.ndarray      # [L*K] int32 original tri ids (-1 pad);
                           # ids repeat where spatial splits fired
    num_internal: int
    num_leaves: int
    depth: int
    leaf_size: int
    num_refs: int          # leaf references (> tri count after splits)


def _bind(lib) -> None:
    lib.srt_bvh_build.restype = ctypes.c_void_p
    lib.srt_bvh_build.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int32]
    for name in ("srt_bvh_ni", "srt_bvh_nleaves"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.srt_bvh_depth.restype = ctypes.c_int32
    lib.srt_bvh_depth.argtypes = [ctypes.c_void_p]
    lib.srt_bvh_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.srt_bvh_free.argtypes = [ctypes.c_void_p]
    lib.srt_bvh_build2.restype = ctypes.c_void_p
    lib.srt_bvh_build2.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_float, ctypes.c_float]
    lib.srt_bvh_nrefs.restype = ctypes.c_int64
    lib.srt_bvh_nrefs.argtypes = [ctypes.c_void_p]


def build_sah(tri_v: np.ndarray, leaf_size: int = 8,
              spatial: bool | None = None) -> SahBvh:
    """Build the SAH BVH8 on the host (raises if the native library
    cannot be built or loaded, or lacks an entry point). `spatial`
    turns on SBVH spatial splits (SBVH_ALPHA, SBVH_FACTOR); None reads
    SRT_SBVH at each call (on only for "1")."""
    lib = native_loader.load_library()
    _bind(lib)
    if spatial is None:
        spatial = os.environ.get("SRT_SBVH", "0") == "1"
    tri_v = np.ascontiguousarray(tri_v, np.float32)
    n = tri_v.shape[0]
    ptr = tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if spatial:
        h = lib.srt_bvh_build2(ptr, n, leaf_size, SBVH_ALPHA, SBVH_FACTOR)
    else:
        h = lib.srt_bvh_build(ptr, n, leaf_size)
    try:
        ni = lib.srt_bvh_ni(h)
        nl = lib.srt_bvh_nleaves(h)
        depth = lib.srt_bvh_depth(h)
        nrefs = lib.srt_bvh_nrefs(h)
        children = np.empty((ni, 48), np.float32)
        ids = np.empty((ni, 8), np.int32)
        order = np.empty((nl * leaf_size,), np.int32)
        lib.srt_bvh_copy(h, children.ctypes.data_as(ctypes.c_void_p),
                         ids.ctypes.data_as(ctypes.c_void_p),
                         order.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.srt_bvh_free(h)
    return SahBvh(children=children, child_ids=ids, order=order,
                  num_internal=int(ni), num_leaves=int(nl),
                  depth=int(depth), leaf_size=leaf_size,
                  num_refs=int(nrefs))


def leaf_rows(tri_v: np.ndarray, order: np.ndarray, leaf_size: int
              ) -> np.ndarray:
    """[L, 9K] component-major triangle rows (v0/e1/e2 per slot) for
    the SAH leaf order; padding slots are degenerate (all-zero)."""
    k = leaf_size
    valid = order >= 0
    safe = np.maximum(order, 0)
    sv = tri_v[safe].astype(np.float32)
    sv[~valid] = 0.0
    v0 = sv[:, 0, :]
    e1 = sv[:, 1, :] - sv[:, 0, :]
    e2 = sv[:, 2, :] - sv[:, 0, :]
    comps = np.concatenate([v0, e1, e2], axis=1)       # [L*K, 9]
    l = order.shape[0] // k
    return comps.reshape(l, k, 9).transpose(0, 2, 1).reshape(l, 9 * k)


def slot_rows(leaf_rows: np.ndarray, leaf_size: int) -> np.ndarray:
    """[L, 9K] component-major leaf rows -> [L*K, 9] f32, one
    (v0, e1, e2) row per triangle slot: the MT table of
    ops/traverse5.py."""
    k = leaf_size
    return np.ascontiguousarray(
        leaf_rows.reshape(-1, 9, k).transpose(0, 2, 1).reshape(-1, 9),
        np.float32)


def validate(bvh: SahBvh, tri_v: np.ndarray) -> None:
    """Structural invariants of a build (the JAX package's
    ops/sah.py:validate): every triangle reachable, every reference
    counted, child boxes inside their parents' and each leaf's box
    around its triangles. Whether the tree is spatial comes from the
    build's declared num_refs, never from the data: an object-split
    tree that duplicated a reference fails. A spatial tree's leaf boxes
    bound clipped fragments, so its full-triangle-in-leaf check is
    skipped; the walks' parity with brute force covers it."""
    ni, k = bvh.num_internal, bvh.leaf_size
    n = tri_v.shape[0]
    seen = bvh.order[bvh.order >= 0]
    if len(np.unique(seen)) != n:
        raise ValueError("validate: a triangle is in no leaf")
    split = bvh.num_refs > n
    if len(seen) != (bvh.num_refs if split else n):
        raise ValueError("validate: reference count mismatch" if split
                         else "validate: duplicated reference")

    boxes = bvh.children.reshape(ni, 6, 8)
    ids = bvh.child_ids
    real = boxes[:, 0, :] < _INF              # [NI, 8] non-empty slots
    if (ids[real] < 0).any() or (ids[real] >= ni + bvh.num_leaves).any():
        raise ValueError("validate: child id out of range")
    lo = boxes[:, 0:3, :].transpose(0, 2, 1)  # [NI, 8, 3]
    hi = boxes[:, 3:6, :].transpose(0, 2, 1)
    node, j = np.nonzero(real & (ids < ni))
    sub = boxes[ids[node, j]]                 # [M, 6, 8] grandchildren
    sreal = sub[:, 0, :] < _INF
    inside = ((sub[:, 0:3, :] >= lo[node, j][:, :, None] - 1e-4)
              & (sub[:, 3:6, :] <= hi[node, j][:, :, None] + 1e-4))
    if not (inside.all(axis=1) | ~sreal).all():
        raise ValueError("validate: a child box leaves its parent's")
    if split:
        return  # clipped references: leaf boxes bound fragments
    node, j = np.nonzero(real & (ids >= ni))
    slots = bvh.order.reshape(-1, k)[ids[node, j] - ni]    # [M, K]
    tv = tri_v[np.maximum(slots, 0)]                        # [M, K, 3, 3]
    inside = ((tv >= lo[node, j][:, None, None, :] - 1e-4)
              & (tv <= hi[node, j][:, None, None, :] + 1e-4))
    if not (inside.all(axis=(2, 3)) | (slots < 0)).all():
        raise ValueError("validate: a triangle leaves its leaf's box")
