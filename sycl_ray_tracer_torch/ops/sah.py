"""Binned-SAH BVH8: binding to the native build (native/srt_bvh.cpp).

The native code does a top-down binary binned-SAH split, collapses the
binary tree to 8-wide nodes and emits component-major child boxes
[NI, 48], child ids [NI, 8] (internal child = its row; leaf child =
NI + leaf_row; empty slot = id 0 with a point-at-infinity box) and the
leaf order [L*K] of original triangle ids (-1 padding).

Triangle identity: the intersector reports hits in SAH-slot space
(leaf_row * K + j); models/scene.py builds the remap to the canonical
Morton slots that every shading table uses.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from sycl_ray_tracer_torch.utils import native_loader


class SahBvh(NamedTuple):
    children: np.ndarray   # [NI, 48] component-major child boxes
    child_ids: np.ndarray  # [NI, 8] int32 (leaf child = NI + leaf_row)
    order: np.ndarray      # [L*K] int32 original tri ids (-1 pad)
    num_internal: int
    num_leaves: int
    depth: int
    leaf_size: int


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


def build_sah(tri_v: np.ndarray, leaf_size: int = 8) -> SahBvh:
    """Build the object-split SAH BVH8 on the host (raises if the
    native library cannot be built or loaded)."""
    lib = native_loader.load_library()
    _bind(lib)
    tri_v = np.ascontiguousarray(tri_v, np.float32)
    n = tri_v.shape[0]
    h = lib.srt_bvh_build(
        tri_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, leaf_size)
    try:
        ni = lib.srt_bvh_ni(h)
        nl = lib.srt_bvh_nleaves(h)
        depth = lib.srt_bvh_depth(h)
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
                  depth=int(depth), leaf_size=leaf_size)


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
