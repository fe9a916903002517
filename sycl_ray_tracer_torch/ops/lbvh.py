"""Binary LBVH on torch tensors: Morton sort and an implicit complete
binary heap (the JAX package's ops/lbvh.py).

1. Morton-encode triangle centroids (30-bit, 10 bits an axis).
2. Sort the triangles by code (stable, as jnp.argsort is).
3. Pack K consecutive sorted triangles per leaf, and pad the leaf count
   to a power of two with empty leaves.
4. The leaves are the bottom level of a complete binary heap: node 1 is
   the root, the children of i are 2i and 2i+1, leaves are [L, 2L).
   Nothing is linked: the topology is computed.
5. The box fit is log2(L) min/max halving passes.

It is the cross-check intersector (intersector="lbvh",
models/scene.py, walked by ops/traverse.py): another tree, another walk
and another code path than the SAH BVH8 and its CUDA kernels. morton30
also keys the wavefront's coherence sort (models/wavefront.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_LEAF_SIZE = 4

_INF = 3.0e38


class Bvh(NamedTuple):
    """Implicit-heap BVH. node_lo/node_hi are [2L, 3] (row 0 unused).

    Leaves are nodes [L, 2L); leaf i holds sorted triangles
    [i*K, (i+1)*K). `order` maps sorted slot -> original triangle id
    (-1 for padding slots)."""

    node_lo: torch.Tensor  # [2L, 3] float32
    node_hi: torch.Tensor  # [2L, 3] float32
    order: torch.Tensor    # [L*K] int64, original triangle id or -1

    @property
    def num_leaves(self) -> int:
        return self.node_lo.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.order.shape[0] // self.num_leaves


def _expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zeros between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton30(p: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) for points p [N, 3] in the box
    (lo, hi)."""
    extent = torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp((p - lo) / extent, 0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).to(torch.int64)
    return ((_expand_bits(cell[:, 0]) << 2)
            | (_expand_bits(cell[:, 1]) << 1)
            | _expand_bits(cell[:, 2]))


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def sorted_order(tri_v: torch.Tensor, leaf_size: int = DEFAULT_LEAF_SIZE):
    """Morton-sort triangles [N, 3, 3]. Returns (order [L*K] int64 with
    -1 padding, the leaf count L)."""
    n = tri_v.shape[0]
    k = leaf_size
    l_leaves = next_pow2(-(-n // k)) if n else 1
    if n:
        # (v0 + v1 + v2) / 3 in this order: the rounding of the JAX
        # package's mean over the vertex axis
        centroids = (tri_v[:, 0] + tri_v[:, 1] + tri_v[:, 2]) / 3.0
        codes = morton30(centroids, centroids.amin(0), centroids.amax(0))
        perm = torch.argsort(codes, stable=True)
    else:
        perm = torch.zeros((0,), dtype=torch.int64, device=tri_v.device)
    pad = l_leaves * k - n
    order = torch.cat([perm, torch.full((pad,), -1, dtype=torch.int64,
                                        device=tri_v.device)])
    return order, l_leaves


def fit_nodes(sorted_tri_v: torch.Tensor, valid: torch.Tensor,
              l_leaves: int, leaf_size: int):
    """Box fit of the implicit heap. sorted_tri_v [L*K, 3, 3] (padding
    rows arbitrary), valid [L*K] bool. Returns (node_lo, node_hi), each
    [2L, 3]; the box of a node without triangles is the point at
    infinity (3e38, 3e38, 3e38)."""
    v = sorted_tri_v
    lo_tri = torch.where(valid[:, None], v.amin(1), _INF)
    hi_tri = torch.where(valid[:, None], v.amax(1), -_INF)
    levels_lo = [lo_tri.reshape(l_leaves, leaf_size, 3).amin(1)]
    levels_hi = [hi_tri.reshape(l_leaves, leaf_size, 3).amax(1)]
    while levels_lo[0].shape[0] > 1:
        cur_lo, cur_hi = levels_lo[0], levels_hi[0]
        levels_lo.insert(0, torch.minimum(cur_lo[0::2], cur_lo[1::2]))
        levels_hi.insert(0, torch.maximum(cur_hi[0::2], cur_hi[1::2]))

    # heap layout: level d occupies nodes [2^d, 2^(d+1)); row 0 unused
    row0 = torch.full((1, 3), _INF, dtype=v.dtype, device=v.device)
    node_lo = torch.cat([row0] + levels_lo)
    node_hi = torch.cat([-row0] + levels_hi)
    # Canonicalize empty boxes to the point at infinity: an inverted box
    # does not fail a branchless slab test (its +/-inf slabs cancel into
    # "no constraint"), a far point box always does.
    empty = node_hi[:, :1] < node_lo[:, :1]
    node_lo = torch.where(empty, _INF, node_lo)
    node_hi = torch.where(empty, _INF, node_hi)
    return node_lo, node_hi


def build(tri_v: torch.Tensor, leaf_size: int = DEFAULT_LEAF_SIZE):
    """The whole build. Returns (bvh, sorted_tri_v [L*K, 3, 3] with zero
    padding rows, valid [L*K] bool); the caller applies `bvh.order` to
    its other per-triangle arrays."""
    order, l_leaves = sorted_order(tri_v, leaf_size)
    valid = order >= 0
    if tri_v.shape[0]:
        sorted_v = tri_v[order.clamp(min=0)]
    else:
        sorted_v = torch.zeros((l_leaves * leaf_size, 3, 3),
                               dtype=torch.float32, device=tri_v.device)
    sorted_v = torch.where(valid[:, None, None], sorted_v, 0.0)
    node_lo, node_hi = fit_nodes(sorted_v, valid, l_leaves, leaf_size)
    return Bvh(node_lo=node_lo, node_hi=node_hi, order=order), sorted_v, valid


# ---------------------------------------------------------------------
# Validation (numpy; used by the tests): the invariants a BVH build must
# guarantee.
# ---------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def validate(bvh: Bvh, sorted_tri_v, valid) -> None:
    node_lo = _np(bvh.node_lo)
    node_hi = _np(bvh.node_hi)
    l_leaves = bvh.num_leaves
    k = bvh.leaf_size
    v = _np(sorted_tri_v)
    val = _np(valid)

    # Every valid triangle is contained in its leaf box.
    for leaf in range(l_leaves):
        sl = slice(leaf * k, (leaf + 1) * k)
        if not val[sl].any():
            continue
        tv = v[sl][val[sl]]
        lo = node_lo[l_leaves + leaf]
        hi = node_hi[l_leaves + leaf]
        assert (tv.reshape(-1, 3) >= lo - 1e-4).all(), f"leaf {leaf} lo"
        assert (tv.reshape(-1, 3) <= hi + 1e-4).all(), f"leaf {leaf} hi"

    # Every internal node contains its children.
    for i in range(1, l_leaves):
        for c in (2 * i, 2 * i + 1):
            if (node_lo[c] >= 3.0e37).all():
                continue  # empty child (point-at-infinity box)
            assert (node_lo[i] <= node_lo[c] + 1e-4).all()
            assert (node_hi[i] >= node_hi[c] - 1e-4).all()
