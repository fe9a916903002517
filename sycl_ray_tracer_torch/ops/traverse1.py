"""Closest-hit traversal of the implicit Morton-heap BVH8 with K-slot
Moller-Trumbore leaves: the intersector of scenes built with
leaf_size != 8.

`traverse1` is the port of the JAX package's Pallas kernel
traverse_packets (v1, sycl_ray_tracer_tpu/ops/traverse_pallas.py:216),
with its signature less the static depth. The tables are those of
ops/wbvh.py:build_np: children [NI, 48] and the real leaves
[rows, 9K]. Child j of internal node n is 8n + 1 + j, computed; node
NI + l is leaf l, and the heap's padding leaves (l >= rows) are skipped,
never read. For each active ray it returns the closest hit with
TNEAR < t as Hit(t, tri = l*K + j, u, v), where tri is already a
canonical Morton slot; active rays without a hit get tri = -1 and
t = BIG, inactive rays t = 0 and tri = -1; u = v = 0 whenever tri = -1.
The visit order is nearest child first (the JAX kernel pushes in the
packet's dominant-octant order); the hits do not depend on it, ties
included, but for the rare case that csrc/bvh8_walk.cuh names.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/traverse1.cu: persistent warps over the rays, or over the live
lanes of `active`; built with nvcc for sm_90a at first use by
ops/kernels.py); the tables must start on 16-byte boundaries. On a
CPU tensor it runs `traverse1_plain`, the same function in plain
torch. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops.intersect import Hit
from sycl_ray_tracer_torch.ops.traverse5 import mt_slots
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.ops.walk import walk_plain


def traverse1(children: torch.Tensor, leaves: torch.Tensor, ni: int,
              leaf_size: int, o: V3, d: V3,
              active: torch.Tensor | None = None) -> Hit:
    """children [NI, 48] f32, leaves [rows, 9K] f32 (K = leaf_size),
    o/d V3 of [R] f32, active [R] bool or None (all active). See the
    module docstring."""
    dev = children.device
    if dev.type == "cpu":
        return traverse1_plain(children, leaves, ni, leaf_size, o, d,
                               active=active)
    if dev.type != "cuda":
        raise ValueError(f"traverse1 runs on cuda or cpu, not {dev}")
    kernels.check("children", children, torch.float32, (ni, 48), dev)
    rows = leaves.shape[0]
    kernels.check("leaves", leaves, torch.float32, (rows, 9 * leaf_size),
                  dev)
    kernels.check_rays(o, d, active, None, dev)
    kernels.check_aligned("children", children)
    kernels.check_aligned("leaves", leaves)
    hit = kernels.launch("traverse1", [children, leaves, ni, leaf_size, rows],
                         o, d, active, None, dev)
    traverse1.launches += 1
    return hit


traverse1.launches = 0


def traverse1_plain(children: torch.Tensor, leaves: torch.Tensor, ni: int,
                    leaf_size: int, o: V3, d: V3,
                    active: torch.Tensor | None = None) -> Hit:
    """The same function in plain torch (ops/walk.py) with the heap's
    child ids materialized, padding leaves as empty slots, and the leaf
    test of csrc/traverse1.cuh, summed in the same order."""
    k = leaf_size
    rows = leaves.shape[0]
    dev = children.device
    ids = (8 * torch.arange(ni, device=dev)[:, None] + 1
           + torch.arange(8, device=dev)[None, :])
    ids = torch.where(ids < ni + rows, ids, 0).to(torch.int32)
    comp = leaves.view(rows, 9, k)

    def leaf_test(lray, leaf, tbq):
        ro = [c[lray] for c in o]
        rd = [c[lray] for c in d]
        return mt_slots(ro, rd, comp[leaf].unbind(1), tbq)

    return walk_plain(children, ids, ni, o, d, active, None, leaf_test, k=k)
