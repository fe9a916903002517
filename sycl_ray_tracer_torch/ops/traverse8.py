"""Closest-hit traversal of the SAH BVH8 with Woop leaf tests.

`traverse8` is the port of the JAX package's Pallas kernel
traverse_packets8 (sycl_ray_tracer_tpu/ops/traverse_pallas8.py:371).
For each active ray (origin o, unnormalized direction d, incumbent
t_init) it returns the closest triangle hit with TNEAR < t < t_init (of
two at a bit-equal t, the lower id: csrc/bvh8_walk.cuh) as
Hit(t f32, tri i32 leaf-slot id leaf_row*8 + j, u f32, v f32); the
caller maps slot ids to the canonical Morton order. Active rays without
such a hit get tri = -1 and t = t_init; inactive rays get t = 0 and
tri = -1; u = v = 0 whenever tri = -1.

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/traverse8.cu: persistent warps over the rays, or over the live
lanes of `active`; built with nvcc for sm_90a at first use by
ops/kernels.py); the tables must start on 16-byte boundaries. On a
CPU tensor it runs `traverse8_plain`, the same function in plain
torch. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops.intersect import TNEAR, Hit
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.ops.walk import walk_plain


def traverse8(nodes: torch.Tensor, child_ids: torch.Tensor,
              woop: torch.Tensor, ni: int, o: V3, d: V3,
              active: torch.Tensor | None = None,
              t_init: torch.Tensor | None = None) -> Hit:
    """nodes [NI, 48] f32, child_ids [NI, 8] i32, woop [S, 12] f32,
    o/d V3 of [R] f32, active [R] bool or None (all active), t_init [R]
    f32 or None (BIG). See the module docstring for the semantics."""
    dev = nodes.device
    if dev.type == "cpu":
        return traverse8_plain(nodes, child_ids, woop, ni, o, d,
                               active=active, t_init=t_init)
    if dev.type != "cuda":
        raise ValueError(f"traverse8 runs on cuda or cpu, not {dev}")
    kernels.check("nodes", nodes, torch.float32, (ni, 48), dev)
    kernels.check("child_ids", child_ids, torch.int32, (ni, 8), dev)
    kernels.check("woop", woop, torch.float32, (woop.shape[0], 12), dev)
    kernels.check_rays(o, d, active, t_init, dev)
    for name, t in (("nodes", nodes), ("child_ids", child_ids),
                    ("woop", woop)):
        kernels.check_aligned(name, t)
    hit = kernels.launch("traverse8", [nodes, child_ids, woop, ni], o, d,
                         active, t_init, dev)
    traverse8.launches += 1
    return hit


traverse8.launches = 0


def traverse8_plain(nodes: torch.Tensor, child_ids: torch.Tensor,
                    woop: torch.Tensor, ni: int, o: V3, d: V3,
                    active: torch.Tensor | None = None,
                    t_init: torch.Tensor | None = None) -> Hit:
    """The same function in plain torch (ops/walk.py), with the Woop
    leaf test of csrc/traverse8.cuh."""
    w_leaf = woop.view(-1, 8, 12)

    def leaf_test(lray, leaf, tbq):
        w = w_leaf[leaf]                                # [Q, 8, 12]
        lo = [c[lray][:, None] for c in o]
        ld = [c[lray][:, None] for c in d]
        op = [w[..., 3 * a] * lo[0] + w[..., 3 * a + 1] * lo[1]
              + w[..., 3 * a + 2] * lo[2] + w[..., 9 + a] for a in range(3)]
        dp = [w[..., 3 * a] * ld[0] + w[..., 3 * a + 1] * ld[1]
              + w[..., 3 * a + 2] * ld[2] for a in range(3)]
        tt = op[2] * (-1.0 / dp[2])
        uu = op[0] + tt * dp[0]
        vv = op[1] + tt * dp[1]
        hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
               & (tt > TNEAR) & (tt <= tbq))
        return tt, uu, vv, hit

    return walk_plain(nodes, child_ids, ni, o, d, active, t_init,
                      leaf_test)
