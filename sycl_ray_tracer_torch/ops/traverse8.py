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

Given the scene's box as `order_box` with a mask, the kernel gathers
the live lanes' rays in buckets of their dir6_morton key (the
wavefront's sort key, models/wavefront.py _coherence_key): the top
ORDER_BITS bits of it, `order_buckets`; then it walks them in that
order. The hits do not depend on the order. `order` runs the gather
alone (the card's kernels or their host build), and `order_plain` is
its plain torch version, whose order within a bucket is lane order, as
the host build's; the card's order within a bucket is free.
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops.intersect import TNEAR, Hit
from sycl_ray_tracer_torch.ops.kernels import ORDER_BITS
from sycl_ray_tracer_torch.ops.lbvh import morton30
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.ops.walk import walk_plain


def traverse8(nodes: torch.Tensor, child_ids: torch.Tensor,
              woop: torch.Tensor, ni: int, o: V3, d: V3,
              active: torch.Tensor | None = None,
              t_init: torch.Tensor | None = None,
              order_box: tuple | None = None) -> Hit:
    """nodes [NI, 48] f32, child_ids [NI, 8] i32, woop [S, 12] f32,
    o/d V3 of [R] f32, active [R] bool or None (all active), t_init [R]
    f32 or None (BIG), order_box (scene_lo, scene_hi) f32 [3] each or
    None (lane order; needs `active`). See the module docstring for the
    semantics."""
    if order_box is not None and active is None:
        raise ValueError("order_box orders the live lanes of a mask; "
                         "pass active")
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
    if order_box is not None:
        _check_box(order_box, dev)
        hit = kernels.launch("traverse8", [nodes, child_ids, woop, ni], o,
                             d, active, t_init, dev, order_box=order_box)
        traverse8.ordered_launches += 1
    else:
        hit = kernels.launch("traverse8", [nodes, child_ids, woop, ni], o,
                             d, active, t_init, dev)
    traverse8.launches += 1
    return hit


traverse8.launches = 0
traverse8.ordered_launches = 0


def _check_box(box, dev) -> None:
    for name, b in zip(("scene_lo", "scene_hi"), box):
        kernels.check(name, b, torch.float32, (3,), dev)


def order_buckets(o: V3, d: V3, scene_lo: torch.Tensor,
                  scene_hi: torch.Tensor) -> torch.Tensor:
    """Each ray's bucket (int64 [R]): the top ORDER_BITS bits of its
    dir6_morton key over the box, that is its direction octant, its
    dominant axis (x wins no tie, y wins over z), two bits that are
    always 0, and the top ORDER_BITS - 7 bits of the Morton code of its
    origin."""
    oct_ = (((d.x < 0).to(torch.int64) << 2)
            | ((d.y < 0).to(torch.int64) << 1)
            | (d.z < 0).to(torch.int64))
    ax, ay, az = d.x.abs(), d.y.abs(), d.z.abs()
    dom = torch.where(ax > ay, torch.where(ax > az, 0, 2),
                      torch.where(ay > az, 1, 2)).to(torch.int64)
    m = morton30(torch.stack([o.x, o.y, o.z], dim=-1), scene_lo, scene_hi)
    return ((oct_ << (ORDER_BITS - 3)) | (dom << (ORDER_BITS - 5))
            | (m >> (37 - ORDER_BITS)))


def order_plain(o: V3, d: V3, active: torch.Tensor, scene_lo: torch.Tensor,
                scene_hi: torch.Tensor) -> torch.Tensor:
    """The live lanes of `active` [R] (int64 [M]) in ascending bucket
    (order_buckets), in lane order within a bucket."""
    live = active.nonzero().squeeze(1)
    b = order_buckets(V3(*(c[live] for c in o)), V3(*(c[live] for c in d)),
                      scene_lo, scene_hi)
    return live[torch.argsort(b, stable=True)]


def order(o: V3, d: V3, active: torch.Tensor, scene_lo: torch.Tensor,
          scene_hi: torch.Tensor):
    """What the ordered masked launch runs before its walk: (rec [R, 8]
    f32, live int64 0-dim, hit t/tri/u/v [R]). The first `live` rows of
    rec are the live lanes in ascending bucket, each its ray (o, d in
    columns 0-5) and its lane (int32 bits in column 6; `record_lanes`);
    the inactive lanes' results are (0, -1, 0, 0), a live lane's are
    not yet written (its tri holds its bin and its u its place in the
    bin, csrc/traverse8.cu). The kernels on a CUDA device, their host
    build (a stable counting sort) on the CPU. Does not wait for the
    card."""
    if active is None:
        raise ValueError("order needs an active mask")
    dev = kernels.entry_device(o.x)
    kernels.check_rays(o, d, active, None, dev)
    _check_box((scene_lo, scene_hi), dev)
    r = o.x.shape[0]
    rec = torch.empty((r, kernels.RECORD_FLOATS), dtype=torch.float32,
                      device=dev)
    counters = torch.zeros((2 + kernels.ORDER_BINS // 2,),
                           dtype=torch.int64, device=dev)
    hit = Hit(t=torch.empty((r,), dtype=torch.float32, device=dev),
              tri=torch.empty((r,), dtype=torch.int32, device=dev),
              u=torch.empty((r,), dtype=torch.float32, device=dev),
              v=torch.empty((r,), dtype=torch.float32, device=dev))
    kernels.call("traverse8_order", dev, active.data_ptr(),
                 *(c.data_ptr() for c in (*o, *d)), scene_lo.data_ptr(),
                 scene_hi.data_ptr(), *(x.data_ptr() for x in hit), r,
                 rec.data_ptr(), counters.data_ptr())
    return rec, counters[0], hit


def record_lanes(rec: torch.Tensor, live: int) -> torch.Tensor:
    """The lanes (int64 [live]) of the first `live` records of `order`."""
    return rec[:live, 6].contiguous().view(torch.int32).to(torch.int64)


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
