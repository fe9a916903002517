"""The level-synchronous BVH8 walk in plain torch, generic over the leaf
test: the body of traverse8_plain (Woop leaves), traverse5_plain
(Moller-Trumbore leaves, optionally instance-transformed) and
traverse1_plain (K-slot Moller-Trumbore leaves of the Morton heap).

It computes the function of the kernels' per-ray walks
(csrc/walk_regs.cuh, csrc/bvh8_walk.cuh) over all rays at once: each
level slab-tests all 8 children of every (ray, node) pair, tests the
accepted leaves, folds the per-ray least (t, id) hit into (t_best, tri)
with scatter_reduce("amin"), and descends into the accepted internal
children. The order of the walk differs from the kernel's depth-first
one, but the closest hit does not depend on it: of two hits at a
bit-equal t the lower id wins, and a box is entered while its entry
distance is at most t_best (csrc/bvh8_walk.cuh, the tie rule, and the
one rare case it leaves to the order).
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.ops.intersect import BIG, TNEAR, Hit
from sycl_ray_tracer_torch.ops.vec import V3


def walk_plain(nodes: torch.Tensor, child_ids: torch.Tensor, ni: int,
               o: V3, d: V3, active, t_init, leaf_test, k: int = 8) -> Hit:
    """child_ids [NI, 8] (0: empty slot); leaf_test(ray_idx [Q] i64,
    leaf [Q] i64, t_best [Q, 1]) -> (t, u, v, hit), each [Q, k]: the k
    slots of leaf `leaf` against ray `ray_idx`, reported as
    leaf * k + slot, where hit holds the slots with TNEAR < t <=
    t_best (the tie rule then picks among those at t_best)."""
    dev = o.x.device
    r = o.x.shape[0]
    act = (torch.ones((r,), dtype=torch.bool, device=dev) if active is None
           else active)
    t0 = (torch.full((r,), BIG, dtype=torch.float32, device=dev)
          if t_init is None else t_init)
    tb = torch.where(act, t0, torch.full_like(t0, -BIG))
    tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((r,), dtype=torch.float32, device=dev)
    v = torch.zeros((r,), dtype=torch.float32, device=dev)
    inv = [torch.where(c.abs() > 1e-20, 1.0 / c, torch.full_like(c, 1e20))
           for c in d]
    inf = float("inf")

    ray = act.nonzero().squeeze(1)
    node = torch.zeros_like(ray)
    while ray.numel():
        box = nodes[node].view(-1, 6, 8)
        ids = child_ids[node]
        oc = [c[ray][:, None] for c in o]
        ic = [c[ray][:, None] for c in inv]
        t1 = [(box[:, a] - oc[a]) * ic[a] for a in range(3)]
        t2 = [(box[:, 3 + a] - oc[a]) * ic[a] for a in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                           torch.minimum(t1[1], t2[1])),
                             torch.minimum(t1[2], t2[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                           torch.maximum(t1[1], t2[1])),
                             torch.maximum(t1[2], t2[2]))
        ok = ((tmax >= torch.clamp(tmin, min=TNEAR))
              & (tmin <= tb[ray][:, None]) & (ids != 0))
        is_leaf = ids >= ni

        lp, lj = (ok & is_leaf).nonzero(as_tuple=True)
        if lp.numel():
            lray = ray[lp]
            leaf = (ids[lp, lj] - ni).to(torch.int64)
            tt, uu, vv, hit = leaf_test(lray, leaf, tb[lray][:, None])
            # each leaf's least (t, slot), then each ray's least (t, id)
            tq = torch.where(hit, tt, inf).min(dim=1).values
            slot = torch.arange(k, device=dev)
            sq = torch.where(hit & (tt == tq[:, None]), slot, k).min(
                dim=1).values
            best = torch.full((r,), inf, dtype=torch.float32, device=dev)
            best.scatter_reduce_(0, lray, tq, "amin")
            win = (tq < inf) & (tq == best[lray])
            cand = leaf * k + sq
            best_id = torch.full((r,), torch.iinfo(torch.int64).max,
                                 dtype=torch.int64, device=dev)
            best_id.scatter_reduce_(0, lray[win], cand[win], "amin")
            # one leaf a ray: a ray meets each leaf at most once a walk
            qs = (win & (cand == best_id[lray])).nonzero().squeeze(1)
            rw = lray[qs]
            # the incumbent keeps an equal t unless the new id is lower
            take = (tq[qs] < tb[rw]) | (cand[qs] < tri[rw].to(torch.int64))
            rw, qs = rw[take], qs[take]
            sqs = sq[qs]
            tb[rw] = tq[qs]
            tri[rw] = cand[qs].to(torch.int32)
            u[rw] = uu[qs, sqs]
            v[rw] = vv[qs, sqs]

        ip, ij = (ok & ~is_leaf).nonzero(as_tuple=True)
        ray = ray[ip]
        node = ids[ip, ij].to(torch.int64)
    t = torch.where(act, tb, torch.zeros_like(tb))
    return Hit(t=t, tri=tri, u=u, v=v)
