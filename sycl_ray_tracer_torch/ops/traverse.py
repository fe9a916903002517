"""Closest-hit walk of the binary LBVH (ops/lbvh.py), in plain torch.

The per-lane function of the JAX package's ops/traverse.py:traverse:
each ray keeps its own node, stack and best hit.
  - internal node: slab-test both children (children of i are 2i and
    2i+1, computed, not loaded); descend into the nearer hit child
    (the left one on equal entry t), push the farther one if both hit;
    pop on a double miss;
  - leaf node: Moller-Trumbore on the leaf's K rows, keep the closest
    (the first of equal t), pop.
A ray ends when it must pop an empty stack; t_best tightens as hits
land, culling boxes on later steps.

The JAX walk steps every lane every step under masks. This one steps
only the rays still alive: each step gathers the live rays' nodes by
index, splits them into internal and leaf rays, pushes by a scatter at
the stack pointer, and drops the rays whose stack emptied. No ray's
result depends on that: every ray takes the same steps in the same
order. It is the cross-check intersector (intersector="lbvh"); there
is no kernel behind it. `traverse.steps` counts the steps walked.
"""

from __future__ import annotations

import torch

from sycl_ray_tracer_torch.ops.intersect import (BIG, TNEAR, Hit,
                                                 moller_trumbore)
from sycl_ray_tracer_torch.ops.vec import V3


def _slab_test(o, inv_d, t_best, lo, hi):
    """(hit, t_entry) of rays o/inv_d [M, 3] against boxes lo/hi
    [M, 3]; point-at-infinity boxes never hit."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = torch.minimum(t1, t2).amax(1)
    tmax = torch.maximum(t1, t2).amin(1)
    hit = (tmax >= torch.clamp(tmin, min=TNEAR)) & (tmin < t_best)
    return hit, tmin


def _cols(a: torch.Tensor) -> V3:
    return V3(a[..., 0], a[..., 1], a[..., 2])


def traverse(node_lo: torch.Tensor, node_hi: torch.Tensor,
             tri_v0: torch.Tensor, tri_e1: torch.Tensor,
             tri_e2: torch.Tensor, o: V3, d: V3, leaf_size: int,
             active_in: torch.Tensor | None = None) -> Hit:
    """node_lo/node_hi [2L, 3] f32; tri_* [L*K, 3] f32 in sorted leaf
    order (padding rows are degenerate and never hit); o/d V3 of [R]
    f32; active_in [R] bool or None (all). Returns Hit with t f32 (BIG
    on a miss), tri i32 sorted slot ids (-1 on a miss or an inactive
    lane), u, v f32 (0 on a miss)."""
    l_leaves = node_lo.shape[0] // 2
    depth = max(l_leaves.bit_length() + 1, 2)
    k = leaf_size
    r = o.x.shape[0]
    dev = o.x.device
    t_out = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((r,), dtype=torch.float32, device=dev)

    o3 = torch.stack(list(o), 1)
    d3 = torch.stack(list(d), 1)
    inv3 = torch.where(d3.abs() > 1e-20, 1.0 / d3, 1e20)
    # the root pre-test lets rays that miss the scene skip the walk
    root_hit, _ = _slab_test(o3, inv3, BIG, node_lo[1:2], node_hi[1:2])
    alive = root_hit & (l_leaves > 0)
    if active_in is not None:
        alive = alive & active_in
    lane = alive.nonzero().squeeze(1)
    o3, d3, inv3 = o3[lane], d3[lane], inv3[lane]
    n = lane.shape[0]
    cur = torch.ones((n,), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    tb = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    slots = torch.arange(k, dtype=torch.int64, device=dev)

    while n:
        traverse.steps += 1
        is_leaf = cur >= l_leaves
        pop = is_leaf.clone()

        # ---- internal nodes: test both children -------------------
        ii = (~is_leaf).nonzero().squeeze(1)
        if ii.numel():
            left = cur[ii] * 2
            right = left + 1
            oi, di, ti = o3[ii], inv3[ii], tb[ii]
            hit_l, t_l = _slab_test(oi, di, ti, node_lo[left], node_hi[left])
            hit_r, t_r = _slab_test(oi, di, ti, node_lo[right],
                                    node_hi[right])
            both = hit_l & hit_r
            l_first = torch.where(both, t_l <= t_r, hit_l)
            near = torch.where(l_first, left, right)
            far = torch.where(l_first, right, left)
            pi = ii[both]
            stack[pi, sp[pi]] = far[both]
            sp[pi] += 1
            entered = hit_l | hit_r
            cur[ii[entered]] = near[entered]
            pop[ii[~entered]] = True

        # ---- leaves: K triangle tests -------------------------------
        li = is_leaf.nonzero().squeeze(1)
        if li.numel():
            idx = ((cur[li] - l_leaves) * k)[:, None] + slots[None, :]
            ol, dl = o3[li][:, None, :], d3[li][:, None, :]
            ok, tt, uu, vv = moller_trumbore(
                _cols(ol), _cols(dl), _cols(tri_v0[idx]), _cols(tri_e1[idx]),
                _cols(tri_e2[idx]), tb[li][:, None])
            tt = torch.where(ok, tt, BIG)
            kbest = torch.argmin(tt, dim=1, keepdim=True)
            t_cand = tt.gather(1, kbest)[:, 0]
            better = t_cand < tb[li]
            bi = li[better]
            tb[bi] = t_cand[better]
            lb = lane[bi]
            t_out[lb] = t_cand[better]
            tri_out[lb] = idx.gather(1, kbest)[better, 0].to(torch.int32)
            u_out[lb] = uu.gather(1, kbest)[better, 0]
            v_out[lb] = vv.gather(1, kbest)[better, 0]

        # ---- pop, or end the ray on an empty stack ------------------
        pi = pop.nonzero().squeeze(1)
        can = sp[pi] > 0
        pc = pi[can]
        sp[pc] -= 1
        cur[pc] = stack[pc, sp[pc]]
        if not bool(can.all()):
            keep = torch.ones((n,), dtype=torch.bool, device=dev)
            keep[pi[~can]] = False
            lane, o3, d3, inv3 = lane[keep], o3[keep], d3[keep], inv3[keep]
            cur, sp, stack, tb = cur[keep], sp[keep], stack[keep], tb[keep]
            n = lane.shape[0]
    return Hit(t=t_out, tri=tri_out, u=u_out, v=v_out)


traverse.steps = 0
