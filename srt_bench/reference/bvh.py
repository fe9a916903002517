"""The reference's closest-hit query: a binary LBVH over the baked
triangles and a per-ray stack walk, in plain torch.

Build: Morton codes of the triangle centroids (10 bits an axis) sort
the triangles; K consecutive ones form a leaf; the leaf count is padded
to a power of two, and the leaves are the bottom level of an implicit
complete binary heap (node 1 the root, children 2i and 2i + 1), whose
boxes are fitted level by level. Walk: each ray slab-tests both
children of its node, descends into the nearer (the left on equal entry
t), pushes the farther, and at a leaf keeps the closest Moller-Trumbore
hit with t in (1e-4, t_best), the first of equal t. Hits are measured
in units of the unnormalized direction, as the upstream renderer's
Embree rays are (tnear 1e-4).

It is another tree, another walk and another triangle test than the
program's SAH BVH8 kernels; where two triangles tie at a bit-equal t,
the two may choose differently, and the path flips.
"""

from __future__ import annotations

import torch

TNEAR = 1e-4
BIG = 3.0e38
_DET_EPS = 1e-12
LEAF = 4
SYNC_EVERY = 16  # walk steps between the host's looks at the device


def _expand_bits(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton(p, lo, hi):
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-20), 0.0,
                    1.0 - 1e-7)
    c = (q * 1024.0).to(torch.int64)
    return ((_expand_bits(c[:, 0]) << 2) | (_expand_bits(c[:, 1]) << 1)
            | _expand_bits(c[:, 2]))


class Bvh:
    """lo/hi [2L, 3] boxes of the heap; v0/e1/e2 [L*K, 3] of the sorted
    triangles (zero rows pad, never hit); tri [L*K] their ids."""

    def __init__(self, tri_v: torch.Tensor):
        n = tri_v.shape[0]
        dev = tri_v.device
        self.leaf = leaf = LEAF
        n_leaves = 1 << max(0, (-(-n // leaf) - 1).bit_length())
        cen = (tri_v[:, 0] + tri_v[:, 1] + tri_v[:, 2]) / 3.0
        perm = torch.argsort(_morton(cen, cen.amin(0), cen.amax(0)),
                             stable=True)
        pad = n_leaves * leaf - n
        self.tri = torch.cat([perm, torch.full((pad,), -1, dtype=torch.int64,
                                               device=dev)])
        valid = self.tri >= 0
        v = torch.where(valid[:, None, None], tri_v[self.tri.clamp(min=0)],
                        0.0)
        self.v0 = v[:, 0].contiguous()
        self.e1 = (v[:, 1] - v[:, 0]).contiguous()
        self.e2 = (v[:, 2] - v[:, 0]).contiguous()
        lo = torch.where(valid[:, None], v.amin(1), BIG)
        hi = torch.where(valid[:, None], v.amax(1), -BIG)
        lo_lv = [lo.view(n_leaves, leaf, 3).amin(1)]
        hi_lv = [hi.view(n_leaves, leaf, 3).amax(1)]
        while lo_lv[0].shape[0] > 1:
            lo_lv.insert(0, torch.minimum(lo_lv[0][0::2], lo_lv[0][1::2]))
            hi_lv.insert(0, torch.maximum(hi_lv[0][0::2], hi_lv[0][1::2]))
        row0 = torch.full((1, 3), BIG, device=dev)
        lo = torch.cat([row0] + lo_lv)
        hi = torch.cat([-row0] + hi_lv)
        empty = hi[:, :1] < lo[:, :1]      # an empty box never hits
        self.lo = torch.where(empty, BIG, lo)
        self.hi = torch.where(empty, BIG, hi)
        self.n_leaves = n_leaves

    def intersect(self, o: torch.Tensor, d: torch.Tensor):
        """Closest hits of rays o, d [R, 3]: (t [R], triangle id [R]
        int64, -1 on a miss, u [R], v [R]). Every ray takes one step a
        round, under masks, and the host looks at the device only every
        SYNC_EVERY rounds, to drop the rays that have ended."""
        r, dev, k, nl = o.shape[0], o.device, self.leaf, self.n_leaves
        t_out = torch.full((r,), BIG, device=dev)
        id_out = torch.full((r,), -1, dtype=torch.int64, device=dev)
        u_out = torch.zeros((r,), device=dev)
        v_out = torch.zeros((r,), device=dev)
        inv = torch.where(d.abs() > 1e-20, 1.0 / d, 1e20)
        alive, _ = _slab(o, inv, BIG, self.lo[1:2], self.hi[1:2])
        lane = alive.nonzero().squeeze(1)
        o, d, inv = o[lane], d[lane], inv[lane]
        n = lane.shape[0]
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        cur = torch.ones((n,), dtype=torch.int64, device=dev)
        sp = torch.zeros((n,), dtype=torch.int64, device=dev)
        stack = torch.zeros((n, nl.bit_length() + 1), dtype=torch.int64,
                            device=dev)
        tb = torch.full((n,), BIG, device=dev)
        best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        bu = torch.zeros((n,), device=dev)
        bv = torch.zeros((n,), device=dev)
        slots = torch.arange(k, device=dev)
        while n:
            for _ in range(SYNC_EVERY):
                is_leaf = cur >= nl
                inner = alive & ~is_leaf
                left = torch.where(is_leaf, 1, cur) * 2
                hl, tl = _slab(o, inv, tb, self.lo[left], self.hi[left])
                hr, tr = _slab(o, inv, tb, self.lo[left + 1],
                               self.hi[left + 1])
                hl, hr = hl & inner, hr & inner
                both = hl & hr
                lfirst = torch.where(both, tl <= tr, hl)
                near = torch.where(lfirst, left, left + 1)
                far = torch.where(lfirst, left + 1, left)
                top = stack.gather(1, sp[:, None])[:, 0]
                stack.scatter_(1, sp[:, None],
                               torch.where(both, far, top)[:, None])
                sp = sp + both
                entered = hl | hr

                leaf = alive & is_leaf
                idx = ((torch.where(is_leaf, cur, nl) - nl) * k)[:, None] \
                    + slots[None, :]
                ok, tt, uu, vv = _moller_trumbore(
                    o[:, None, :], d[:, None, :], self.v0[idx], self.e1[idx],
                    self.e2[idx], tb[:, None])
                tt = torch.where(ok, tt, BIG)
                kb = torch.argmin(tt, dim=1, keepdim=True)
                tc = tt.gather(1, kb)[:, 0]
                better = leaf & (tc < tb)
                tb = torch.where(better, tc, tb)
                best = torch.where(better, idx.gather(1, kb)[:, 0], best)
                bu = torch.where(better, uu.gather(1, kb)[:, 0], bu)
                bv = torch.where(better, vv.gather(1, kb)[:, 0], bv)

                pop = alive & (is_leaf | ~entered)
                can = pop & (sp > 0)
                sp = sp - can.long()
                popped = stack.gather(1, sp[:, None])[:, 0]
                cur = torch.where(inner & entered, near,
                                  torch.where(can, popped, cur))
                alive = alive & ~(pop & ~can)
            done = ~alive
            if bool(done.any()):
                di = done.nonzero().squeeze(1)
                hit = di[best[di] >= 0]
                lh = lane[hit]
                t_out[lh] = tb[hit]
                id_out[lh] = self.tri[best[hit]]
                u_out[lh] = bu[hit]
                v_out[lh] = bv[hit]
                keep = alive.nonzero().squeeze(1)
                lane, o, d, inv = lane[keep], o[keep], d[keep], inv[keep]
                cur, sp, stack, tb = cur[keep], sp[keep], stack[keep], tb[keep]
                best, bu, bv = best[keep], bu[keep], bv[keep]
                alive = alive[keep]
                n = lane.shape[0]
        return t_out, id_out, u_out, v_out


def _slab(o, inv, t_best, lo, hi):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    return (tmax >= torch.clamp(tmin, min=TNEAR)) & (tmin < t_best), tmin


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _moller_trumbore(o, d, v0, e1, e2, t_max):
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok_det = det.abs() > _DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > TNEAR)
          & (t < t_max))
    return ok, t, u, v
