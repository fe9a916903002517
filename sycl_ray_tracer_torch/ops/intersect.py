"""Hit record, intersection constants, Moller-Trumbore and the
brute-force intersectors.

Conventions match Embree's as the reference uses them: t is measured in
units of the (possibly unnormalized) ray direction with tnear = 1e-4
(camera.hpp:46-62), and barycentrics (u, v) weight vertices 1 and 2
while w = 1-u-v weights vertex 0 (trace_ray.hpp:48-55).

intersect_brute (torch) and intersect_brute_np (numpy, the oracle's)
test every ray against every triangle: the judges of the BVH walks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sycl_ray_tracer_torch.ops.vec import V3, cross, dot

TNEAR = 1e-4  # camera.hpp:51 (RTCRay.tnear)
_DET_EPS = 1e-12
BIG = 3.0e38


class Hit(NamedTuple):
    t: torch.Tensor      # [R] float32
    tri: torch.Tensor    # [R] int64 or int32, -1 when miss
    u: torch.Tensor      # [R] float32
    v: torch.Tensor      # [R] float32


def moller_trumbore(o: V3, d: V3, v0: V3, e1: V3, e2: V3,
                    t_max: torch.Tensor):
    """Batched Moller-Trumbore; all arguments broadcast together.
    Returns (hit mask, t, u, v). Degenerate (zero-area padding)
    triangles give det = 0 and are rejected."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok_det = det.abs() > _DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > TNEAR) & (t < t_max))
    return ok, t, u, v


def intersect_brute(o: V3, d: V3, tri_v: torch.Tensor,
                    chunk: int = 2048) -> Hit:
    """Closest hit of every ray against every triangle of tri_v [N, 3, 3],
    one chunk of triangles at a time (memory R x chunk). Ids are rows of
    tri_v; the first of equal t wins within a chunk, the earlier chunk
    across chunks."""
    r = o.x.shape[0]
    dev = o.x.device
    v0 = tri_v[:, 0, :]
    e1 = tri_v[:, 1, :] - tri_v[:, 0, :]
    e2 = tri_v[:, 2, :] - tri_v[:, 0, :]
    t_best = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    id_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((r,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((r,), dtype=torch.float32, device=dev)
    ob = V3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = V3(d.x[:, None], d.y[:, None], d.z[:, None])

    def rows(table, s):
        g = table[s:s + chunk]
        return V3(g[None, :, 0], g[None, :, 1], g[None, :, 2])

    for s in range(0, tri_v.shape[0], chunk):
        ok, t, u, v = moller_trumbore(ob, db, rows(v0, s), rows(e1, s),
                                      rows(e2, s), t_best[:, None])
        t = torch.where(ok, t, BIG)
        k = torch.argmin(t, dim=1, keepdim=True)
        tk = t.gather(1, k)[:, 0]
        better = tk < t_best
        t_best = torch.where(better, tk, t_best)
        id_best = torch.where(better, (s + k[:, 0]).to(torch.int32), id_best)
        u_best = torch.where(better, u.gather(1, k)[:, 0], u_best)
        v_best = torch.where(better, v.gather(1, k)[:, 0], v_best)
    return Hit(t=t_best, tri=id_best, u=u_best, v=v_best)


# ---------------------------------------------------------------------
# numpy twin for the oracle (bit-compatible semantics, not speed)
# ---------------------------------------------------------------------

def intersect_brute_np(o: np.ndarray, d: np.ndarray, tri_v: np.ndarray,
                       t_max=None):
    """o, d: [R, 3]; tri_v: [N, 3, 3] -> (t, tri, u, v) numpy arrays
    (t 3e38 and tri -1 on a miss)."""
    r = o.shape[0]
    n = tri_v.shape[0]
    if n == 0:
        return (np.full(r, 3.0e38, np.float32), np.full(r, -1, np.int32),
                np.zeros(r, np.float32), np.zeros(r, np.float32))
    v0 = tri_v[None, :, 0, :]
    e1 = tri_v[None, :, 1, :] - tri_v[None, :, 0, :]
    e2 = tri_v[None, :, 2, :] - tri_v[None, :, 0, :]
    ob = o[:, None, :]
    db = d[:, None, :]
    pvec = np.cross(db, e2)
    det = (e1 * pvec).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = np.where(np.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = ob - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = np.cross(tvec, e1)
    v = (db * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    ok = ((np.abs(det) > _DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1.0)
          & (t > TNEAR))
    if t_max is not None:
        ok &= t < t_max
    t = np.where(ok, t, np.float32(3.0e38))
    k = np.argmin(t, axis=1)
    ar = np.arange(r)
    tk = t[ar, k].astype(np.float32)
    hit = tk < 3.0e38
    return (tk,
            np.where(hit, k, -1).astype(np.int32),
            np.where(hit, u[ar, k], 0).astype(np.float32),
            np.where(hit, v[ar, k], 0).astype(np.float32))
