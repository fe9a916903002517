"""Woop world -> unit-triangle affine maps for the leaf test.

Per triangle (v0, e1, e2) the affine map M = inv([e1 e2 n]) (rows =
u, v, z functionals; n = e1 x e2) sends a world point p to
(u', v', z') with the triangle at the unit simplex in the z'=0 plane:
    t = -o'z / d'z,  u = o'u + t d'u,  v = o'v + t d'v
M is inverted in float64 and stored f32; t agrees with
Moller-Trumbore to about 5e-4 relative on random triangles.

Degenerate or padding triangles get a dead map (M = 0, tr = (0, 0,
-1e30)): o'z = -1e30 and d'z = 0, so -1/d'z = -inf, t = +inf and
u = 0 + inf*0 = NaN, which fails every hit test. This relies on IEEE
semantics; the CUDA kernel is therefore built without fast math.
"""

from __future__ import annotations

import numpy as np

_BIG = np.float32(1e30)


def woop_from_leaf_rows(leaf_rows: np.ndarray, k: int = 8):
    """leaf_rows [L, 9*k] (v0/e1/e2 xyz component-major, the
    sah.leaf_rows layout) -> (M [L, k, 3, 3] f32, tr [L, k, 3] f32,
    dead [L, k] bool)."""
    L = leaf_rows.shape[0]
    r = leaf_rows.reshape(L, 9, k).astype(np.float64)
    v0 = r[:, 0:3].transpose(0, 2, 1)       # [L, k, 3]
    e1 = r[:, 3:6].transpose(0, 2, 1)
    e2 = r[:, 6:9].transpose(0, 2, 1)
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=3)       # [L, k, 3, 3] columns
    det = np.linalg.det(A)
    # padding rows are all-zero (det 0); tiny-det triangles are dead
    # too. Rays parallel to a live triangle's plane die at intersection
    # time via d'z = 0 -> t = inf.
    dead = np.abs(det) < 1e-30
    A[dead] = np.eye(3)
    M = np.linalg.inv(A)                     # rows: u, v, z functionals
    tr = -np.einsum("lkij,lkj->lki", M, v0)
    M = M.astype(np.float32)
    tr = tr.astype(np.float32)
    M[dead] = 0.0
    tr[dead] = 0.0
    tr[dead, 2] = -_BIG                      # o'z huge -> t = +inf
    return M, tr, dead
