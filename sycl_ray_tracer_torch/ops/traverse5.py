"""Closest-hit traversal of a BVH8 with Moller-Trumbore leaf tests, with
an optional instance transform per leaf (two-level instancing).

`traverse5` is the port of the JAX package's Pallas kernel
traverse_packets5 (sycl_ray_tracer_tpu/ops/traverse_pallas5.py:424).
It computes the function of ops/traverse8.py (same node tables, same
t_init, active and tie rules, same Hit) with Moller-Trumbore leaves
read from v0/e1/e2 rows, in one of two modes chosen per call:

- MT mode (leaf_slot = leaf_xf = None): leaf l tests the 8 rows
  mt[8l .. 8l+7];
- itf mode (models/instanced.py): global leaf l tests the 8 rows of
  the shared leaf leaf_slot[l], with the ray mapped into the leaf's
  instance space as o' = M o + t, d' = M d by leaf_xf[l] = (M
  row-major, t). d' is not renormalized, so t stays valid in world
  space.

Either way the reported tri is the slot id l*8 + j of the tree's own
leaves; the caller composes it (bvh_remap).

On a CUDA tensor the wrapper launches the hand-written kernel
(csrc/traverse5.cu: persistent warps over the rays, or over the live
lanes of `active`; built with nvcc for sm_90a at first use by
ops/kernels.py); the tables must start on 16-byte boundaries. On a CPU
tensor it runs `traverse5_plain`, the same function in plain torch.
There is no fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sycl_ray_tracer_torch.ops import kernels
from sycl_ray_tracer_torch.ops.intersect import _DET_EPS, TNEAR, Hit
from sycl_ray_tracer_torch.ops.vec import V3
from sycl_ray_tracer_torch.ops.walk import walk_plain


def traverse5(nodes: torch.Tensor, child_ids: torch.Tensor,
              mt: torch.Tensor, ni: int, o: V3, d: V3,
              active: torch.Tensor | None = None,
              t_init: torch.Tensor | None = None,
              leaf_slot: torch.Tensor | None = None,
              leaf_xf: torch.Tensor | None = None) -> Hit:
    """nodes [NI, 48] f32, child_ids [NI, 8] i32, mt [S, 9] f32 (S a
    multiple of 8), o/d V3 of [R] f32, active [R] bool or None (all
    active), t_init [R] f32 or None (BIG); itf mode: leaf_slot [Lg] i32
    and leaf_xf [Lg, 12] f32. See the module docstring."""
    if (leaf_slot is None) != (leaf_xf is None):
        raise ValueError("leaf_slot and leaf_xf go together")
    dev = nodes.device
    if dev.type == "cpu":
        return traverse5_plain(nodes, child_ids, mt, ni, o, d,
                               active=active, t_init=t_init,
                               leaf_slot=leaf_slot, leaf_xf=leaf_xf)
    if dev.type != "cuda":
        raise ValueError(f"traverse5 runs on cuda or cpu, not {dev}")
    kernels.check("nodes", nodes, torch.float32, (ni, 48), dev)
    kernels.check("child_ids", child_ids, torch.int32, (ni, 8), dev)
    s = mt.shape[0]
    if s % 8:
        raise ValueError(f"mt has {s} rows, not a multiple of 8")
    kernels.check("mt", mt, torch.float32, (s, 9), dev)
    if leaf_slot is not None:
        lg = leaf_slot.shape[0]
        kernels.check("leaf_slot", leaf_slot, torch.int32, (lg,), dev)
        kernels.check("leaf_xf", leaf_xf, torch.float32, (lg, 12), dev)
    kernels.check_rays(o, d, active, t_init, dev)
    for name, t in (("nodes", nodes), ("child_ids", child_ids), ("mt", mt),
                    ("leaf_xf", leaf_xf)):
        if t is not None:
            kernels.check_aligned(name, t)
    hit = kernels.launch("traverse5",
                         [nodes, child_ids, mt, leaf_slot, leaf_xf, ni],
                         o, d, active, t_init, dev)
    traverse5.launches += 1
    return hit


traverse5.launches = 0


def traverse5_plain(nodes: torch.Tensor, child_ids: torch.Tensor,
                    mt: torch.Tensor, ni: int, o: V3, d: V3,
                    active: torch.Tensor | None = None,
                    t_init: torch.Tensor | None = None,
                    leaf_slot: torch.Tensor | None = None,
                    leaf_xf: torch.Tensor | None = None) -> Hit:
    """The same function in plain torch (ops/walk.py), with the leaf
    test of csrc/traverse5.cuh, summed in the same order."""
    mt_leaf = mt.view(-1, 8, 9)

    def leaf_test(lray, leaf, tbq):
        ro = [c[lray] for c in o]
        rd = [c[lray] for c in d]
        if leaf_slot is None:
            rows = mt_leaf[leaf]                        # [Q, 8, 9]
        else:
            rows = mt_leaf[leaf_slot[leaf].to(torch.int64)]
            im = leaf_xf[leaf].unbind(1)
            ro, rd = ([im[3 * a] * ro[0] + im[3 * a + 1] * ro[1]
                       + im[3 * a + 2] * ro[2] + im[9 + a]
                       for a in range(3)],
                      [im[3 * a] * rd[0] + im[3 * a + 1] * rd[1]
                       + im[3 * a + 2] * rd[2] for a in range(3)])
        return mt_slots(ro, rd, rows.unbind(2), tbq)

    return walk_plain(nodes, child_ids, ni, o, d, active, t_init,
                      leaf_test)


def mt_slots(ro, rd, comps, tbq):
    """Moller-Trumbore over the slots of Q leaves, summed in the order
    of csrc/traverse5.cuh:mt_slot: ray origins and directions ro, rd
    (3 tensors [Q] each), the 9 components v0.xyz, e1.xyz, e2.xyz of
    each slot ([Q, S] each), t_best [Q, 1]. Returns (t, u, v, hit), each
    [Q, S]; hit holds TNEAR < t <= t_best (ops/walk.py applies the tie
    rule)."""
    ox, oy, oz = (c[:, None] for c in ro)
    dx, dy, dz = (c[:, None] for c in rd)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = comps
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = det.abs() > _DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok_det & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
           & (tt > TNEAR) & (tt <= tbq))
    return tt, uu, vv, hit


class Tables5(NamedTuple):
    nodes: np.ndarray             # [NI, 48] f32
    child_ids: np.ndarray         # [NI, 8] i32
    mt: np.ndarray                # [8 * leaves in the tiles, 9] f32
    leaf_slot: np.ndarray | None  # [Lg] i32 (itf mode)
    leaf_xf: np.ndarray | None    # [Lg, 12] f32 (itf mode)


def tables_from_tiles(ctiles: np.ndarray, ltiles: np.ndarray, ni: int,
                      ldesc: np.ndarray | None = None) -> Tables5:
    """Unpack the JAX package's v2/v5 tile tables (its
    ops/wbvh.py:pack_tiles_np layout, and the instanced leaf
    descriptors of its models/instanced.py) into this module's tables,
    so that the tests can feed the JAX build's exact tables to the port:

    ctiles [ceil(NI/16), 8, 128]: sublane j = child j; node n % 16 = g
      holds lo.xyz, hi.xyz at lanes 8g+0..5 and the child id (an exact
      f32 integer) at 8g+6;
    ltiles [ceil(L/8), 8, 128]: sublane j = slot j; leaf l % 8 = g
      holds v0, e1, e2 (xyz each) at lanes 16g+0..8; the rows of the
      padding leaves are zero;
    ldesc [Lg, 128]: column 0 the shared leaf, columns 2-13 the
      world -> local transform (M row-major, then t).
    """
    ct = np.asarray(ctiles, np.float32)
    nodes8 = ct.reshape(-1, 8, 16, 8).transpose(0, 2, 1, 3).reshape(
        -1, 8, 8)[:ni]                                  # [NI, child, comp]
    nodes = np.ascontiguousarray(
        nodes8[:, :, :6].transpose(0, 2, 1).reshape(ni, 48))
    child_ids = nodes8[:, :, 6].astype(np.int32)
    lt = np.asarray(ltiles, np.float32)
    mt = np.ascontiguousarray(
        lt.reshape(-1, 8, 8, 16).transpose(0, 2, 1, 3)[..., :9]
        .reshape(-1, 9))
    if ldesc is None:
        return Tables5(nodes, child_ids, mt, None, None)
    ld = np.asarray(ldesc, np.float32)
    return Tables5(nodes, child_ids, mt, ld[:, 0].astype(np.int32),
                   np.ascontiguousarray(ld[:, 2:14]))
