// Moller-Trumbore leaf tests for the BVH8 walk (walk_regs.cuh), with an
// optional instance transform per leaf: the per-ray function of the
// traverse5 kernel.
//
// Leaf tables (models/scene.py, models/instanced.py):
//   mt        [S8, 9] f32 per triangle slot: v0, e1 = v1 - v0,
//             e2 = v2 - v0 (xyz each); padding slots are all zero and
//             never hit (det = 0)
//   leaf_slot [Lg] i32 (itf mode only): the shared leaf whose 8 slots
//             global leaf l tests
//   leaf_xf   [Lg, 12] f32 (itf mode only): the world -> local
//             transform of leaf l's instance, M row-major (9) then t
//             (3); the ray is tested as o' = M o + t, d' = M d. d' is
//             not renormalized, so t stays valid in world space.
// In MT mode (MtLeaf) leaf l tests its own slots mt[8l .. 8l+7]; in itf
// mode (InstancedMtLeaf) the slots of its shared leaf. Either way the
// reported tri is l*8 + j.
//
// A leaf's 8 slots are 72 contiguous floats (288 bytes), read four
// slots at a time as nine 16-byte loads with each component at a
// compile-time index; a transform is three 16-byte loads. The wrappers
// check that mt and leaf_xf start on 16-byte boundaries, and every row
// offset is a multiple of 16 bytes.
//
// Every expression is summed in the order of the JAX package's kernel
// (traverse_pallas5.py:270-318) and of ops/traverse5.py; built without
// FMA contraction, the three agree bit for bit.

#pragma once

#include "walk_regs.cuh"

namespace srt {

constexpr float kDetEps = 1e-12f;

// One triangle (v0, e1, e2) against the ray: on a hit with t below
// `bound` (the walk's tie rule, tie_bound() in bvh8_walk.cuh), sets tb
// and bound to t and records (t, id, u, v).
SRT_HD void mt_slot(float v0x, float v0y, float v0z, float e1x, float e1y,
                    float e1z, float e2x, float e2y, float e2z,
                    const Ray& r, int32_t id, float& tb, float& bound,
                    HitOut& h) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok_det = det > kDetEps || det < -kDetEps;
  const float inv_det = ok_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float uu = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (ok_det && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
      tt > kTnear && tt < bound) {
    tb = tt;
    bound = tt;
    h.tri = id;
    h.u = uu;
    h.v = vv;
  }
}

// The 8 slots of row `row` of mt (slots 8 row .. 8 row + 7) against the
// ray, in slot order, reported as leaf * 8 + j.
SRT_HD void mt_leaf(const float* __restrict__ mt, int64_t row, int64_t leaf,
                    const Ray& r, float& tb, HitOut& h) {
  const float* m = mt + row * 72;
  float bound = tie_bound(tb, leaf * 8, h);
  SRT_UNROLL
  for (int g = 0; g < 8; g += 4, m += 36) {
    float c[36];
    SRT_UNROLL
    for (int q = 0; q < 9; q++) {
      const F4 v = ld4(m + 4 * q);
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
    SRT_UNROLL
    for (int s = 0; s < 4; s++) {
      const float* e = c + 9 * s;
      mt_slot(e[0], e[1], e[2], e[3], e[4], e[5], e[6], e[7], e[8], r,
              (int32_t)(leaf * 8 + g + s), tb, bound, h);
    }
  }
}

// MT mode: leaf l tests its own row.
struct MtLeaf {
  const float* mt;
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    mt_leaf(mt, leaf, leaf, r, tb, h);
  }
};

// itf mode: leaf l tests the row of its shared leaf with the ray mapped
// into its instance's space.
struct InstancedMtLeaf {
  const float* mt;
  const int32_t* leaf_slot;
  const float* leaf_xf;
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    // M = (a.x a.y a.z / a.w b.x b.y / b.z b.w c.x), t = (c.y c.z c.w)
    const float* im = leaf_xf + leaf * 12;
    const F4 a = ld4(im);
    const F4 b = ld4(im + 4);
    const F4 c = ld4(im + 8);
    const Ray li{a.x * r.ox + a.y * r.oy + a.z * r.oz + c.y,
                 a.w * r.ox + b.x * r.oy + b.y * r.oz + c.z,
                 b.z * r.ox + b.w * r.oy + c.x * r.oz + c.w,
                 a.x * r.dx + a.y * r.dy + a.z * r.dz,
                 a.w * r.dx + b.x * r.dy + b.y * r.dz,
                 b.z * r.dx + b.w * r.dy + c.x * r.dz};
    mt_leaf(mt, (int64_t)leaf_slot[leaf], leaf, li, tb, h);
  }
};

// The walk of traverse5 with leaf test `leaf` (MtLeaf or
// InstancedMtLeaf).
template <class Leaf, class Stack>
SRT_HD HitOut trace5(const float* __restrict__ nodes,
                     const int32_t* __restrict__ child_ids,
                     const Leaf& leaf, int32_t ni, const Ray& r,
                     bool active, float t_init, Stack& st,
                     WalkCounts* counts = nullptr) {
  return walk_regs(nodes, TableChildren{child_ids}, ni, r, active, t_init,
                   leaf, st, counts);
}

}  // namespace srt
