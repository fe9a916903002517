// Moller-Trumbore leaf test for the BVH8 walk (bvh8_walk.cuh), with an
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
// Without leaf_slot/leaf_xf (MT mode), leaf l tests its own slots
// mt[8l .. 8l+7]. Either way the reported tri is l*8 + j.
//
// Every expression is summed in the order of the JAX package's kernel
// (traverse_pallas5.py:270-318) and of ops/traverse5.py; built without
// FMA contraction, the three agree bit for bit.

#pragma once

#include "bvh8_walk.cuh"

namespace srt {

constexpr float kDetEps = 1e-12f;

// One triangle (v0, e1, e2) against the ray: on a hit strictly closer
// than tb, lowers tb and records (tb, id, u, v).
SRT_HD void mt_slot(float v0x, float v0y, float v0z, float e1x, float e1y,
                    float e1z, float e2x, float e2y, float e2z,
                    const Ray& r, int32_t id, float& tb, HitOut& h) {
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
      tt > kTnear && tt < tb) {
    tb = tt;
    h.tri = id;
    h.u = uu;
    h.v = vv;
  }
}

SRT_HD void mt_leaf(const float* __restrict__ mt, int64_t slot_row,
                    int64_t leaf, const Ray& r, float& tb, HitOut& h) {
  const float* m = mt + slot_row * 8 * 9;
  for (int s = 0; s < 8; s++, m += 9) {
    mt_slot(m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], r,
            (int32_t)(leaf * 8 + s), tb, h);
  }
}

struct MtLeaf {
  const float* mt;
  const int32_t* leaf_slot;  // null in MT mode
  const float* leaf_xf;      // null in MT mode
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    if (leaf_slot == nullptr) {
      mt_leaf(mt, leaf, leaf, r, tb, h);
      return;
    }
    const float* im = leaf_xf + leaf * 12;
    const Ray li{im[0] * r.ox + im[1] * r.oy + im[2] * r.oz + im[9],
                 im[3] * r.ox + im[4] * r.oy + im[5] * r.oz + im[10],
                 im[6] * r.ox + im[7] * r.oy + im[8] * r.oz + im[11],
                 im[0] * r.dx + im[1] * r.dy + im[2] * r.dz,
                 im[3] * r.dx + im[4] * r.dy + im[5] * r.dz,
                 im[6] * r.dx + im[7] * r.dy + im[8] * r.dz};
    mt_leaf(mt, (int64_t)leaf_slot[leaf], leaf, li, tb, h);
  }
};

SRT_HD HitOut trace5(const float* __restrict__ nodes,
                     const int32_t* __restrict__ child_ids,
                     const float* __restrict__ mt,
                     const int32_t* __restrict__ leaf_slot,
                     const float* __restrict__ leaf_xf, int32_t ni,
                     float ox, float oy, float oz,
                     float dx, float dy, float dz,
                     bool active, float t_init,
                     WalkCounts* counts = nullptr) {
  const Ray r{ox, oy, oz, dx, dy, dz};
  return walk(nodes, TableChildren{child_ids}, ni, r, active, t_init,
              MtLeaf{mt, leaf_slot, leaf_xf}, counts);
}

}  // namespace srt
