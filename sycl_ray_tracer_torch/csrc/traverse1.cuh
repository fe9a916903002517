// K-slot Moller-Trumbore leaf test for the walk of the implicit Morton
// heap (walk_regs.cuh with HeapChildren): the per-ray function of the
// traverse1 kernel.
//
// Tables (ops/wbvh.py:build_np, models/scene.py):
//   children [NI, 48] f32: the heap's child boxes (bvh8_walk.cuh layout)
//   leaves   [rows, 9K] f32: the real leaves only, component-major:
//            component c (v0.xyz, e1.xyz, e2.xyz) of slot j at c*K + j;
//            padding slots are zero and never hit (det = 0)
// Leaf l reports tri = l*K + j, a canonical Morton slot: no remap.
// The heap leaves past the table have no row; HeapChildren makes them
// empty slots, so the walk never reads past the table.
//
// Each slot runs mt_slot (traverse5.cuh), whose expressions follow the
// order of the JAX package's kernel (traverse_pallas.py:126-143) and of
// ops/traverse1.py; built without FMA contraction, the three agree bit
// for bit. Where K is a multiple of 4 (a row of 36K bytes, so every
// component group is 16-byte aligned), four slots at a time come from
// nine 16-byte loads; other K read each value alone, with the same
// slots tested in the same order.

#pragma once

#include "traverse5.cuh"
#include "walk_regs.cuh"

namespace srt {

struct HeapLeaf {
  const float* leaves;
  int32_t k;
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    const float* row = leaves + leaf * 9 * k;
    float bound = tie_bound(tb, leaf * k, h);
    if ((k & 3) == 0) {
      for (int g = 0; g < k; g += 4) {
        F4 c[9];
        SRT_UNROLL
        for (int q = 0; q < 9; q++) c[q] = ld4(row + q * k + g);
        SRT_UNROLL
        for (int j = 0; j < 4; j++) {
          mt_slot(part(c[0], j), part(c[1], j), part(c[2], j),
                  part(c[3], j), part(c[4], j), part(c[5], j),
                  part(c[6], j), part(c[7], j), part(c[8], j), r,
                  (int32_t)(leaf * k + g + j), tb, bound, h);
        }
      }
      return;
    }
    for (int j = 0; j < k; j++) {
      const float* c = row + j;
      mt_slot(c[0], c[k], c[2 * k], c[3 * k], c[4 * k], c[5 * k],
              c[6 * k], c[7 * k], c[8 * k], r, (int32_t)(leaf * k + j),
              tb, bound, h);
    }
  }
};

template <class Stack>
SRT_HD HitOut trace1(const float* __restrict__ children,
                     const float* __restrict__ leaves, int32_t ni,
                     int32_t k, int32_t rows, const Ray& r, bool active,
                     float t_init, Stack& st, WalkCounts* counts = nullptr) {
  return walk_regs(children, HeapChildren{ni + rows}, ni, r, active,
                   t_init, HeapLeaf{leaves, k}, st, counts);
}

}  // namespace srt
