// Per-ray closest-hit walk of a BVH8 whose per-node state lives in
// registers: the walk of the traverse8, traverse5 and traverse1 kernels
// (and of their host builds in walk_host.cpp), generic over where the
// child ids come from (bvh8_walk.cuh) and over the leaf test. For each
// ray it
//   - pops a node and skips it unless its entry distance is at most
//     t_best (the test made when it was pushed, against the t_best of
//     now: a node at t_best may still hold a hit at t_best with a lower
//     id, bvh8_walk.cuh);
//   - slab-tests the node's non-empty child slots j = 0..7 in slot
//     order, each against the t_best of that moment;
//   - tests a leaf as soon as its box is entered;
//   - pushes the entered internal children nearest first: the nearest
//     ends on top, and of two at the same entry distance the higher
//     slot ends on top.
// This order is what the tests pin (the child boxes and leaves each
// walk tests on fixed rays), so the hits, tie ids included, do not
// depend on how the card carries it out:
//   - the node's 8 child boxes are read as 12 16-byte loads and its 8
//     child ids as 2 (ld4: the wrappers check that every table is
//     16-byte aligned), and the slab distances of all 8 children are
//     computed into registers before the in-order pass (slab8);
//   - the in-order pass is a loop over the entered leaves only: child
//     j's acceptance depends on t_best after the leaves before it, and
//     t_best only falls, so after each leaf test the children above it
//     are tested again (below); lanes of a warp whose leaves sit in
//     different slots run their leaf tests together;
//   - the push order is computed from an 8-bit mask with compile-time
//     indices (push_near_first), with no runtime-indexed buffer;
//   - the stack is a template parameter; both builds pass ArrayStack,
//     a plain array, which on the card lives in local memory (cached in
//     L1: a stack in shared memory measured slower, since it takes L1
//     from the node fetches).

#pragma once

#include "bvh8_walk.cuh"

#ifdef __CUDACC__
#define SRT_UNROLL _Pragma("unroll")
#else
#define SRT_UNROLL
#endif

namespace srt {

struct F4 {
  float x, y, z, w;
};

struct I4 {
  int32_t x, y, z, w;
};

// 16-byte read-only loads; p must be 16-byte aligned.
SRT_HD F4 ld4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return F4{v.x, v.y, v.z, v.w};
#else
  return F4{p[0], p[1], p[2], p[3]};
#endif
}

SRT_HD I4 ld4(const int32_t* p) {
#ifdef __CUDA_ARCH__
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return I4{v.x, v.y, v.z, v.w};
#else
  return I4{p[0], p[1], p[2], p[3]};
#endif
}

// Component j of v (j a compile-time constant after unrolling).
SRT_HD float part(const F4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

SRT_HD int popc8(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

SRT_HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The eight child ids of node nd, from a table or from the heap's rule.
SRT_HD void child_row(const TableChildren& kids, int32_t nd,
                      int32_t id[8]) {
  const I4 a = ld4(kids.ids + (int64_t)nd * 8);
  const I4 b = ld4(kids.ids + (int64_t)nd * 8 + 4);
  id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
  id[4] = b.x; id[5] = b.y; id[6] = b.z; id[7] = b.w;
}

SRT_HD void child_row(const HeapChildren& kids, int32_t nd, int32_t id[8]) {
  SRT_UNROLL
  for (int j = 0; j < 8; j++) id[j] = kids(nd, j);
}

// Slab test of the 8 child boxes of one node row (bvh8_walk.cuh
// layout), with the expressions of ops/walk.py: tmin[j] is child j's
// entry distance, and bit j of the result says tmax >= max(tmin,
// TNEAR). A child is entered when its bit is set and tmin[j] <= t_best.
SRT_HD uint32_t slab8(const float* __restrict__ row, const Ray& r,
                      float ix, float iy, float iz, float tmin[8]) {
  float b[48];
  SRT_UNROLL
  for (int q = 0; q < 12; q++) {
    const F4 v = ld4(row + 4 * q);
    b[4 * q] = v.x;
    b[4 * q + 1] = v.y;
    b[4 * q + 2] = v.z;
    b[4 * q + 3] = v.w;
  }
  uint32_t ok = 0;
  SRT_UNROLL
  for (int j = 0; j < 8; j++) {
    const float t1x = (b[j] - r.ox) * ix;
    const float t1y = (b[8 + j] - r.oy) * iy;
    const float t1z = (b[16 + j] - r.oz) * iz;
    const float t2x = (b[24 + j] - r.ox) * ix;
    const float t2y = (b[32 + j] - r.oy) * iy;
    const float t2z = (b[40 + j] - r.oz) * iz;
    tmin[j] = fmax_(fmax_(fmin_(t1x, t2x), fmin_(t1y, t2y)),
                    fmin_(t1z, t2z));
    const float tmax = fmin_(fmin_(fmax_(t1x, t2x), fmax_(t1y, t2y)),
                             fmax_(t1z, t2z));
    ok |= (uint32_t)(tmax >= fmax_(tmin[j], kTnear)) << j;
  }
  return ok;
}

// Bit j set where tmin[j] <= tb: a child at exactly tb may still hold a
// hit at tb with a lower id (the tie rule, bvh8_walk.cuh).
SRT_HD uint32_t below(const float tmin[8], float tb) {
  uint32_t m = 0;
  SRT_UNROLL
  for (int j = 0; j < 8; j++) m |= (uint32_t)(tmin[j] <= tb) << j;
  return m;
}

SRT_HD int32_t pick(const int32_t id[8], int j) {
  int32_t c = id[0];
  SRT_UNROLL
  for (int k = 1; k < 8; k++) c = j == k ? id[k] : c;
  return c;
}

SRT_HD float pick(const float v[8], int j) {
  float c = v[0];
  SRT_UNROLL
  for (int k = 1; k < 8; k++) c = j == k ? v[k] : c;
  return c;
}

// Pushes the children of mask m farthest first, so that the nearest
// ends on top and, at equal entry distance, the higher slot (the order
// a stable insertion sort by entry distance, farthest first, leaves).
// Child j goes to sp + rank, where rank counts the children pushed
// below it. Returns the new sp.
template <class Stack>
SRT_HD int push_near_first(Stack& st, int sp, uint32_t m,
                           const int32_t id[8], const float tmin[8]) {
  if (m == 0) return sp;
  if ((m & (m - 1)) == 0) {  // one child, the common case
    const int j = lowest_bit(m);
    st.put(sp, pick(id, j), pick(tmin, j));
    return sp + 1;
  }
  SRT_UNROLL
  for (int j = 0; j < 8; j++) {
    if (!(m >> j & 1u)) continue;
    int rank = 0;
    SRT_UNROLL
    for (int i = 0; i < 8; i++) {
      if (i == j) continue;
      const bool under = i < j ? tmin[i] >= tmin[j] : tmin[i] > tmin[j];
      rank += (int)((m >> i & 1u) && under);
    }
    st.put(sp + rank, id[j], tmin[j]);
  }
  return sp + popc8(m);
}

// A ray's stack: SRT_STACK entries in a plain array (on the card, in
// local memory).
struct ArrayStack {
  int32_t id[SRT_STACK];
  float t[SRT_STACK];
  SRT_HD void put(int k, int32_t n, float tt) {
    id[k] = n;
    t[k] = tt;
  }
  SRT_HD void get(int k, int32_t& n, float& tt) const {
    n = id[k];
    tt = t[k];
  }
};

// `kids` gives the child ids (TableChildren or HeapChildren); `leaf`
// (leaf_row, ray, t_best, hit) tests the slots of one leaf and, on a
// closer hit by the tie rule (tie_bound()), sets t_best and records the
// hit; `st` is the stack (put/get of entry k).
template <class Children, class Leaf, class Stack>
SRT_HD HitOut walk_regs(const float* __restrict__ nodes,
                        const Children& kids, int32_t ni, const Ray& r,
                        bool active, float t_init, const Leaf& leaf,
                        Stack& st, WalkCounts* counts = nullptr) {
  HitOut h;
  h.tri = -1;
  h.u = 0.0f;
  h.v = 0.0f;
  if (!active) {
    h.t = 0.0f;
    return h;
  }
  float tb = t_init;
  const float ix = (r.dx > 1e-20f || r.dx < -1e-20f) ? 1.0f / r.dx : 1e20f;
  const float iy = (r.dy > 1e-20f || r.dy < -1e-20f) ? 1.0f / r.dy : 1e20f;
  const float iz = (r.dz > 1e-20f || r.dz < -1e-20f) ? 1.0f / r.dz : 1e20f;

  st.put(0, 0, -kBig);
  int sp = 1;
  while (sp > 0) {
    sp--;
    int32_t nd;
    float t_entry;
    st.get(sp, nd, t_entry);
    if (!(t_entry <= tb)) continue;

    float tmin[8];
    const uint32_t geo = slab8(nodes + (int64_t)nd * 48, r, ix, iy, iz,
                               tmin);
    int32_t id[8];
    child_row(kids, nd, id);
    uint32_t full = 0, is_leaf = 0;
    SRT_UNROLL
    for (int j = 0; j < 8; j++) {
      full |= (uint32_t)(id[j] != 0) << j;
      is_leaf |= (uint32_t)(id[j] >= ni) << j;
    }
    if (counts != nullptr) counts->boxes += popc8(full);

    // entered children, decided in slot order: a leaf test may lower
    // tb, and then the slots above it are tested again
    uint32_t entered = geo & full & below(tmin, tb);
    uint32_t leaves = entered & is_leaf;
    while (leaves != 0) {
      const int j = lowest_bit(leaves);
      if (counts != nullptr) counts->leaves++;
      leaf((int64_t)(pick(id, j) - ni), r, tb, h);
      const uint32_t above = (0xFEu << j) & 0xFFu;
      entered &= ~above | below(tmin, tb);
      leaves = entered & is_leaf & above;
    }
    sp = push_near_first(st, sp, entered & ~is_leaf, id, tmin);
  }
  h.t = tb;
  return h;
}

}  // namespace srt
