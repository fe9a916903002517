// Per-ray closest-hit walk of a BVH8, generic over where the child ids
// come from and over the leaf test, and the types of every walk.
//
// `walk` is the walk of the traverse5 kernel (traverse5.cu, built by
// nvcc for sm_90a) and of its host build (walk_host.cpp, built by g++
// in the tests), so the walk the card runs is the code the CPU tests
// check. traverse8 and traverse1 run walk_regs.cuh, which computes the
// same function in the same order with its per-node state in
// registers.
//
// Node tables (models/scene.py):
//   nodes     [NI, 48] f32: child boxes component-major, 8 lanes each of
//             lo.x, lo.y, lo.z, hi.x, hi.y, hi.z
// Child ids, from one of two sources (an id of 0 is an empty slot: the
// root is never a child):
//   TableChildren: child_ids [NI, 8] i32 (SAH and instanced trees):
//             internal child = row, leaf child = NI + leaf row, empty
//             slot = 0 with a point-at-infinity box;
//   HeapChildren: the implicit Morton heap (ops/wbvh.py), child j of node
//             n is 8n + 1 + j, computed; leaf children past the leaf
//             table (the heap's padding) are empty.
//
// Semantics (those of the JAX package's traverse_packets8/5/1):
//   - active rays report the closest hit with TNEAR < t < t_init as
//     (t, leaf_row*K + j, u, v) for K-slot leaves; with no such hit,
//     tri = -1, t = t_init and u = v = 0;
//   - inactive rays report t = 0, tri = -1, u = v = 0;
//   - a child box is entered when tmax >= max(tmin, TNEAR) and
//     tmin < t_best, with inverse direction 1/d where |d| > 1e-20 and
//     1e20 otherwise;
//   - leaves are tested as soon as their box is entered; the leaf test
//     lowers t_best only on a strictly closer hit, so within a leaf the
//     lowest slot wins an exact t tie.
//
// No fast math: dead slots rely on IEEE inf/NaN.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#else
#define SRT_HD inline
#endif

// Per-thread stack depth. The walk pops one node and pushes at most 8
// internal children, so a tree of depth D needs at most 7*D + 1
// entries; models/scene.py and models/instanced.py refuse trees deeper
// than that allows.
#define SRT_STACK 64

namespace srt {

constexpr float kTnear = 1e-4f;
constexpr float kBig = 3.0e38f;

SRT_HD float fmin_(float a, float b) { return a < b ? a : b; }
SRT_HD float fmax_(float a, float b) { return a > b ? a : b; }

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
};

struct HitOut {
  float t;
  int32_t tri;
  float u;
  float v;
};

// Work of one walk: child boxes slab-tested and leaves tested. Only the
// host build counts (chip_smoke.py's bound); the kernels pass null, and
// the counting folds away.
struct WalkCounts {
  int64_t boxes;
  int64_t leaves;
};

struct TableChildren {
  const int32_t* ids;  // [NI, 8]
  SRT_HD int32_t operator()(int32_t nd, int j) const {
    return ids[(int64_t)nd * 8 + j];
  }
};

struct HeapChildren {
  int32_t end;  // NI + rows of the leaf table; 8 * NI + 8 fits int32 up
                // to depth 9, the deepest tree the stack allows
  SRT_HD int32_t operator()(int32_t nd, int j) const {
    const int32_t c = 8 * nd + 1 + j;
    return c < end ? c : 0;
  }
};

// `kids(node, j)` gives the id of child j (0: empty slot);
// `leaf(leaf_row, ray, t_best, hit)` tests the slots of one leaf and,
// on a strictly closer hit, lowers t_best and records the hit.
template <class Children, class Leaf>
SRT_HD HitOut walk(const float* __restrict__ nodes, const Children& kids,
                   int32_t ni, const Ray& r, bool active, float t_init,
                   const Leaf& leaf, WalkCounts* counts = nullptr) {
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

  int32_t stack[SRT_STACK];
  float stack_t[SRT_STACK];
  int sp = 0;
  stack[sp] = 0;
  stack_t[sp] = -kBig;
  sp++;

  while (sp > 0) {
    sp--;
    const int32_t nd = stack[sp];
    // a node whose entry lies beyond the best hit found since it was
    // pushed cannot hold a closer hit: the same test as at push time
    if (!(stack_t[sp] < tb)) continue;
    const float* row = nodes + (int64_t)nd * 48;

    int32_t push_id[8];
    float push_t[8];
    int n_push = 0;
    for (int j = 0; j < 8; j++) {
      const int32_t c = kids(nd, j);
      if (c == 0) continue;  // empty slot
      if (counts != nullptr) counts->boxes++;
      const float t1x = (row[j] - r.ox) * ix;
      const float t1y = (row[8 + j] - r.oy) * iy;
      const float t1z = (row[16 + j] - r.oz) * iz;
      const float t2x = (row[24 + j] - r.ox) * ix;
      const float t2y = (row[32 + j] - r.oy) * iy;
      const float t2z = (row[40 + j] - r.oz) * iz;
      const float tmin = fmax_(fmax_(fmin_(t1x, t2x), fmin_(t1y, t2y)),
                               fmin_(t1z, t2z));
      const float tmax = fmin_(fmin_(fmax_(t1x, t2x), fmax_(t1y, t2y)),
                               fmax_(t1z, t2z));
      if (!(tmax >= fmax_(tmin, kTnear) && tmin < tb)) continue;
      if (c < ni) {
        // insertion by entry distance, farthest first: the nearest
        // child ends on top of the stack
        int k = n_push;
        while (k > 0 && push_t[k - 1] < tmin) {
          push_t[k] = push_t[k - 1];
          push_id[k] = push_id[k - 1];
          k--;
        }
        push_t[k] = tmin;
        push_id[k] = c;
        n_push++;
        continue;
      }
      if (counts != nullptr) counts->leaves++;
      leaf((int64_t)(c - ni), r, tb, h);
    }
    for (int k = 0; k < n_push; k++) {
      stack[sp] = push_id[k];
      stack_t[sp] = push_t[k];
      sp++;
    }
  }
  h.t = tb;
  return h;
}

}  // namespace srt
