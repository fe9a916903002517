// Types, constants and child-id sources shared by the per-ray
// closest-hit walk of a BVH8 (walk_regs.cuh), which every kernel runs
// (traverse8.cu, traverse5.cu and traverse1.cu, built by nvcc for
// sm_90a) and which the tests build for the CPU (walk_host.cpp, g++),
// so the walk the card runs is the code the CPU tests check.
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
//     tmin <= t_best, with inverse direction 1/d where |d| > 1e-20 and
//     1e20 otherwise;
//   - the closest hit is the least (t, id) pair: of two hits at a
//     bit-equal t the lower id (leaf_row*K + j) wins, whatever order
//     the walk meets them in. So a child box is entered, and a popped
//     node walked, while its entry distance is at most t_best (not only
//     below it), and a leaf's hit replaces the incumbent when it is
//     closer, or as close with a lower id (tie_bound() below). The tie
//     rule makes every walk of one tree, the kernels' depth-first walk
//     and the plain level-by-level one (ops/walk.py), pick the same
//     triangle where faces coincide, as the coplanar faces of voxels
//     and of coincident blocks do. One case is left to the order:
//     where a box's slab entry rounds above a hit inside it, a walk
//     that already holds an equal-t hit skips the box (on minecraft_proc
//     1 of 1M primary and 4 of 1M first-bounce rays, each at a
//     bit-equal t);
//   - leaves are tested as soon as their box is entered.
//
// No fast math: dead slots rely on IEEE inf/NaN.

#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#else
#define SRT_HD inline
#endif

// Per-thread stack depth. The walk pops one node and pushes at most 8
// internal children, so a tree of depth D needs at most 7*D + 1
// entries: 128 covers depth 18. models/scene.py and models/instanced.py
// refuse trees deeper than that allows. The stack lives in local
// memory and is touched only as deep as a ray goes.
#define SRT_STACK 128

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

// The next float above x, for x positive and finite.
SRT_HD float next_up(float x) {
#ifdef __CUDA_ARCH__
  return __int_as_float(__float_as_int(x) + 1);
#else
  int32_t i;
  memcpy(&i, &x, sizeof i);
  i += 1;
  memcpy(&x, &i, sizeof x);
  return x;
#endif
}

// The tie rule in a leaf's slot tests: a slot hit replaces the
// incumbent (tb, h.tri) when its t is below the leaf's bound, which is
// tb, or the next float above it where the leaf's ids lie below
// h.tri, so that a hit as close as the incumbent wins there too. A leaf
// is tested once a ray, so its ids lie all below or all above h.tri;
// a slot that wins lowers the bound to its t, as the later slots of the
// leaf have higher ids. With no incumbent (h.tri = -1, tb = t_init) the
// bound is t_init. One compare a leaf, where an id compare a slot cost
// traverse8 5 % of its time.
SRT_HD float tie_bound(float tb, int64_t first_id, const HitOut& h) {
  return first_id < h.tri ? next_up(tb) : tb;
}

// Work of one walk: child boxes slab-tested and leaves tested. Only the
// host build counts (chip_smoke.py's bound); the kernels pass null, and
// the counting folds away.
struct WalkCounts {
  int64_t boxes;
  int64_t leaves;
};

struct TableChildren {
  const int32_t* ids;  // [NI, 8]
};

struct HeapChildren {
  int32_t end;  // NI + rows of the leaf table; 8 * NI + 8 fits int32 up
                // to depth 9, the deepest tree the stack allows
  SRT_HD int32_t operator()(int32_t nd, int j) const {
    const int32_t c = 8 * nd + 1 + j;
    return c < end ? c : 0;
  }
};

}  // namespace srt
