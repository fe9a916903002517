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
