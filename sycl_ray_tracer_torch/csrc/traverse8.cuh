// Per-ray closest-hit walk of the SAH BVH8 with Woop leaf tests.
//
// Shared by the CUDA kernel (traverse8.cu, built by nvcc for sm_90a)
// and the host build (traverse8_host.cpp, built by g++ in the tests),
// so the walk the card runs is the code the CPU tests check.
//
// Tables (models/scene.py):
//   nodes     [NI, 48] f32: child boxes component-major, 8 lanes each of
//             lo.x, lo.y, lo.z, hi.x, hi.y, hi.z
//   child_ids [NI, 8] i32: internal child = row, leaf child = NI + leaf
//             row, empty slot = 0 (the root, never a real child) with a
//             point-at-infinity box
//   woop      [L*8, 12] f32 per triangle slot: M row-major (3x3), then
//             the translation tr (3). Dead and padding slots hold
//             M = 0, tr = (0, 0, -1e30), which can never hit.
//
// Semantics (those of the JAX package's traverse_packets8):
//   - active rays report the closest hit with TNEAR < t < t_init as
//     (t, leaf_row*8 + j, u, v); with no such hit, tri = -1, t = t_init
//     and u = v = 0;
//   - inactive rays report t = 0, tri = -1, u = v = 0;
//   - a child box is entered when tmax >= max(tmin, TNEAR) and
//     tmin < t_best, with inverse direction 1/d where |d| > 1e-20 and
//     1e20 otherwise;
//   - within a leaf the lowest slot wins an exact t tie (strict <).
//
// No fast math: dead slots rely on IEEE -1/0 = -inf and 0*inf = NaN.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SRT_HD __host__ __device__ __forceinline__
#else
#define SRT_HD inline
#endif

// Per-thread stack depth. The walk pops one node and pushes at most 8
// internal children, so a tree of depth D needs at most 7*D + 1
// entries; models/scene.py refuses trees deeper than that allows.
#define SRT_STACK 64

namespace srt {

constexpr float kTnear = 1e-4f;
constexpr float kBig = 3.0e38f;

SRT_HD float fmin_(float a, float b) { return a < b ? a : b; }
SRT_HD float fmax_(float a, float b) { return a > b ? a : b; }

struct HitOut {
  float t;
  int32_t tri;
  float u;
  float v;
};

SRT_HD HitOut trace8(const float* __restrict__ nodes,
                     const int32_t* __restrict__ child_ids,
                     const float* __restrict__ woop, int32_t ni,
                     float ox, float oy, float oz,
                     float dx, float dy, float dz,
                     bool active, float t_init) {
  HitOut h;
  h.tri = -1;
  h.u = 0.0f;
  h.v = 0.0f;
  if (!active) {
    h.t = 0.0f;
    return h;
  }
  float tb = t_init;
  const float ix = (dx > 1e-20f || dx < -1e-20f) ? 1.0f / dx : 1e20f;
  const float iy = (dy > 1e-20f || dy < -1e-20f) ? 1.0f / dy : 1e20f;
  const float iz = (dz > 1e-20f || dz < -1e-20f) ? 1.0f / dz : 1e20f;

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
    const int32_t* ids = child_ids + (int64_t)nd * 8;

    int32_t push_id[8];
    float push_t[8];
    int n_push = 0;
    for (int j = 0; j < 8; j++) {
      const int32_t c = ids[j];
      if (c == 0) continue;  // empty slot
      const float t1x = (row[j] - ox) * ix;
      const float t1y = (row[8 + j] - oy) * iy;
      const float t1z = (row[16 + j] - oz) * iz;
      const float t2x = (row[24 + j] - ox) * ix;
      const float t2y = (row[32 + j] - oy) * iy;
      const float t2z = (row[40 + j] - oz) * iz;
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
      // leaf child: Woop-test its 8 slots now
      const int64_t leaf = (int64_t)(c - ni);
      const float* w = woop + leaf * 8 * 12;
      for (int s = 0; s < 8; s++, w += 12) {
        const float opx = w[0] * ox + w[1] * oy + w[2] * oz + w[9];
        const float opy = w[3] * ox + w[4] * oy + w[5] * oz + w[10];
        const float opz = w[6] * ox + w[7] * oy + w[8] * oz + w[11];
        const float dpx = w[0] * dx + w[1] * dy + w[2] * dz;
        const float dpy = w[3] * dx + w[4] * dy + w[5] * dz;
        const float dpz = w[6] * dx + w[7] * dy + w[8] * dz;
        const float tt = opz * (-1.0f / dpz);
        const float uu = opx + tt * dpx;
        const float vv = opy + tt * dpy;
        if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTnear &&
            tt < tb) {
          tb = tt;
          h.tri = (int32_t)(leaf * 8 + s);
          h.u = uu;
          h.v = vv;
        }
      }
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
