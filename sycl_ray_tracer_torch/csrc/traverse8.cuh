// Woop leaf test for the BVH8 walk (walk_regs.cuh): the per-ray function
// of the traverse8 kernel.
//
// Leaf table (models/scene.py):
//   woop [L*8, 12] f32 per triangle slot: M row-major (3x3), then the
//        translation tr (3). Dead and padding slots hold M = 0,
//        tr = (0, 0, -1e30), which can never hit (-1/0 = -inf and
//        0*inf = NaN: no fast math).
// A slot is 48 bytes, read as three 16-byte loads.

#pragma once

#include "walk_regs.cuh"

namespace srt {

// -1/x, correctly rounded: on the card the round-to-nearest reciprocal
// (one instruction sequence, no division), on the host the division.
// Both give the bits of IEEE -1.0f / x.
SRT_HD float neg_rcp(float x) {
#ifdef __CUDA_ARCH__
  return -__frcp_rn(x);
#else
  return -1.0f / x;
#endif
}

SRT_HD void woop_leaf(const float* __restrict__ woop, int64_t leaf,
                      const Ray& r, float& tb, HitOut& h) {
  const float* w = woop + leaf * 8 * 12;
  float bound = tie_bound(tb, leaf * 8, h);
  SRT_UNROLL
  for (int s = 0; s < 8; s++, w += 12) {
    // M = (a.x a.y a.z / a.w b.x b.y / b.z b.w c.x), tr = (c.y c.z c.w)
    const F4 a = ld4(w);
    const F4 b = ld4(w + 4);
    const F4 c = ld4(w + 8);
    const float opx = a.x * r.ox + a.y * r.oy + a.z * r.oz + c.y;
    const float opy = a.w * r.ox + b.x * r.oy + b.y * r.oz + c.z;
    const float opz = b.z * r.ox + b.w * r.oy + c.x * r.oz + c.w;
    const float dpx = a.x * r.dx + a.y * r.dy + a.z * r.dz;
    const float dpy = a.w * r.dx + b.x * r.dy + b.y * r.dz;
    const float dpz = b.z * r.dx + b.w * r.dy + c.x * r.dz;
    const float tt = opz * neg_rcp(dpz);
    const float uu = opx + tt * dpx;
    const float vv = opy + tt * dpy;
    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTnear &&
        tt < bound) {
      tb = tt;
      bound = tt;
      h.tri = (int32_t)(leaf * 8 + s);
      h.u = uu;
      h.v = vv;
    }
  }
}

struct WoopLeaf {
  const float* woop;
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    woop_leaf(woop, leaf, r, tb, h);
  }
};

template <class Stack>
SRT_HD HitOut trace8(const float* __restrict__ nodes,
                     const int32_t* __restrict__ child_ids,
                     const float* __restrict__ woop, int32_t ni,
                     const Ray& r, bool active, float t_init, Stack& st,
                     WalkCounts* counts = nullptr) {
  return walk_regs(nodes, TableChildren{child_ids}, ni, r, active, t_init,
                   WoopLeaf{woop}, st, counts);
}

}  // namespace srt
