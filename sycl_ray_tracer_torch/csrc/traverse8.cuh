// Woop leaf test for the BVH8 walk (bvh8_walk.cuh): the per-ray function
// of the traverse8 kernel.
//
// Leaf table (models/scene.py):
//   woop [L*8, 12] f32 per triangle slot: M row-major (3x3), then the
//        translation tr (3). Dead and padding slots hold M = 0,
//        tr = (0, 0, -1e30), which can never hit (-1/0 = -inf and
//        0*inf = NaN: no fast math).

#pragma once

#include "bvh8_walk.cuh"

namespace srt {

SRT_HD void woop_leaf(const float* __restrict__ woop, int64_t leaf,
                      const Ray& r, float& tb, HitOut& h) {
  const float* w = woop + leaf * 8 * 12;
  for (int s = 0; s < 8; s++, w += 12) {
    const float opx = w[0] * r.ox + w[1] * r.oy + w[2] * r.oz + w[9];
    const float opy = w[3] * r.ox + w[4] * r.oy + w[5] * r.oz + w[10];
    const float opz = w[6] * r.ox + w[7] * r.oy + w[8] * r.oz + w[11];
    const float dpx = w[0] * r.dx + w[1] * r.dy + w[2] * r.dz;
    const float dpy = w[3] * r.dx + w[4] * r.dy + w[5] * r.dz;
    const float dpz = w[6] * r.dx + w[7] * r.dy + w[8] * r.dz;
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

struct WoopLeaf {
  const float* woop;
  SRT_HD void operator()(int64_t leaf, const Ray& r, float& tb,
                         HitOut& h) const {
    woop_leaf(woop, leaf, r, tb, h);
  }
};

SRT_HD HitOut trace8(const float* __restrict__ nodes,
                     const int32_t* __restrict__ child_ids,
                     const float* __restrict__ woop, int32_t ni,
                     float ox, float oy, float oz,
                     float dx, float dy, float dz,
                     bool active, float t_init,
                     WalkCounts* counts = nullptr) {
  const Ray r{ox, oy, oz, dx, dy, dz};
  return walk(nodes, TableChildren{child_ids}, ni, r, active, t_init,
              WoopLeaf{woop}, counts);
}

}  // namespace srt
