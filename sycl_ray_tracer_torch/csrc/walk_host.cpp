// Host build of the per-ray walks in traverse8.cuh, traverse5.cuh and
// traverse1.cuh: the same functions the CUDA kernels run per thread,
// looped over rays on the CPU. The tests build this file with g++ and
// hold it against the plain torch versions (ops/traverse8.py
// traverse8_plain, ops/traverse5.py traverse5_plain, ops/traverse1.py
// traverse1_plain), since no CUDA compiler runs there.
// `counts` (null, or int64 [2]) adds up the child boxes slab-tested and
// the leaves tested over all rays: the work chip_smoke.py's bound counts.

#include "traverse1.cuh"
#include "traverse5.cuh"
#include "traverse8.cuh"

extern "C" void srt_traverse8_host(const float* nodes,
                                   const int32_t* child_ids,
                                   const float* woop, int32_t ni,
                                   const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const uint8_t* active,
                                   const float* t_init, float* t_out,
                                   int32_t* tri_out, float* u_out,
                                   float* v_out, int64_t n_rays,
                                   int64_t* counts) {
  srt::WalkCounts wc{0, 0};
  srt::ArrayStack st;
  for (int64_t i = 0; i < n_rays; i++) {
    const bool act = active == nullptr || active[i] != 0;
    const float t0 = t_init == nullptr ? srt::kBig : t_init[i];
    const srt::HitOut h = srt::trace8(
        nodes, child_ids, woop, ni,
        srt::Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]}, act, t0, st,
        &wc);
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
  if (counts != nullptr) {
    counts[0] += wc.boxes;
    counts[1] += wc.leaves;
  }
}

template <class Leaf>
static void traverse5_host(const float* nodes, const int32_t* child_ids,
                           const Leaf& leaf, int32_t ni, const float* ox,
                           const float* oy, const float* oz,
                           const float* dx, const float* dy,
                           const float* dz, const uint8_t* active,
                           const float* t_init, float* t_out,
                           int32_t* tri_out, float* u_out, float* v_out,
                           int64_t n_rays, srt::WalkCounts* wc) {
  srt::ArrayStack st;
  for (int64_t i = 0; i < n_rays; i++) {
    const bool act = active == nullptr || active[i] != 0;
    const float t0 = t_init == nullptr ? srt::kBig : t_init[i];
    const srt::HitOut h = srt::trace5(
        nodes, child_ids, leaf, ni,
        srt::Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]}, act, t0, st,
        wc);
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
}

// `leaf_slot` and `leaf_xf` are both null (MT mode) or both set (itf).
extern "C" void srt_traverse5_host(const float* nodes,
                                   const int32_t* child_ids,
                                   const float* mt,
                                   const int32_t* leaf_slot,
                                   const float* leaf_xf, int32_t ni,
                                   const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const uint8_t* active,
                                   const float* t_init, float* t_out,
                                   int32_t* tri_out, float* u_out,
                                   float* v_out, int64_t n_rays,
                                   int64_t* counts) {
  srt::WalkCounts wc{0, 0};
  if (leaf_slot == nullptr) {
    traverse5_host(nodes, child_ids, srt::MtLeaf{mt}, ni, ox, oy, oz, dx,
                   dy, dz, active, t_init, t_out, tri_out, u_out, v_out,
                   n_rays, &wc);
  } else {
    traverse5_host(nodes, child_ids,
                   srt::InstancedMtLeaf{mt, leaf_slot, leaf_xf}, ni, ox, oy,
                   oz, dx, dy, dz, active, t_init, t_out, tri_out, u_out,
                   v_out, n_rays, &wc);
  }
  if (counts != nullptr) {
    counts[0] += wc.boxes;
    counts[1] += wc.leaves;
  }
}

extern "C" void srt_traverse1_host(const float* children,
                                   const float* leaves, int32_t ni,
                                   int32_t k, int32_t rows,
                                   const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const uint8_t* active,
                                   const float* t_init, float* t_out,
                                   int32_t* tri_out, float* u_out,
                                   float* v_out, int64_t n_rays,
                                   int64_t* counts) {
  srt::WalkCounts wc{0, 0};
  srt::ArrayStack st;
  for (int64_t i = 0; i < n_rays; i++) {
    const bool act = active == nullptr || active[i] != 0;
    const float t0 = t_init == nullptr ? srt::kBig : t_init[i];
    const srt::HitOut h = srt::trace1(
        children, leaves, ni, k, rows,
        srt::Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]}, act, t0, st,
        &wc);
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
  if (counts != nullptr) {
    counts[0] += wc.boxes;
    counts[1] += wc.leaves;
  }
}

extern "C" int srt_stack() { return SRT_STACK; }
