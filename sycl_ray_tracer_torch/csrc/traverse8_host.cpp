// Host build of the per-ray walk in traverse8.cuh: the same function
// the CUDA kernel runs per thread, looped over rays on the CPU. The
// tests build it with g++ and hold it against the plain torch version
// (ops/traverse8.py traverse8_plain), since no CUDA compiler runs there.

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
                                   float* v_out, int64_t n_rays) {
  for (int64_t i = 0; i < n_rays; i++) {
    const bool act = active == nullptr || active[i] != 0;
    const float t0 = t_init == nullptr ? srt::kBig : t_init[i];
    const srt::HitOut h = srt::trace8(nodes, child_ids, woop, ni, ox[i],
                                      oy[i], oz[i], dx[i], dy[i], dz[i],
                                      act, t0);
    t_out[i] = h.t;
    tri_out[i] = h.tri;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
}

extern "C" int srt_traverse8_stack() { return SRT_STACK; }
