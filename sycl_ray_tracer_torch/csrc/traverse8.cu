// Closest-hit BVH8 traversal on Hopper (sm_90a): persistent warps, one
// ray per thread at a time.
//
// Replaces the JAX package's Pallas kernel traverse_packets8
// (sycl_ray_tracer_tpu/ops/traverse_pallas8.py:371). That kernel walks
// one shared stack per 1024-ray packet and batches the Woop leaf tests
// into matrix-unit products. None of that carries over: here each
// thread walks its own ray through the tree (walk_regs.cuh, with the
// Woop leaf test of traverse8.cuh).
//
// What bounds it on the card: the node table (48 floats + 8 ids per
// internal node) and the Woop table (48 bytes per triangle slot) come
// to about 18 MB on the 248K-triangle procedural Sponza, which fits in
// the 50 MB L2, so DRAM bandwidth is not the limit. The latency of the
// dependent node fetches, divergence within warps, and, in the
// megakernel, warps held by dead lanes are. The design against them:
//   - a node is fetched as 12 + 2 16-byte loads, all 8 children
//     slab-tested in registers, leaf tests in a loop of their own, the
//     push order computed in registers, and the top of the stack kept
//     there (walk_regs.cuh; the rest of the stack is in local memory);
//   - persistent warps fetch 32 rays at a time, and with an active mask
//     only the live lanes, compacted first (schedule.cuh);
//   - -1/d'z is the correctly rounded reciprocal, not a division.
// Rays that share a warp still diverge; the wavefront's coherence sort
// keeps them together.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math (dead
// triangle slots rely on IEEE inf/NaN) and with -fmad=false, so each
// operation rounds as in the plain torch version and the two agree bit
// for bit, at equal-t ties too but for the rare case that
// bvh8_walk.cuh names. Bound to Python through ctypes
// (ops/traverse8.py).

#include <cuda_runtime.h>

#include "schedule.cuh"
#include "traverse8.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
traverse8_kernel(const float* __restrict__ nodes,
                 const int32_t* __restrict__ child_ids,
                 const float* __restrict__ woop, int32_t ni,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ t_init,
                 float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 const int32_t* __restrict__ list,
                 unsigned long long* __restrict__ counters, int64_t n_rays) {
  srt::ArrayStack st;
  const int64_t n = list == nullptr ? n_rays : (int64_t)counters[0];
  srt::walk_all(srt::RayIO{ox, oy, oz, dx, dy, dz, t_init, t_out, tri_out,
                           u_out, v_out},
                list, counters + 1, n,
                [&](const srt::Ray& r, float t0) {
                  return srt::trace8(nodes, child_ids, woop, ni, r, true,
                                     t0, st);
                });
}

}  // namespace

// C entry point. `active` and `t_init` may be null (all active, t_init
// = BIG). `list` (int32 [n_rays], needed with `active`) and `counters`
// (uint64 [2], zero) are scratch from the caller. Launches on `stream`
// and returns the first CUDA error as an int.
extern "C" int srt_traverse8(const void* nodes, const void* child_ids,
                             const void* woop, int32_t ni, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz,
                             const void* active, const void* t_init,
                             void* t_out, void* tri_out, void* u_out,
                             void* v_out, int64_t n_rays, void* list,
                             void* counters, void* stream) {
  if (n_rays <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* cnt = (unsigned long long*)counters;
  cudaError_t err = cudaSuccess;
  if (active != nullptr) {
    err = srt::compact_lanes((const uint8_t*)active, n_rays, (int32_t*)list,
                             cnt, (float*)t_out, (int32_t*)tri_out,
                             (float*)u_out, (float*)v_out, s);
    if (err != cudaSuccess) return (int)err;
  }
  int grid = 0;
  err = srt::persistent_grid(traverse8_kernel, kThreads, n_rays, &grid);
  if (err != cudaSuccess) return (int)err;
  traverse8_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)nodes, (const int32_t*)child_ids, (const float*)woop, ni,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)t_init,
      (float*)t_out, (int32_t*)tri_out, (float*)u_out, (float*)v_out,
      active == nullptr ? nullptr : (const int32_t*)list, cnt, n_rays);
  return (int)cudaGetLastError();
}

// Stack depth the library's kernels were compiled with (checked when
// ops/kernels.py loads the library).
extern "C" int srt_stack() { return SRT_STACK; }
