// Closest-hit traversal of the implicit Morton-heap BVH8 with K-slot
// Moller-Trumbore leaves on Hopper (sm_90a): persistent warps, one ray
// per thread at a time.
//
// Replaces the JAX package's Pallas kernel traverse_packets (v1,
// sycl_ray_tracer_tpu/ops/traverse_pallas.py:216), which serves every
// scene built with leaf_size != 8. That kernel walks one shared scalar
// stack per 4096-ray packet, visits a node when any ray of the packet
// wants it, and pushes children in the packet's dominant-octant order;
// it clamps the row of a padding leaf and relies on its point box never
// being entered. None of that carries over: here each thread walks its
// own ray (walk_regs.cuh, the walk of traverse8) with the child ids of
// node n computed as 8n + 1 + j instead of loaded, children visited
// nearest first, and leaf children past the table skipped, so no thread
// reads past it. Inactive rays report t = 0, as the port's other
// kernels do (the JAX kernel writes -BIG there; no caller reads it).
//
// What bounds it on the card: a Morton heap splits at fixed code bits,
// so its boxes overlap more than SAH boxes and a ray enters more of
// them (about 46 node visits and 13 leaves per bounce ray on
// sponza_proc at K = 4); each visit is a dependent 192-byte fetch of the
// node's boxes (the tables, 16 MB there, stay in the 50 MB L2). The
// arithmetic (25 f32 operations per child box, 53 per triangle) is far
// below the card's rate, so it waits on those fetches and diverges
// within warps. The design against them is traverse8's (traverse8.cu):
// 16-byte node loads, slab tests, push order and the top of the stack
// in registers, leaf tests in their own loop (at K = 4 a leaf is nine
// 16-byte loads), and persistent warps over the live lanes.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// -fmad=false, so that each operation rounds as in the plain torch
// version (ops/traverse1.py) and the two agree bit for bit, at
// equal-t ties too but for the rare case that bvh8_walk.cuh names.
// Bound to Python through ctypes (ops/traverse1.py).

#include <cuda_runtime.h>

#include "schedule.cuh"
#include "traverse1.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
traverse1_kernel(const float* __restrict__ children,
                 const float* __restrict__ leaves, int32_t ni, int32_t k,
                 int32_t rows,
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
                  return srt::trace1(children, leaves, ni, k, rows, r, true,
                                     t0, st);
                });
}

}  // namespace

// C entry point. `active` and `t_init` may be null (all active, t_init
// = BIG). `list` (int32 [n_rays], needed with `active`) and `counters`
// (uint64 [2], zero) are scratch from the caller. Launches on `stream`
// and returns the first CUDA error as an int.
extern "C" int srt_traverse1(const void* children, const void* leaves,
                             int32_t ni, int32_t k, int32_t rows,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
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
  err = srt::persistent_grid(traverse1_kernel, kThreads, n_rays, &grid);
  if (err != cudaSuccess) return (int)err;
  traverse1_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)children, (const float*)leaves, ni, k, rows,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)t_init,
      (float*)t_out, (int32_t*)tri_out, (float*)u_out, (float*)v_out,
      active == nullptr ? nullptr : (const int32_t*)list, cnt, n_rays);
  return (int)cudaGetLastError();
}
