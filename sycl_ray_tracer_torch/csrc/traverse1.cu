// Closest-hit traversal of the implicit Morton-heap BVH8 with K-slot
// Moller-Trumbore leaves on Hopper (sm_90a): one thread per ray.
//
// Replaces the JAX package's Pallas kernel traverse_packets (v1,
// sycl_ray_tracer_tpu/ops/traverse_pallas.py:216), which serves every
// scene built with leaf_size != 8. That kernel walks one shared scalar
// stack per 4096-ray packet, visits a node when any ray of the packet
// wants it, and pushes children in the packet's dominant-octant order;
// it clamps the row of a padding leaf and relies on its point box never
// being entered. None of that carries over: here each thread walks its
// own ray (bvh8_walk.cuh, the walk of traverse8 and traverse5) with the
// child ids of node n computed as 8n + 1 + j instead of loaded, children
// visited nearest first, and leaf children past the table skipped, so
// no thread reads past it. Inactive rays report t = 0, as the port's
// other kernels do (the JAX kernel writes -BIG there; no caller reads
// it).
//
// What bounds it on the card: a Morton heap splits at fixed code bits,
// so its boxes overlap more than SAH boxes and a ray enters more of
// them; each visit is a dependent 192-byte load of the node's boxes
// (the tables of sponza_proc at K=4, 16 MB, stay in the 50 MB L2). The
// arithmetic (25 f32 operations per child box, 53 per triangle) is far
// below the card's rate, so like traverse8 it waits on loads and
// diverges within warps; this first version does nothing about it
// beyond read-only loads, near-first order and the wavefront's
// coherence sort.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// -fmad=false, so that each operation rounds as in the plain torch
// version (ops/traverse1.py) and the two agree bit for bit outside
// equal-t ties. Bound to Python through ctypes (ops/traverse1.py).

#include <cuda_runtime.h>

#include "traverse1.cuh"

namespace {

__global__ void __launch_bounds__(128)
traverse1_kernel(const float* __restrict__ children,
                 const float* __restrict__ leaves, int32_t ni, int32_t k,
                 int32_t rows,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ t_init,
                 float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                 float* __restrict__ u_out, float* __restrict__ v_out,
                 int64_t n_rays) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const bool act = active == nullptr || active[i] != 0;
  const float t0 = t_init == nullptr ? srt::kBig : t_init[i];
  const srt::HitOut h = srt::trace1(children, leaves, ni, k, rows, ox[i],
                                    oy[i], oz[i], dx[i], dy[i], dz[i], act,
                                    t0);
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

}  // namespace

// C entry point. `active` and `t_init` may be null (all active, t_init
// = BIG). Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int srt_traverse1(const void* children, const void* leaves,
                             int32_t ni, int32_t k, int32_t rows,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* active, const void* t_init,
                             void* t_out, void* tri_out, void* u_out,
                             void* v_out, int64_t n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n_rays + threads - 1) / threads;
  traverse1_kernel<<<(unsigned int)blocks, threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)children, (const float*)leaves, ni, k, rows,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const uint8_t*)active,
      (const float*)t_init, (float*)t_out, (int32_t*)tri_out, (float*)u_out,
      (float*)v_out, n_rays);
  return (int)cudaGetLastError();
}
