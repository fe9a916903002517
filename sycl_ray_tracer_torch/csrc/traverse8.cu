// Closest-hit BVH8 traversal on Hopper (sm_90a): one thread per ray.
//
// Replaces the JAX package's Pallas kernel traverse_packets8
// (sycl_ray_tracer_tpu/ops/traverse_pallas8.py:371). That kernel walks
// one shared stack per 1024-ray packet and batches the Woop leaf tests
// into matrix-unit products. None of that carries over: here each
// thread walks its own ray through the tree (bvh8_walk.cuh, with the
// Woop leaf test of traverse8.cuh), with the per-ray stack in local
// memory and the leaf tests inline.
//
// What bounds it on the card: the node table (48 floats + 8 ids per
// internal node) and the Woop table (48 bytes per triangle slot) come
// to about 18 MB on the 248K-triangle procedural Sponza, which fits in
// the 50 MB L2, so DRAM bandwidth is not the limit. Divergence (rays
// of one warp visiting different nodes and different numbers of them)
// and the latency of the dependent node loads are. This first version
// does nothing about either beyond read-only loads through
// __restrict__ pointers and near-first child ordering; sorting the
// queue by direction and origin before each launch (the wavefront's
// coherence key) is what keeps warps together.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math (dead
// triangle slots rely on IEEE inf/NaN) and with -fmad=false, so each
// operation rounds as in the plain torch version and the two agree bit
// for bit outside equal-t ties. Bound to Python through ctypes
// (ops/traverse8.py).

#include <cuda_runtime.h>

#include "traverse8.cuh"

namespace {

__global__ void __launch_bounds__(128)
traverse8_kernel(const float* __restrict__ nodes,
                 const int32_t* __restrict__ child_ids,
                 const float* __restrict__ woop, int32_t ni,
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
  const srt::HitOut h = srt::trace8(nodes, child_ids, woop, ni, ox[i],
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
extern "C" int srt_traverse8(const void* nodes, const void* child_ids,
                             const void* woop, int32_t ni, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz,
                             const void* active, const void* t_init,
                             void* t_out, void* tri_out, void* u_out,
                             void* v_out, int64_t n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n_rays + threads - 1) / threads;
  traverse8_kernel<<<(unsigned int)blocks, threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)nodes, (const int32_t*)child_ids, (const float*)woop, ni,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const uint8_t*)active,
      (const float*)t_init, (float*)t_out, (int32_t*)tri_out, (float*)u_out,
      (float*)v_out, n_rays);
  return (int)cudaGetLastError();
}

// Stack depth the library's kernels were compiled with (checked when
// ops/kernels.py loads the library).
extern "C" int srt_stack() { return SRT_STACK; }
