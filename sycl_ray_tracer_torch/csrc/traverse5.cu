// Closest-hit BVH8 traversal with Moller-Trumbore leaves on Hopper
// (sm_90a): one thread per ray, optionally with an instance transform
// per leaf (two-level instancing).
//
// Replaces the JAX package's Pallas kernel traverse_packets5
// (sycl_ray_tracer_tpu/ops/traverse_pallas5.py:424). That kernel walks
// one shared stack per ray packet, pops several nodes per iteration
// around one vector-to-scalar readback, and drains leaves from a ring
// in scalar memory. All of that is TPU scheduling and none of it
// carries over: here each thread walks its own ray (bvh8_walk.cuh,
// with the leaf test of traverse5.cuh), with the per-ray stack in
// local memory and each leaf tested as soon as its box is entered.
//
// In itf mode a global leaf names a shared leaf (leaf_slot) and the
// world -> local transform of its instance (leaf_xf); the thread maps
// its ray into instance space for that leaf only, leaving d
// unnormalized so that t stays a world-space distance. This is the
// reference's Embree TLAS/BLAS instancing (scene.cpp:404-439): one copy
// of each unique primitive's triangles, per-instance node boxes.
//
// What bounds it on the card: on an instanced scene the node table is
// the big read (224 bytes per internal node: 205,357 nodes, 46 MB, on
// minecraft_proc), plus 52 bytes per leaf entered for the slot and the
// transform; the shared triangle rows are a few KB and stay in L1/L2.
// The tables together (about 75 MB there) exceed the 50 MB L2, so the
// deep levels of the instance tree come from DRAM, and every visit
// waits on a dependent load. The arithmetic (about 25 flops per child
// box, 54 per triangle, 33 per transform) is far below the card's
// rate. This first version does nothing against the latency beyond
// read-only loads, near-first child order and the wavefront's
// coherence sort, which keeps the rays of a warp on the same nodes.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// -fmad=false, so that each operation rounds as in the plain torch
// version (ops/traverse5.py) and the two agree bit for bit outside
// equal-t ties. Bound to Python through ctypes (ops/traverse5.py).

#include <cuda_runtime.h>

#include "traverse5.cuh"

namespace {

__global__ void __launch_bounds__(128)
traverse5_kernel(const float* __restrict__ nodes,
                 const int32_t* __restrict__ child_ids,
                 const float* __restrict__ mt,
                 const int32_t* __restrict__ leaf_slot,
                 const float* __restrict__ leaf_xf, int32_t ni,
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
  const srt::HitOut h = srt::trace5(nodes, child_ids, mt, leaf_slot,
                                    leaf_xf, ni, ox[i], oy[i], oz[i], dx[i],
                                    dy[i], dz[i], act, t0);
  t_out[i] = h.t;
  tri_out[i] = h.tri;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

}  // namespace

// C entry point. `active` and `t_init` may be null (all active, t_init
// = BIG); `leaf_slot` and `leaf_xf` are both null (MT mode) or both set
// (itf mode). Launches on `stream` and returns cudaGetLastError() as an
// int.
extern "C" int srt_traverse5(const void* nodes, const void* child_ids,
                             const void* mt, const void* leaf_slot,
                             const void* leaf_xf, int32_t ni,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* active, const void* t_init,
                             void* t_out, void* tri_out, void* u_out,
                             void* v_out, int64_t n_rays, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n_rays + threads - 1) / threads;
  traverse5_kernel<<<(unsigned int)blocks, threads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)nodes, (const int32_t*)child_ids, (const float*)mt,
      (const int32_t*)leaf_slot, (const float*)leaf_xf, ni,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const uint8_t*)active,
      (const float*)t_init, (float*)t_out, (int32_t*)tri_out, (float*)u_out,
      (float*)v_out, n_rays);
  return (int)cudaGetLastError();
}
