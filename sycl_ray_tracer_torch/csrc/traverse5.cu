// Closest-hit BVH8 traversal with Moller-Trumbore leaves on Hopper
// (sm_90a), optionally with an instance transform per leaf (two-level
// instancing): persistent warps, one ray per thread at a time.
//
// Replaces the JAX package's Pallas kernel traverse_packets5
// (sycl_ray_tracer_tpu/ops/traverse_pallas5.py:424). That kernel walks
// one shared stack per ray packet, pops several nodes per iteration
// around one vector-to-scalar readback, and drains leaves from a ring
// in scalar memory. All of that is TPU scheduling and none of it
// carries over: here each thread walks its own ray (walk_regs.cuh, the
// walk of traverse8, with the leaf tests of traverse5.cuh) and tests
// each leaf as soon as its box is entered.
//
// In itf mode a global leaf names a shared leaf (leaf_slot) and the
// world -> local transform of its instance (leaf_xf); the thread maps
// its ray into instance space for that leaf only, leaving d
// unnormalized so that t stays a world-space distance. This is the
// reference's Embree TLAS/BLAS instancing (scene.cpp:404-439): one copy
// of each unique primitive's triangles, per-instance node boxes. Each
// mode is its own instance of the kernel.
//
// What bounds it on the card: on an instanced scene the node table is
// the big read (224 bytes per internal node: 205,357 nodes, 46 MB, on
// minecraft_proc), plus 52 bytes per leaf entered for the slot and the
// transform; the shared triangle rows are a few KB and stay in L1/L2.
// The tables together (about 75 MB there) exceed the 50 MB L2, so the
// deep levels of the instance tree come from DRAM, and every visit
// waits on a dependent load. The arithmetic (25 operations per child
// box, 53 per triangle, 33 per transform) is far below the card's rate.
// The design against the latency is traverse8's (traverse8.cu): a node
// in 12 + 2 16-byte loads, all 8 children slab-tested in registers, the
// leaf tests in a loop of their own and the push order computed in
// registers (walk_regs.cuh); a leaf's 8 slots in 18 16-byte loads and
// its transform in 3 (traverse5.cuh); persistent warps over the rays,
// or over the live lanes of an active mask, compacted first
// (schedule.cuh), so that the megakernel's masked launches pay for the
// live lanes only.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math and with
// -fmad=false, so that each operation rounds as in the plain torch
// version (ops/traverse5.py) and the two agree bit for bit, at
// equal-t ties too but for the rare case that bvh8_walk.cuh names.
// Bound to Python through ctypes (ops/traverse5.py).

#include <cuda_runtime.h>

#include "schedule.cuh"
#include "traverse5.cuh"

namespace {

constexpr int kThreads = 128;

template <class Leaf>
__global__ void __launch_bounds__(kThreads)
traverse5_kernel(const float* __restrict__ nodes,
                 const int32_t* __restrict__ child_ids, Leaf leaf,
                 int32_t ni,
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
                  return srt::trace5(nodes, child_ids, leaf, ni, r, true, t0,
                                     st);
                });
}

template <class Leaf>
cudaError_t launch(const void* nodes, const void* child_ids,
                   const Leaf& leaf, int32_t ni, const void* ox,
                   const void* oy, const void* oz, const void* dx,
                   const void* dy, const void* dz, const void* active,
                   const void* t_init, void* t_out, void* tri_out,
                   void* u_out, void* v_out, int64_t n_rays, void* list,
                   unsigned long long* cnt, cudaStream_t s) {
  int grid = 0;
  const cudaError_t err = srt::persistent_grid(traverse5_kernel<Leaf>,
                                               kThreads, n_rays, &grid);
  if (err != cudaSuccess) return err;
  traverse5_kernel<Leaf><<<grid, kThreads, 0, s>>>(
      (const float*)nodes, (const int32_t*)child_ids, leaf, ni,
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)t_init,
      (float*)t_out, (int32_t*)tri_out, (float*)u_out, (float*)v_out,
      active == nullptr ? nullptr : (const int32_t*)list, cnt, n_rays);
  return cudaGetLastError();
}

}  // namespace

// C entry point. `active` and `t_init` may be null (all active, t_init
// = BIG); `leaf_slot` and `leaf_xf` are both null (MT mode) or both set
// (itf mode). `list` (int32 [n_rays], needed with `active`) and
// `counters` (uint64 [2], zero) are scratch from the caller. Launches
// on `stream` and returns the first CUDA error as an int.
extern "C" int srt_traverse5(const void* nodes, const void* child_ids,
                             const void* mt, const void* leaf_slot,
                             const void* leaf_xf, int32_t ni,
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
  if (leaf_slot == nullptr) {
    err = launch(nodes, child_ids, srt::MtLeaf{(const float*)mt}, ni, ox, oy,
                 oz, dx, dy, dz, active, t_init, t_out, tri_out, u_out, v_out,
                 n_rays, list, cnt, s);
  } else {
    err = launch(nodes, child_ids,
                 srt::InstancedMtLeaf{(const float*)mt,
                                      (const int32_t*)leaf_slot,
                                      (const float*)leaf_xf},
                 ni, ox, oy, oz, dx, dy, dz, active, t_init, t_out, tri_out,
                 u_out, v_out, n_rays, list, cnt, s);
  }
  return (int)err;
}
