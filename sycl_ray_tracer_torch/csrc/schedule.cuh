// How the traverse8, traverse5 and traverse1 kernels feed rays to threads
// (device only; the per-ray walk is walk_regs.cuh).
//
// - Persistent warps: the grid is as many blocks as fit on the card at
//   once (occupancy x SMs). Each warp takes 32 consecutive entries of
//   the work at a time from a global counter until none are left
//   (Aila & Laine 2009, "Understanding the efficiency of ray traversal
//   on GPUs"), so a warp's rays keep the caller's order (the
//   wavefront's coherence-sorted queue, neighbouring pixels) and no
//   warp is held by dead lanes. (Giving a lane its next ray as soon as
//   its own ends, instead of when the warp's 32 have, measured slower:
//   the lanes of a warp then walk different parts of the tree.)
// - With an active mask, compact_lanes first writes the indices of the
//   live lanes into a list (one ballot, a popc prefix and one atomicAdd
//   per warp, so each warp's live lanes stay in order) and the result
//   of every inactive lane, (t = 0, tri = -1, u = v = 0); the walk then
//   runs over the list only. Without a mask the work is 0..R-1.
// The hits do not depend on which thread takes which ray.

#pragma once

#include <cuda_runtime.h>

#include "walk_regs.cuh"

namespace srt {

// A launch's rays (t_init may be null: BIG) and results.
struct RayIO {
  const float* __restrict__ ox;
  const float* __restrict__ oy;
  const float* __restrict__ oz;
  const float* __restrict__ dx;
  const float* __restrict__ dy;
  const float* __restrict__ dz;
  const float* __restrict__ t_init;
  float* __restrict__ t;
  int32_t* __restrict__ tri;
  float* __restrict__ u;
  float* __restrict__ v;
};

// Calls trace(ray, t_init) for every entry of the work, list[0..n) or,
// with no list, 0..n, and writes the hit it returns; `next` is the fetch
// counter (zero at launch). A warp takes 32 entries at a time. Every
// thread of the block must call it (warp-wide fetch).
template <class Trace>
__device__ __forceinline__ void walk_all(const RayIO& io,
                                         const int32_t* __restrict__ list,
                                         unsigned long long* next, int64_t n,
                                         Trace&& trace) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(next, 32ull);
    base = __shfl_sync(0xffffffffu, base, 0);
    if ((int64_t)base >= n) return;
    const int64_t k = (int64_t)base + lane;
    if (k >= n) continue;
    const int64_t i = list == nullptr ? k : (int64_t)list[k];
    const HitOut h = trace(Ray{io.ox[i], io.oy[i], io.oz[i], io.dx[i],
                               io.dy[i], io.dz[i]},
                           io.t_init == nullptr ? kBig : io.t_init[i]);
    io.t[i] = h.t;
    io.tri[i] = h.tri;
    io.u[i] = h.u;
    io.v[i] = h.v;
  }
}

// A launch's hits (t_init may be null: BIG), for walk_records.
struct HitIO {
  const float* __restrict__ t_init;
  float* __restrict__ t;
  int32_t* __restrict__ tri;
  float* __restrict__ u;
  float* __restrict__ v;
};

// As walk_all, over n 32-byte records (rec, 16-byte aligned; order.cuh
// store_record): a record's ray in two 16-byte loads, its hit written to
// its lane.
template <class Trace>
__device__ __forceinline__ void walk_records(const HitIO& io,
                                             const float* __restrict__ rec,
                                             unsigned long long* next,
                                             int64_t n, Trace&& trace) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(next, 32ull);
    base = __shfl_sync(0xffffffffu, base, 0);
    if ((int64_t)base >= n) return;
    const int64_t k = (int64_t)base + lane;
    if (k >= n) continue;
    const F4 a = ld4(rec + 8 * k), b = ld4(rec + 8 * k + 4);
    const int64_t i = __float_as_int(b.z);
    const HitOut h = trace(Ray{a.x, a.y, a.z, a.w, b.x, b.y},
                           io.t_init == nullptr ? kBig : io.t_init[i]);
    io.t[i] = h.t;
    io.tri[i] = h.tri;
    io.u[i] = h.u;
    io.v[i] = h.v;
  }
}

namespace {

__global__ void __launch_bounds__(256)
compact_lanes_kernel(const uint8_t* __restrict__ active, int64_t n,
                     int32_t* __restrict__ list,
                     unsigned long long* __restrict__ count,
                     float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && active[i] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31;
  unsigned long long base = 0;
  if (lane == 0 && ballot != 0)
    base = atomicAdd(count, (unsigned long long)__popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) {
    list[base + __popc(ballot & ((1u << lane) - 1u))] = (int32_t)i;
  } else if (i < n) {
    t_out[i] = 0.0f;
    tri_out[i] = -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
  }
}

// Launches the compaction of `active` [n] into list and count[0].
cudaError_t compact_lanes(const uint8_t* active, int64_t n, int32_t* list,
                          unsigned long long* count, float* t_out,
                          int32_t* tri_out, float* u_out, float* v_out,
                          cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  compact_lanes_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      active, n, list, count, t_out, tri_out, u_out, v_out);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the persistent grid for `kernel` at `threads` per block: as
// many as are resident on the current device at once, and no more than
// n rays need.
template <class K>
inline cudaError_t persistent_grid(K kernel, int threads, int64_t n,
                                   int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return err;
  const int64_t need = (n + threads - 1) / threads;
  const int64_t full = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = (int)(need < full ? need : full);
  return cudaSuccess;
}

// Launches `kernel` on the persistent grid of `threads` a block for n
// lanes on stream s (nothing when n <= 0); returns the first CUDA error
// as an int.
template <class K, class... Args>
inline int launch_persistent(K kernel, int threads, int64_t n,
                             cudaStream_t s, Args... args) {
  if (n <= 0) return 0;
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, threads, n, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, 0, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace srt
