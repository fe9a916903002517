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
// keeps them together. The megakernel's lanes are in pixel order, and
// after the first bounce 32 neighbouring pixels shoot into every
// direction class, so its bounce launches pass the scene's box and go
// through the ordered entry, which gathers the live lanes' rays into
// buckets of the same dir6_morton key (order.cuh) before the walk:
//   - traverse_order_count_kernel: a thread a lane; counts the live
//     lanes' bins (kOrderBins global counters, 768 KB; the live lanes of
//     a warp that share a bin take one atomic, __match_any_sync, whose
//     old value places them in their bin), writes the inactive lanes'
//     results and the live count, as compact_lanes does; a live lane's
//     bin and place wait in its tri_out and u_out slots, which the walk
//     overwrites;
//   - traverse_order_scan_kernel: one block turns the counts into each
//     bin's first slot;
//   - traverse_order_place_kernel: a thread a lane writes each live
//     lane's ray and index as one 32-byte record at its bin's first slot
//     plus its place. Order within a bin is free;
//   - traverse8_records_kernel: the walk over the records, in their
//     order, each ray read as two 16-byte loads and its hit written to
//     its lane; the count comes from the device.
// Walked through a list of lane indices instead, the ordered rays cost
// six scattered 4-byte loads each, which ate the gain of the order.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math (dead
// triangle slots rely on IEEE inf/NaN) and with -fmad=false, so each
// operation rounds as in the plain torch version and the two agree bit
// for bit, at equal-t ties too but for the rare case that
// bvh8_walk.cuh names. Bound to Python through ctypes
// (ops/traverse8.py).

#include <cuda_runtime.h>

#include "order.cuh"
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

__global__ void __launch_bounds__(kThreads)
traverse8_records_kernel(const float* __restrict__ nodes,
                         const int32_t* __restrict__ child_ids,
                         const float* __restrict__ woop, int32_t ni,
                         const float* __restrict__ rec,
                         const float* __restrict__ t_init,
                         float* __restrict__ t_out,
                         int32_t* __restrict__ tri_out,
                         float* __restrict__ u_out, float* __restrict__ v_out,
                         unsigned long long* __restrict__ counters) {
  srt::ArrayStack st;
  srt::walk_records(srt::HitIO{t_init, t_out, tri_out, u_out, v_out}, rec,
                    counters + 1, (int64_t)counters[0],
                    [&](const srt::Ray& r, float t0) {
                      return srt::trace8(nodes, child_ids, woop, ni, r, true,
                                         t0, st);
                    });
}

constexpr int kOrderThreads = 256;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The ordered entry's inputs and outputs. rec: f32 [n, 8], a live
// lane's record at its slot (order.cuh store_record); counters: uint64
// [2 + kOrderBins / 2], zeroed: the live count, the walk's fetch
// counter, then the bins' counts as uint32 (their first slots after the
// scan).
struct OrderArgs {
  const uint8_t* active;
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float *scene_lo, *scene_hi;
  float* t;
  int32_t* tri;
  float* u;
  float* v;
  float* rec;
  unsigned long long* counters;
  int64_t n;
};

__device__ __forceinline__ uint32_t* order_bins(const OrderArgs& a) {
  return reinterpret_cast<uint32_t*>(a.counters + 2);
}

// Adds the live lanes of a warp to their bins' counts, one atomic per
// distinct bin (__match_any_sync); returns a live lane's place among its
// bin's lanes. Every thread of the warp calls it; `bin` is -1 on a lane
// that is not live.
__device__ __forceinline__ uint32_t claim(uint32_t* bins, int32_t bin) {
  const unsigned live = __ballot_sync(kFull, bin >= 0);
  if (bin < 0) return 0;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(live, bin);
  const int leader = __ffs(peers) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(&bins[bin], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Lane i: the block's live lanes, the result of an inactive lane; a
// live lane's bin in its tri slot and its place in the bin in its u slot.
__global__ void __launch_bounds__(kOrderThreads)
traverse_order_count_kernel(OrderArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kOrderThreads + threadIdx.x;
  const bool in = i < a.n;
  const bool live = in && a.active[i] != 0;
  int32_t bin = -1;
  if (live) {
    const srt::MortonBox box = srt::morton_box(a.scene_lo, a.scene_hi);
    bin = (int32_t)srt::lane_bin(box, a.ox, a.oy, a.oz, a.dx, a.dy, a.dz, i);
  } else if (in) {
    a.t[i] = 0.0f;
    a.tri[i] = -1;
    a.u[i] = 0.0f;
    a.v[i] = 0.0f;
  }
  const int block_live = __syncthreads_count(live);
  if (threadIdx.x == 0 && block_live != 0)
    atomicAdd(a.counters, (unsigned long long)block_live);
  const uint32_t place = claim(order_bins(a), bin);
  if (live) {
    a.tri[i] = bin;
    a.u[i] = __uint_as_float(place);
  }
}

// The bins' counts -> their exclusive prefix sums (each bin's first
// slot), in one block: each warp takes a contiguous segment of the bins,
// adds up the segments before it, and scans its own 128 bins at a time,
// four a thread (16-byte loads and stores).
__global__ void __launch_bounds__(kScanThreads)
traverse_order_scan_kernel(OrderArgs a) {
  constexpr int kWarps = kScanThreads / 32;
  constexpr int kSegment = srt::kOrderBins / kWarps / 4;  // uint4 a warp
  static_assert(srt::kOrderBins % (kWarps * 128) == 0,
                "a warp's segment is whole runs of 128 bins");
  __shared__ uint32_t warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* seg = reinterpret_cast<uint4*>(order_bins(a)) + warp * kSegment;
  uint32_t sum = 0;
  for (int j = lane; j < kSegment; j += 32) {
    const uint4 c = seg[j];
    sum += c.x + c.y + c.z + c.w;
  }
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) warp_sum[warp] = sum;
  __syncthreads();
  uint32_t carry = 0;
  for (int w = 0; w < warp; w++) carry += warp_sum[w];
  for (int base = 0; base < kSegment; base += 32) {
    const uint4 c = seg[base + lane];
    const uint32_t own = c.x + c.y + c.z + c.w;
    uint32_t x = own;
    SRT_UNROLL
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const uint32_t first = carry + x - own;
    seg[base + lane] = make_uint4(first, first + c.x, first + c.x + c.y,
                                  first + c.x + c.y + c.z);
    carry += __shfl_sync(kFull, x, 31);
  }
}

// Lane i, if live (its tri slot holds its bin, its u slot its place):
// its record at its bin's first slot plus its place.
__global__ void __launch_bounds__(kOrderThreads)
traverse_order_place_kernel(OrderArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kOrderThreads + threadIdx.x;
  if (i >= a.n) return;
  const int32_t bin = a.tri[i];
  if (bin < 0) return;
  const uint32_t slot = order_bins(a)[bin] + __float_as_uint(a.u[i]);
  srt::store_record(a.rec, slot, a.ox[i], a.oy[i], a.oz[i], a.dx[i],
                    a.dy[i], a.dz[i], i);
}

// Launches the three passes over a.n > 0 lanes on stream s.
cudaError_t order_lanes(const OrderArgs& a, cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((a.n + kOrderThreads - 1) / kOrderThreads);
  traverse_order_count_kernel<<<blocks, kOrderThreads, 0, s>>>(a);
  traverse_order_scan_kernel<<<1, kScanThreads, 0, s>>>(a);
  traverse_order_place_kernel<<<blocks, kOrderThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The walk's order alone: the live lanes of `active` [n] gathered in
// ascending bins of their rays (order.cuh) as 32-byte records (ray and
// lane, order.cuh store_record) into rec (f32 [n, 8], 16-byte aligned),
// the live count into counters[0] (uint64 [2 + kOrderBins / 2],
// zeroed), and the inactive lanes' results (0, -1, 0, 0) into t, tri, u,
// v; a live lane's tri and u slots are left holding its bin and its
// place in it. What srt_traverse8_ordered runs before its walk.
extern "C" int srt_traverse8_order(const void* active, const void* ox,
                                   const void* oy, const void* oz,
                                   const void* dx, const void* dy,
                                   const void* dz, const void* scene_lo,
                                   const void* scene_hi, void* t_out,
                                   void* tri_out, void* u_out, void* v_out,
                                   int64_t n, void* rec, void* counters,
                                   void* stream) {
  if (n <= 0) return 0;
  const OrderArgs a{(const uint8_t*)active, (const float*)ox,
                    (const float*)oy, (const float*)oz, (const float*)dx,
                    (const float*)dy, (const float*)dz,
                    (const float*)scene_lo, (const float*)scene_hi,
                    (float*)t_out, (int32_t*)tri_out, (float*)u_out,
                    (float*)v_out, (float*)rec,
                    (unsigned long long*)counters, n};
  return (int)order_lanes(a, (cudaStream_t)stream);
}

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

// The masked entry with the walk in the order of srt_traverse8_order:
// the arguments of srt_traverse8 with `active` required, `rec` (f32
// [n_rays, 8], 16-byte aligned) in place of the list, counters uint64
// [2 + kOrderBins / 2] (zeroed), and the scene's box (`scene_lo`,
// `scene_hi`, f32 [3] each) ahead of the stream.
extern "C" int srt_traverse8_ordered(
    const void* nodes, const void* child_ids, const void* woop, int32_t ni,
    const void* ox, const void* oy, const void* oz, const void* dx,
    const void* dy, const void* dz, const void* active, const void* t_init,
    void* t_out, void* tri_out, void* u_out, void* v_out, int64_t n_rays,
    void* rec, void* counters, const void* scene_lo, const void* scene_hi,
    void* stream) {
  if (n_rays <= 0) return 0;
  const int err = srt_traverse8_order(active, ox, oy, oz, dx, dy, dz,
                                      scene_lo, scene_hi, t_out, tri_out,
                                      u_out, v_out, n_rays, rec, counters,
                                      stream);
  if (err != 0) return err;
  return srt::launch_persistent(
      traverse8_records_kernel, kThreads, n_rays, (cudaStream_t)stream,
      (const float*)nodes, (const int32_t*)child_ids, (const float*)woop, ni,
      (const float*)rec, (const float*)t_init, (float*)t_out,
      (int32_t*)tri_out, (float*)u_out, (float*)v_out,
      (unsigned long long*)counters);
}

// Stack depth the library's kernels were compiled with (checked when
// ops/kernels.py loads the library).
extern "C" int srt_stack() { return SRT_STACK; }
// Bins of the walk's order (checked as srt_stack is).
extern "C" int srt_order_bins() { return srt::kOrderBins; }
