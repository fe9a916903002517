// The bounce stages on Hopper (sm_90a): one shade launch and one scatter
// launch per bounce, for both engines.
//
// Replaces no TPU kernel: the JAX package leaves these stages to XLA,
// which fuses them. The port ran them as eager torch operations (the
// plain stages of models/trace.py, models/materials.py and ops/rng.py,
// which stay the CPU's path and the tests' reference), each a kernel
// over every lane with its result in device memory, and the RNG counters
// uploaded from the host as tensors. These kernels compute the same
// functions per lane (vertex.cuh) in registers.
//
// What bounds them on the card: bytes. A lane's work is small (at most
// five pcg2d hashes, one material, a texel), its traffic about 90 bytes
// in shade (hit 12-16, a 64-byte shading row, a texel; a 48-byte record
// out) and about 100 in scatter (the record, the ray, the key or the
// queue id; the outputs). The design:
//   - one thread per lane, grid-stride over the lanes, per-lane columns
//     read and written coalesced (the record is [12, n], column-major);
//   - the shading row is read as four 16-byte loads, the material
//     tables, the atlas and the normal matrices through the read-only
//     path (they are small or shared by many lanes);
//   - only the branch of the lane's material type runs, and a lane the
//     engine does not need to shade skips the stage: a miss in shade, a
//     done lane in the megakernel's scatter (it reads its flag only);
//   - the megakernel's path state is updated in place; the wavefront's
//     outputs go where its compaction reads them;
//   - the bounce counter and russian roulette's start are kernel
//     arguments, so no RNG counter is uploaded within the bounce loop.
//
// Built with -fmad=false and without fast math (ops/kernels.py), so
// every operation rounds as in the torch stages on the card.

#include <cuda_runtime.h>

#include "schedule.cuh"
#include "vertex.cuh"

namespace {

constexpr int kThreads = 256;

template <class TriT>
__global__ void __launch_bounds__(kThreads)
shade_kernel(srt::ShadeTables s, const TriT* __restrict__ tri,
             const float* __restrict__ u, const float* __restrict__ v,
             float* __restrict__ rec, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int64_t t = (int64_t)tri[i];
    if (t < 0) continue;
    srt::store_rec(rec, n, i, srt::shade_lane(s, t, u[i], v[i]));
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_queue_kernel(srt::Bounce b, srt::QueueIO io) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < b.n;
       i += step)
    srt::queue_lane(b, io, i);
}

__global__ void __launch_bounds__(kThreads)
scatter_paths_kernel(srt::Bounce b, srt::PathIO io) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < b.n;
       i += step)
    srt::path_lane(b, io, i);
}

template <class K, class... Args>
int launch(K kernel, int64_t n, cudaStream_t s, Args... args) {
  return srt::launch_persistent(kernel, kThreads, n, s, args...);
}

}  // namespace

// C entry points: launch on `stream` and return the first CUDA error as
// an int. The structs are the caller's (ops/vertex.py), copied into the
// launch by value.

// tri is int32 or int64 (tri_bytes 4 or 8): -1 on a miss, which writes
// nothing.
extern "C" int srt_shade(const srt::ShadeTables* tables, const void* tri,
                         int32_t tri_bytes, const void* u, const void* v,
                         void* rec, int64_t n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tri_bytes == 8)
    return launch(shade_kernel<int64_t>, n, s, *tables,
                  (const int64_t*)tri, (const float*)u, (const float*)v,
                  (float*)rec, n);
  return launch(shade_kernel<int32_t>, n, s, *tables, (const int32_t*)tri,
                (const float*)u, (const float*)v, (float*)rec, n);
}

extern "C" int srt_scatter_queue(const srt::Bounce* bounce,
                                 const srt::QueueIO* io, void* stream) {
  return launch(scatter_queue_kernel, bounce->n, (cudaStream_t)stream,
                *bounce, *io);
}

extern "C" int srt_scatter_paths(const srt::Bounce* bounce,
                                 const srt::PathIO* io, void* stream) {
  return launch(scatter_paths_kernel, bounce->n, (cudaStream_t)stream,
                *bounce, *io);
}
