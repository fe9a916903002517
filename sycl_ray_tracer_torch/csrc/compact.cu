// The wavefront's queue compaction on Hopper (sm_90a): a key pass, a
// stable radix sort of its 32-bit keys (4 launches) and a gather, a
// bounce.
//
// Replaces no TPU kernel: the JAX package's _compact is XLA's argsort and
// take. The port ran it as eager torch operations (models/wavefront.py
// _compact, _coherence_key, a torch.stack of the 12 rows and a gather),
// which stay the CPU's path and the tests' reference: the key in int64
// through a dozen elementwise kernels, a stable sort of int64 keys (8
// radix passes of int64 keys and indices), a [12, n] stack and a column
// gather, about 3.5 KB of traffic a queue entry.
//
// What bounds it on the card: bytes. A lane's work is a Morton code and
// a compare. The function needs 128 B a live lane: its origin,
// direction, t, the scatter stage's 9 rows and queue id in (72 B), the
// next queue's 12 rows and id out (56 B). The design moves about 320 B:
// the key pass reads 73 B and writes 68 B (a 64-byte record, the key),
// the sort 56 B, and the gather reads a 4-byte index and one 64-byte
// block and writes 56 B. What the design does about it:
//   - the key pass (compact_keys_kernel) computes what the eager
//     compaction computes in one thread a lane (compact.cuh), writes the
//     next queue's 12 rows and the queue id of a live lane as one
//     row-major 64-byte record, so that the gather's random read is one
//     aligned 64-byte block a lane and not thirteen sectors, and writes
//     a 32-bit key; a dead lane reads its flag only; the records go out
//     through shared memory as each warp's 2 KB run of 16-byte
//     streaming stores (four stores a thread, 64 B apart across the
//     warp, took 5.03 ms against 3.41 on Sponza's 66.4M lanes on an H100);
//   - the key pass also counts the live lanes and the keys' 8-bit digits
//     (in shared memory, added to global counts once a block), so the
//     host reads the live count with the one wait it had and the sort
//     needs no counting pass of its own;
//   - the sort (radix_pass_kernel, one launch a digit) moves 32-bit
//     keys and 32-bit lane indices where torch.sort moved int64 indices:
//     the first pass makes the indices from positions, the last writes
//     indices alone;
//   - the gather (compact_gather_kernel) gives one thread to each entry
//     of the next queue: it reads the sorted index and the record (four
//     16-byte loads) and writes the 12 rows and the id coalesced (four
//     entries a thread, their reads in flight together, measured no
//     faster: the random 64-byte reads are the limit);
//   - offsets are int64 (indices in the sort 32-bit: at most 2**30
//     lanes); the key pass and the gather run persistent, grid-stride.
//
// Built with -fmad=false and without fast math (ops/kernels.py), so the
// new origin and the Morton cell round as the eager ops do.

#include <cuda_runtime.h>

#include "compact.cuh"
#include "schedule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == srt::kRadix,
              "a sort block's thread d owns digit d");

// The radix sort's tiles: 256 threads, 16 keys each, each warp a run of
// 512 consecutive keys.
constexpr int kItems = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTile = kThreads * kItems;
// a tile's status word for one digit: flag bits, then a count of keys
constexpr uint32_t kAggregate = 1u << 30;  // this tile's count alone
constexpr uint32_t kPrefix = 2u << 30;     // this and every earlier tile's
constexpr uint32_t kCountMask = kAggregate - 1u;

__device__ __forceinline__ float4 f4(const srt::F4& v) {
  return make_float4(v.x, v.y, v.z, v.w);
}

// One warp takes 32 consecutive lanes at a time. Each live lane's record
// goes through the warp's slice of shared memory, so that the warp
// writes its records as 512-byte runs of 16-byte stores (a dead lane's
// part of the run is skipped). Every lane's key counts in the block's
// digit histograms, added to stats once a block.
__global__ void __launch_bounds__(kThreads)
compact_keys_kernel(srt::CompactIn in, srt::CompactOut out) {
  __shared__ float4 stage[kThreads * 4];
  __shared__ unsigned hist[srt::kSortPasses * srt::kRadix];
  __shared__ unsigned warp_live[kWarps];
  const int lane = threadIdx.x & 31;
  float4* mine = stage + (threadIdx.x - lane) * 4;
  for (int j = threadIdx.x; j < srt::kSortPasses * srt::kRadix; j += kThreads)
    hist[j] = 0;
  __syncthreads();
  const srt::MortonBox box = srt::morton_box(in.scene_lo, in.scene_hi);
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  unsigned count = 0;
  for (int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
       first < in.n; first += step) {
    const int64_t i = first + lane;
    bool alive = false;
    if (i < in.n) {
      float rec[srt::kQueueRows];
      uint32_t key;
      alive = srt::key_lane(in, box, i, rec, &key);
      out.key[i] = key;
      SRT_UNROLL
      for (int p = 0; p < srt::kSortPasses; p++)
        atomicAdd(&hist[p * srt::kRadix + srt::digit(key, p)], 1u);
      if (alive) {
        const srt::Rec64 r = srt::make_rec(rec, srt::ldg(in.q_id + i));
        SRT_UNROLL
        for (int k = 0; k < 4; k++) mine[lane * 4 + k] = f4(r.part[k]);
      }
    }
    const unsigned alive_mask = __ballot_sync(kFull, alive);
    count += alive;
    __syncwarp();
    float4* dst =
        reinterpret_cast<float4*>(out.rec + first * srt::kRecFloats);
    SRT_UNROLL
    for (int k = 0; k < 4; k++) {
      const int c = lane + 32 * k;
      if (alive_mask >> (c >> 2) & 1u) __stcs(dst + c, mine[c]);
    }
    __syncwarp();
  }
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) warp_live[threadIdx.x >> 5] = count;
  __syncthreads();
  for (int j = threadIdx.x; j < srt::kSortPasses * srt::kRadix; j += kThreads)
    if (hist[j] != 0)
      atomicAdd((unsigned long long*)out.stats + 1 + j, hist[j]);
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; w++) total += warp_live[w];
    if (total != 0) atomicAdd((unsigned long long*)out.stats, total);
  }
}

// The exclusive prefix sum of v over the block's threads (in thread
// order); scan: kWarps words of shared scratch. Every thread must call.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                       uint32_t* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
  SRT_UNROLL
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; w++) before += scan[w];
  __syncthreads();
  return before + x - v;
}

struct SortPass {
  const uint32_t* keys_in;
  const uint32_t* vals_in;  // null: a key's value is its index
  uint32_t* keys_out;       // null: the last pass writes values only
  uint32_t* vals_out;
  const uint64_t* counts;   // [256]: this digit's counts over all keys
  uint32_t* status;         // [tiles, 256], zeroed
  uint32_t* next_tile;      // zeroed
  int64_t n;
  int pass;
};

// One stable counting pass of the radix sort over one digit, one tile a
// block (Merrill and Garland's one-sweep radix sort, 2022): the block
// takes the next tile in order from a counter, ranks its keys by digit
// (each warp over its 512 keys in order, with __match_any_sync), posts
// its digit counts, adds up the counts of the tiles before it (decoupled
// look-back: a tile posts its count alone, then its prefix once it has
// it; blocks take tiles in order, so every tile waited on is running),
// sorts the tile in shared memory and writes it out, each digit's keys
// in a run. Keys past n fill the last tile with the largest digit, after
// every real key, and are not written.
__global__ void __launch_bounds__(kThreads) radix_pass_kernel(SortPass p) {
  __shared__ uint32_t s_key[kTile];
  __shared__ uint32_t s_val[kTile];
  __shared__ uint32_t s_warp[kWarps][srt::kRadix];  // counts, then offsets
  __shared__ uint32_t s_start[srt::kRadix];  // a digit's first slot here
  __shared__ uint32_t s_dest[srt::kRadix];   // and its index in the output
  __shared__ uint32_t s_scan[kWarps];
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(p.next_tile, 1u);
  for (int j = tid; j < kWarps * srt::kRadix; j += kThreads)
    (&s_warp[0][0])[j] = 0;
  __syncthreads();
  const uint32_t tile = s_tile;
  const int64_t base = (int64_t)tile * kTile;
  const int valid = (int)(p.n - base < kTile ? p.n - base : kTile);
  uint32_t key[kItems], val[kItems], rank[kItems];
  SRT_UNROLL
  for (int k = 0; k < kItems; k++) {
    const int idx = warp * kWarpKeys + k * 32 + lane;
    const int64_t g = base + idx;
    key[k] = idx < valid ? p.keys_in[g] : 0xFFFFFFFFu;
    val[k] = idx >= valid ? 0u : p.vals_in ? p.vals_in[g] : (uint32_t)g;
  }
  const unsigned below = (1u << lane) - 1u;
  SRT_UNROLL
  for (int k = 0; k < kItems; k++) {
    const uint32_t d = srt::digit(key[k], p.pass);
    const unsigned peers = __match_any_sync(kFull, d);
    const uint32_t seen = s_warp[warp][d];
    rank[k] = seen + __popc(peers & below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) s_warp[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: digit d's warps' offsets in the tile and its count here
  const int d = tid;
  uint32_t total = 0;
  for (int w = 0; w < kWarps; w++) {
    const uint32_t c = s_warp[w][d];
    s_warp[w][d] = total;
    total += c;
  }
  const uint32_t count =
      total - (d == srt::kRadix - 1 ? (uint32_t)(kTile - valid) : 0u);
  volatile uint32_t* status = p.status;
  const int64_t mine = (int64_t)tile * srt::kRadix + d;
  status[mine] = (tile == 0 ? kPrefix : kAggregate) | count;
  const uint32_t bucket = block_exclusive_sum((uint32_t)p.counts[d], s_scan);
  s_start[d] = block_exclusive_sum(total, s_scan);
  uint32_t before = 0;
  for (int64_t t = (int64_t)tile - 1; t >= 0;) {
    const uint32_t s = status[t * srt::kRadix + d];
    if (s == 0) continue;
    before += s & kCountMask;
    if (s & kPrefix) break;
    --t;
  }
  if (tile > 0) status[mine] = kPrefix | (before + count);
  s_dest[d] = bucket + before;
  __syncthreads();
  SRT_UNROLL
  for (int k = 0; k < kItems; k++) {
    const uint32_t dk = srt::digit(key[k], p.pass);
    const uint32_t at = s_start[dk] + s_warp[warp][dk] + rank[k];
    s_key[at] = key[k];
    s_val[at] = val[k];
  }
  __syncthreads();
  for (int i = tid; i < valid; i += kThreads) {
    const uint32_t k = s_key[i], dk = srt::digit(k, p.pass);
    const uint32_t at = s_dest[dk] + (uint32_t)i - s_start[dk];
    if (p.keys_out != nullptr) p.keys_out[at] = k;
    p.vals_out[at] = s_val[i];
  }
}

__global__ void __launch_bounds__(kThreads)
compact_gather_kernel(const float* __restrict__ rec,
                      const uint32_t* __restrict__ perm, int64_t m,
                      float* __restrict__ q2, int64_t* __restrict__ q_id2) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += step)
    srt::store_entry(srt::load_rec64(rec, srt::ldg(perm + j)), m, j, q2,
                     q_id2);
}

}  // namespace

// C entry points: launch on `stream` and return the first CUDA error as
// an int. The structs are the caller's (ops/compact.py), copied into the
// launch by value.

extern "C" int srt_compact_keys(const srt::CompactIn* in,
                                const srt::CompactOut* out, void* stream) {
  return srt::launch_persistent(compact_keys_kernel, kThreads, in->n,
                                (cudaStream_t)stream, *in, *out);
}

// Words of zeroed scratch the sort of n keys takes: each pass's tile
// status words, then its tile counter.
extern "C" int64_t srt_compact_sort_scratch(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return srt::kSortPasses * (tiles * srt::kRadix + 1);
}

extern "C" int srt_compact_sort(const srt::SortBufs* b, void* stream) {
  if (b->n <= 0) return 0;
  const int64_t tiles = (b->n + kTile - 1) / kTile;
  const uint32_t* keys_in[] = {b->key, b->key_alt, b->key, b->key_alt};
  uint32_t* keys_out[] = {b->key_alt, b->key, b->key_alt, nullptr};
  const uint32_t* vals_in[] = {nullptr, b->val_a, b->val_b, b->val_a};
  uint32_t* vals_out[] = {b->val_a, b->val_b, b->val_a, b->val_b};
  for (int pass = 0; pass < srt::kSortPasses; pass++) {
    uint32_t* status = b->scratch + pass * (tiles * srt::kRadix + 1);
    const SortPass sp{keys_in[pass], vals_in[pass], keys_out[pass],
                      vals_out[pass], b->stats + 1 + pass * srt::kRadix,
                      status, status + tiles * srt::kRadix, b->n, pass};
    radix_pass_kernel<<<(unsigned)tiles, kThreads, 0,
                        (cudaStream_t)stream>>>(sp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// perm: the m lanes of the next queue, in its order.
extern "C" int srt_compact_gather(const float* rec, const uint32_t* perm,
                                  int64_t m, float* q2, int64_t* q_id2,
                                  void* stream) {
  return srt::launch_persistent(compact_gather_kernel, kThreads, m,
                                (cudaStream_t)stream, rec, perm, m, q2,
                                q_id2);
}
