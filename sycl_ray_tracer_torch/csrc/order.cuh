// Per-lane code of the order in which traverse8's masked entry walks the
// live lanes (traverse8.cu, nvcc for sm_90a), and what the tests build
// for the CPU (order_host.cpp, g++) to hold it against the plain order
// of ops/traverse8.py:
//   - a live lane's bucket is the top kOrderBits bits of the dir6_morton
//     key of its ray (compact.cuh coherence_key, the wavefront's sort
//     key, over the scene's box): direction octant, dominant axis, and
//     the top Morton bits of the origin;
//   - the key's bits 25-26 are always 0 and its dominant axis (bits
//     27-28) is at most 2, so the buckets that occur are 24 direction
//     classes of 2**(kOrderBits - 7) cells each; a bin numbers them
//     densely, in the buckets' order, so that a histogram of kOrderBins
//     counters covers them;
//   - the ordered entry gathers each live lane's ray and lane index
//     into a 32-byte record, the records in ascending order of bin
//     (store_record; the walk reads them back in schedule.cuh
//     walk_records).

#pragma once

#include <stdint.h>
#include <string.h>

#include "compact.cuh"

namespace srt {

// top bits of the key that make a bucket
constexpr int kOrderBits = 20;
constexpr int kCellBits = kOrderBits - 7;
constexpr int kOrderBins = 24 << kCellBits;

// The bin of a 32-bit dir6_morton key (octant, dominant axis, cell).
SRT_HD uint32_t order_bin(uint32_t key) {
  const uint32_t cls = (key >> 29) * 3u + (key >> 27 & 3u);
  const uint32_t cell = key >> (32 - kOrderBits) & ((1u << kCellBits) - 1u);
  return cls << kCellBits | cell;
}

// The bin of lane i's ray.
SRT_HD uint32_t lane_bin(const MortonBox& box, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, int64_t i) {
  return order_bin(coherence_key(box, V{ldg(ox + i), ldg(oy + i),
                                        ldg(oz + i)},
                                 V{ldg(dx + i), ldg(dy + i), ldg(dz + i)}));
}

// A record: origin, direction, the lane index's bits, one unused word.
constexpr int kRecordFloats = 8;

// Lane `lane`'s record at slot `slot` of rec (16-byte aligned).
SRT_HD void store_record(float* rec, int64_t slot, float ox, float oy,
                         float oz, float dx, float dy, float dz,
                         int64_t lane) {
  const int32_t l = (int32_t)lane;
  float w;
  memcpy(&w, &l, sizeof(w));
  float* p = rec + slot * kRecordFloats;
#ifdef __CUDA_ARCH__
  reinterpret_cast<float4*>(p)[0] = make_float4(ox, oy, oz, dx);
  reinterpret_cast<float4*>(p)[1] = make_float4(dy, dz, w, 0.0f);
#else
  const float v[kRecordFloats] = {ox, oy, oz, dx, dy, dz, w, 0.0f};
  memcpy(p, v, sizeof(v));
#endif
}

}  // namespace srt
