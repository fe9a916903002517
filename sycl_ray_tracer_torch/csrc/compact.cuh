// Per-lane code of the wavefront's queue compaction: what the key pass
// of compact.cu (nvcc for sm_90a) runs per thread and what the tests
// build for the CPU (compact_host.cpp, g++) to hold it against the plain
// compaction of models/wavefront.py bit for bit:
//   - the new origin o + d * t, with no multiply-add (-fmad=false,
//     -ffp-contract=off), as the eager ops round it;
//   - the dir6_morton key of models/wavefront.py _coherence_key:
//     direction octant << 29 | dominant axis << 27 | Morton code of the
//     new origin >> 5, the Morton code as ops/lbvh.py morton30 computes
//     it (clamp of the extent to 1e-20, of the cell to 1 - 1e-7 rounded
//     to f32, NaN carried through the clamp as torch does);
//   - live keys clamped one below the dead sentinel 0xFFFFFFFF (models/
//     wavefront.py _compact);
//   - the counts of each 8-bit digit of the keys, which the radix sort's
//     passes start from (one pass a digit, lowest first);
//   - the record the gather reads: new origin, direction, attenuation
//     and radiance (the next queue's 12 rows of one lane) and its queue
//     id, 64 bytes, so that one record is one 64-byte aligned block.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "vertex.cuh"

namespace srt {

constexpr uint32_t kDeadKey = 0xFFFFFFFFu;
constexpr int kQueueRows = 12;
// the radix sort: 4 passes of 8-bit digits
constexpr int kRadix = 256;
constexpr int kSortPasses = 4;
// a record's floats: the 12 rows, the queue id's two words, two unused
constexpr int kRecFloats = 16;

// The key pass's inputs: the bounce's queue and hits, the scatter
// stage's new direction, attenuation and radiance, and the scene's box.
struct CompactIn {
  const float* q;             // [12, n]: origin rows 0-2, direction 3-5
  const int64_t* q_id;        // [n]
  const float* hit_t;         // [n]
  const float* rows[9];       // [n] each: new direction, att, radiance
  const uint8_t* terminated;  // [n]
  const float* scene_lo;      // [3]
  const float* scene_hi;      // [3]
  int64_t n;
};

struct CompactOut {
  float* rec;      // [n, 16], row-major; a dead lane's row is not written
  uint32_t* key;   // [n]
  uint64_t* stats;  // [1 + 4 * 256], zeroed: live lanes, digit counts
};

// The radix sort's buffers, all [n] but the scratch: key (the key
// pass's, which the card's passes reuse as scratch), key_alt and val_a
// (scratch), val_b (out: the lanes in stable ascending order of key).
struct SortBufs {
  uint32_t* key;
  uint32_t* key_alt;
  uint32_t* val_a;
  uint32_t* val_b;
  const uint64_t* stats;  // the key pass's: live lanes, digit counts
  uint32_t* scratch;      // srt_compact_sort_scratch(n) words, zeroed
  int64_t n;
};

// Digit `pass` of a key, lowest first.
SRT_HD uint32_t digit(uint32_t key, int pass) {
  return key >> (8 * pass) & (kRadix - 1);
}

// ops/lbvh.py _expand_bits
SRT_HD uint32_t expand_bits(uint32_t x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// torch.clamp: NaN stays NaN
SRT_HD float clamp_(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// morton30's upper clamp of a cell coordinate, 1 - 1e-7 rounded to f32
constexpr float kMortonTop = 0.99999988079071044921875f;

// One axis's Morton cell (morton30's q * 1024 cast to int64).
SRT_HD uint32_t morton_cell(float p, float lo, float extent) {
  const float q = clamp_((p - lo) / extent, 0.0f, kMortonTop);
  return (uint32_t)(int64_t)(q * 1024.0f);
}

// The box's lower corner and its extent clamped to 1e-20, as morton30.
struct MortonBox {
  V lo, extent;
};

SRT_HD MortonBox morton_box(const float* lo, const float* hi) {
  V l{ldg(lo), ldg(lo + 1), ldg(lo + 2)};
  V h{ldg(hi), ldg(hi + 1), ldg(hi + 2)};
  const float e = 1e-20f;
  return MortonBox{l, V{clamp_(h.x - l.x, e, INFINITY),
                        clamp_(h.y - l.y, e, INFINITY),
                        clamp_(h.z - l.z, e, INFINITY)}};
}

// _coherence_key(o, d), clamped below the dead sentinel.
SRT_HD uint32_t coherence_key(const MortonBox& box, V o, V d) {
  const uint32_t oct = (uint32_t)(d.x < 0.0f) << 2 |
                       (uint32_t)(d.y < 0.0f) << 1 | (uint32_t)(d.z < 0.0f);
  const uint32_t m = expand_bits(morton_cell(o.x, box.lo.x, box.extent.x))
                         << 2 |
                     expand_bits(morton_cell(o.y, box.lo.y, box.extent.y))
                         << 1 |
                     expand_bits(morton_cell(o.z, box.lo.z, box.extent.z));
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const uint32_t dom = ax > ay ? (ax > az ? 0u : 2u) : (ay > az ? 1u : 2u);
  const uint32_t key = oct << 29 | dom << 27 | m >> 5;
  return key < kDeadKey - 1u ? key : kDeadKey - 1u;
}

// Lane i's record (rec[0..12)) and sort key; returns whether it lives.
// A dead lane reads only its flag and gets the sentinel.
SRT_HD bool key_lane(const CompactIn& in, const MortonBox& box, int64_t i,
                     float rec[kQueueRows], uint32_t* key) {
  if (ldg(in.terminated + i) != 0) {
    *key = kDeadKey;
    return false;
  }
  const int64_t n = in.n;
  const V o{ldg(in.q + i), ldg(in.q + n + i), ldg(in.q + 2 * n + i)};
  const V d{ldg(in.q + 3 * n + i), ldg(in.q + 4 * n + i),
            ldg(in.q + 5 * n + i)};
  const V new_o = o + d * ldg(in.hit_t + i);
  rec[0] = new_o.x;
  rec[1] = new_o.y;
  rec[2] = new_o.z;
  SRT_UNROLL
  for (int k = 0; k < 9; k++) rec[3 + k] = ldg(in.rows[k] + i);
  *key = coherence_key(box, new_o, V{rec[3], rec[4], rec[5]});
  return true;
}

// A lane's 64-byte record: the 12 rows, then the queue id's two words and
// two unused words.
struct Rec64 {
  F4 part[4];
};

SRT_HD Rec64 make_rec(const float r[kQueueRows], int64_t qid) {
  float w[2];
  memcpy(w, &qid, sizeof(qid));
  return Rec64{{F4{r[0], r[1], r[2], r[3]}, F4{r[4], r[5], r[6], r[7]},
                F4{r[8], r[9], r[10], r[11]}, F4{w[0], w[1], 0.0f, 0.0f}}};
}

// Record p of rec [n, 16] (64-byte aligned): four 16-byte loads.
SRT_HD Rec64 load_rec64(const float* rec, int64_t p) {
  const float* r = rec + p * kRecFloats;
  return Rec64{{ld4(r), ld4(r + 4), ld4(r + 8), ld4(r + 12)}};
}

// Entry j of the next queue from a record: column j of q2 [12, m] and
// q_id2 [m].
SRT_HD void store_entry(const Rec64& r, int64_t m, int64_t j, float* q2,
                        int64_t* q_id2) {
  SRT_UNROLL
  for (int k = 0; k < kQueueRows; k++)
    q2[k * m + j] = part(r.part[k / 4], k % 4);
  const float w[2] = {r.part[3].x, r.part[3].y};
  int64_t qid;
  memcpy(&qid, w, sizeof(qid));
  q_id2[j] = qid;
}

}  // namespace srt
