// Host build of the queue compaction in compact.cuh: the per-lane
// functions of compact.cu's key pass and gather, looped over lanes on
// the CPU, and the same stable radix sort (4 passes of 8-bit digits,
// lowest first, starting from the key pass's digit counts) as plain
// counting passes. The tests build this file with g++ and hold it
// against the plain compaction of models/wavefront.py, since no CUDA
// compiler runs there. The entry points take the arguments of
// compact.cu's, without the stream.

#include <string.h>

#include <vector>

#include "compact.cuh"

extern "C" void srt_compact_keys_host(const srt::CompactIn* in,
                                      const srt::CompactOut* out) {
  const srt::MortonBox box = srt::morton_box(in->scene_lo, in->scene_hi);
  for (int64_t i = 0; i < in->n; i++) {
    float rec[srt::kQueueRows];
    uint32_t key;
    if (srt::key_lane(*in, box, i, rec, &key)) {
      const srt::Rec64 r = srt::make_rec(rec, in->q_id[i]);
      memcpy(out->rec + i * srt::kRecFloats, &r, sizeof(r));
      out->stats[0]++;
    }
    out->key[i] = key;
    for (int p = 0; p < srt::kSortPasses; p++)
      out->stats[1 + p * srt::kRadix + srt::digit(key, p)]++;
  }
}

// Writes b->val_b only; key is left as it is.
extern "C" void srt_compact_sort_host(const srt::SortBufs* b) {
  const int64_t n = b->n;
  std::vector<uint32_t> cur(n), next(n);
  for (int64_t i = 0; i < n; i++) cur[i] = (uint32_t)i;
  for (int p = 0; p < srt::kSortPasses; p++) {
    uint64_t start[srt::kRadix], sum = 0;
    for (int d = 0; d < srt::kRadix; d++) {
      start[d] = sum;
      sum += b->stats[1 + p * srt::kRadix + d];
    }
    for (int64_t i = 0; i < n; i++)
      next[start[srt::digit(b->key[cur[i]], p)]++] = cur[i];
    cur.swap(next);
  }
  if (n > 0) memcpy(b->val_b, cur.data(), n * sizeof(uint32_t));
}

extern "C" void srt_compact_gather_host(const float* rec,
                                        const uint32_t* perm, int64_t m,
                                        float* q2, int64_t* q_id2) {
  for (int64_t j = 0; j < m; j++)
    srt::store_entry(srt::load_rec64(rec, perm[j]), m, j, q2, q_id2);
}
