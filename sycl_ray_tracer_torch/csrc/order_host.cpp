// Host build of the walk's order in order.cuh: what traverse8.cu's
// ordered entry (srt_traverse8_order) computes, with the same per-lane
// bin and record, as a stable counting sort on the CPU, so that within
// a bin the lanes keep lane order. The tests build this file with g++
// and hold it against the plain order of ops/traverse8.py, since no CUDA
// compiler runs there. The entry point takes the arguments of the
// card's, without the stream.

#include <string.h>

#include <vector>

#include "order.cuh"

extern "C" void srt_traverse8_order_host(
    const uint8_t* active, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* scene_lo,
    const float* scene_hi, float* t_out, int32_t* tri_out, float* u_out,
    float* v_out, int64_t n, float* rec, uint64_t* counters) {
  const srt::MortonBox box = srt::morton_box(scene_lo, scene_hi);
  std::vector<uint32_t> bins(srt::kOrderBins, 0);
  for (int64_t i = 0; i < n; i++) {
    if (active[i] != 0) {
      const uint32_t bin = srt::lane_bin(box, ox, oy, oz, dx, dy, dz, i);
      const uint32_t place = bins[bin]++;
      tri_out[i] = (int32_t)bin;
      memcpy(&u_out[i], &place, sizeof(place));
      counters[0]++;
    } else {
      t_out[i] = 0.0f;
      tri_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
    }
  }
  uint32_t first = 0;
  for (uint32_t& b : bins) {
    const uint32_t c = b;
    b = first;
    first += c;
  }
  for (int64_t i = 0; i < n; i++) {
    if (active[i] == 0) continue;
    uint32_t place;
    memcpy(&place, &u_out[i], sizeof(place));
    srt::store_record(rec, bins[tri_out[i]] + place, ox[i], oy[i], oz[i],
                      dx[i], dy[i], dz[i], i);
  }
}

extern "C" int srt_order_bins() { return srt::kOrderBins; }
