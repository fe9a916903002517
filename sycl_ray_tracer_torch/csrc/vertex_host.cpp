// Host build of the bounce stages in vertex.cuh: the per-lane functions
// the shade and scatter kernels (vertex.cu) run per thread, looped over
// lanes on the CPU. The tests build this file with g++ and hold it
// against the plain torch stages (models/trace.py, models/wavefront.py),
// since no CUDA compiler runs there. The entry points take the
// arguments of vertex.cu's, without the stream.

#include "vertex.cuh"

extern "C" void srt_shade_host(const srt::ShadeTables* tables,
                               const void* tri, int32_t tri_bytes,
                               const float* u, const float* v, float* rec,
                               int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const int64_t t = tri_bytes == 8 ? ((const int64_t*)tri)[i]
                                     : (int64_t)((const int32_t*)tri)[i];
    if (t >= 0) srt::store_rec(rec, n, i, srt::shade_lane(*tables, t, u[i],
                                                          v[i]));
  }
}

extern "C" void srt_scatter_queue_host(const srt::Bounce* bounce,
                                       const srt::QueueIO* io) {
  for (int64_t i = 0; i < bounce->n; i++) srt::queue_lane(*bounce, *io, i);
}

extern "C" void srt_scatter_paths_host(const srt::Bounce* bounce,
                                       const srt::PathIO* io) {
  for (int64_t i = 0; i < bounce->n; i++) srt::path_lane(*bounce, *io, i);
}

// The per-lane pieces alone, for the tests: each entry loops one
// function of vertex.cuh over n lanes (32-bit words in int64, vectors as
// [3, n] rows).

// make_key(a, b), uniform(a, b), uniform3(a, b), random_unit_vector(a, b)
extern "C" void srt_draws_host(const int64_t* a, const int64_t* b,
                               int64_t n, int64_t* key, float* uni,
                               float* uni3, float* ruv) {
  for (int64_t i = 0; i < n; i++) {
    const uint32_t x = (uint32_t)a[i], y = (uint32_t)b[i];
    key[i] = srt::make_key(x, y);
    uni[i] = srt::uniform(x, y);
    const srt::U2 h0 = srt::pcg2d(x, y);
    uni3[i] = srt::unit_float(h0.a);
    uni3[n + i] = srt::unit_float(h0.b);
    uni3[2 * n + i] = srt::unit_float(srt::pcg2d(x ^ srt::kGolden, y).a);
    const srt::V v = srt::random_unit_vector(x, y);
    ruv[i] = v.x;
    ruv[n + i] = v.y;
    ruv[2 * n + i] = v.z;
  }
}

// scatter_lane on shading records rec [12, n] and unit directions
extern "C" void srt_scatter_lane_host(const float* rec, const float* d_unit,
                                      const int64_t* key, uint32_t counter,
                                      int64_t n, uint8_t* cont, float* dir,
                                      float* att) {
  for (int64_t i = 0; i < n; i++) {
    const srt::Scattered s = srt::scatter_lane(
        srt::load_rec(rec, n, i),
        srt::V{d_unit[i], d_unit[n + i], d_unit[2 * n + i]},
        (uint32_t)key[i], counter);
    cont[i] = s.cont ? 1 : 0;
    const float c[6] = {s.dir.x, s.dir.y, s.dir.z, s.att.x, s.att.y, s.att.z};
    for (int k = 0; k < 3; k++) {
      dir[k * n + i] = c[k];
      att[k * n + i] = c[3 + k];
    }
  }
}

// roulette on attenuations att [3, n], scaled in place where a lane
// survives
extern "C" void srt_roulette_host(float* att, const int64_t* key,
                                  uint32_t counter, int64_t n,
                                  uint8_t* survive) {
  for (int64_t i = 0; i < n; i++) {
    srt::V a{att[i], att[n + i], att[2 * n + i]};
    survive[i] = srt::roulette(a, (uint32_t)key[i], counter) ? 1 : 0;
    att[i] = a.x;
    att[n + i] = a.y;
    att[2 * n + i] = a.z;
  }
}
