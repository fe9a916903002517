// Per-lane functions of the bounce stages (shade and scatter): the code
// that the shade and scatter kernels (vertex.cu, nvcc for sm_90a) run
// per thread and that the tests build for the CPU (vertex_host.cpp,
// g++) to hold it against the plain torch stages lane by lane.
//
// Each function repeats the expressions of its torch counterpart in the
// same order, so that with -fmad=false (nvcc) and -ffp-contract=off
// (g++) every operation rounds as there:
//   - pcg2d, make_key, uniform, uniform3: ops/rng.py, in uint32_t (the
//     torch code keeps 32-bit words in int64 and masks);
//   - random_unit_vector: ops/sampling.py;
//   - texel_coord and the atlas read: models/materials.py
//     _texel_coord / sample_texture;
//   - shade_lane: models/trace.py shade_lanes (barycentric normal and
//     UV, the instance's normal matrix, the normalize) and
//     materials.albedo_lanes;
//   - scatter_lane: materials.scatter, but only the branch of the lane's
//     material type is computed (the draws are counter-based, so the
//     chosen branch's bits do not depend on the others);
//   - queue_lane: the per-lane algebra of models/wavefront.py _bounce
//     (scatter, russian roulette, termination, contribution);
//   - path_lane: that of models/trace.py trace_step (the same, folded
//     into the lane's path state, updated in place).
// rsqrt is the one operation whose rounding the two torch builds do not
// share: torch's CUDA kernel calls rsqrtf, its CPU kernel divides 1 by
// the correctly rounded sqrt; rsqrt_ below does as each.

#pragma once

#include <math.h>
#include <stdint.h>

#include "walk_regs.cuh"

namespace srt {

// ---- RNG (ops/rng.py) ------------------------------------------------

constexpr uint32_t kLcgMult = 1664525u;
constexpr uint32_t kPcgMult = 747796405u;
constexpr uint32_t kGolden = 0x9E3779B9u;
// counter offsets of the scatter's second draw and of russian roulette
// (materials.scatter, trace.rr_survive)
constexpr uint32_t kDielectricDraw = 0x55555555u;
constexpr uint32_t kRouletteDraw = 0x33333333u;

struct U2 {
  uint32_t a, b;
};

SRT_HD U2 pcg2d(uint32_t a, uint32_t b) {
  a = a * kLcgMult + kGolden;
  b = b * kLcgMult + 0x85EBCA6Bu;
  a = a + b * kLcgMult;
  b = b + a * kLcgMult;
  a = a ^ (a >> 16);
  b = b ^ (b >> 16);
  a = a + b * kLcgMult;
  b = b + a * kLcgMult;
  a = a ^ (a >> 16);
  b = b ^ (b >> 16);
  return U2{a, b};
}

SRT_HD uint32_t make_key(uint32_t seed, uint32_t lane) {
  const U2 h = pcg2d(seed, lane);
  return h.a ^ (h.b * kPcgMult);
}

// top 24 bits -> [0, 1), exact in f32
SRT_HD float unit_float(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

SRT_HD float uniform(uint32_t key, uint32_t counter) {
  return unit_float(pcg2d(key, counter).a);
}

// ---- 3-vectors (ops/vec.py) -------------------------------------------

struct V {
  float x, y, z;
};

SRT_HD V operator+(V a, V b) { return V{a.x + b.x, a.y + b.y, a.z + b.z}; }
SRT_HD V operator-(V a, V b) { return V{a.x - b.x, a.y - b.y, a.z - b.z}; }
SRT_HD V operator*(V a, V b) { return V{a.x * b.x, a.y * b.y, a.z * b.z}; }
SRT_HD V operator*(V a, float s) { return V{a.x * s, a.y * s, a.z * s}; }
SRT_HD V operator-(V a) { return V{-a.x, -a.y, -a.z}; }
SRT_HD float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

SRT_HD float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// a * rsqrt(dot(a, a) + 1e-20), the normalize(eps=1e-20) of every caller
SRT_HD V normalize(V a) { return a * rsqrt_(dot(a, a) + 1e-20f); }

SRT_HD V reflect(V v, V n) { return v - n * (2.0f * dot(v, n)); }

// torch.clamp(x, max=hi) / (x, min=lo): NaN stays NaN
SRT_HD float clamp_hi(float x, float hi) { return x > hi ? hi : x; }
SRT_HD float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

SRT_HD V refract(V uv, V n, float eta) {
  const float cos_theta = clamp_hi(dot(-uv, n), 1.0f);
  const V r_out_perp = (uv + n * cos_theta) * eta;
  const float r_out_parallel =
      -sqrtf(fabsf(1.0f - dot(r_out_perp, r_out_perp)));
  return r_out_perp + n * r_out_parallel;
}

SRT_HD bool near_zero(V v) {
  return fabsf(v.x) < 1e-8f && fabsf(v.y) < 1e-8f && fabsf(v.z) < 1e-8f;
}

// ops/sampling.py: normalize(uniform cube in [-1, 1]^3); uniform3 is both
// pcg2d words at (key, counter) and the first at (key ^ golden, counter)
SRT_HD V random_unit_vector(uint32_t key, uint32_t counter) {
  const U2 h0 = pcg2d(key, counter);
  const uint32_t a1 = pcg2d(key ^ kGolden, counter).a;
  const V cube{unit_float(h0.a) * 2.0f - 1.0f,
               unit_float(h0.b) * 2.0f - 1.0f,
               unit_float(a1) * 2.0f - 1.0f};
  return normalize(cube);
}

// ---- loads --------------------------------------------------------------

template <class T>
SRT_HD T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

SRT_HD int64_t ldg(const int64_t* p) {
#ifdef __CUDA_ARCH__
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
#else
  return *p;
#endif
}

// ---- shade (models/trace.py shade_lanes, materials.albedo_lanes) --------

// The scene's shading tables (models/scene.py). inst_nmat is null on a
// scene without instances, tex_packed on a scene without textures.
struct ShadeTables {
  const float* shade_tbl;     // [LK, 16]: normals 0-8, uv 9-14, material
  const float* inst_nmat;     // [I, 9] or null
  const int64_t* mat_type;    // [M]
  const float* mat_albedo;    // [M, 3]
  const int64_t* mat_tex;     // [M]
  const float* mat_rough;     // [M]
  const float* mat_ior;       // [M]
  const float* mat_emissive;  // [M, 3]
  const int32_t* tex_packed;  // [T * res * res] RGBA8, or null
  int64_t inst_s8;            // shared rows per instance
  int32_t tex_res;
  int32_t pad_;
};

// A lane's shading record: the columns of the [kRec, n] f32 tensor that
// the shade stage writes and the scatter stage reads.
constexpr int kRec = 12;
struct ShadeRec {
  V normal;    // rows 0-2: unit normal
  V albedo;    // rows 3-5: with the texel applied
  V emissive;  // rows 6-8
  float mtype; // row 9: material type (0, 1, 2) as a float
  float rough; // row 10
  float ior;   // row 11
};

// float -> int32 with saturation, then a non-negative wrap
SRT_HD int64_t texel_coord(float c, int32_t res) {
  double f = (double)floorf(c * (float)res);
  f = f < -2147483648.0 ? -2147483648.0 : f;
  f = f > 2147483647.0 ? 2147483647.0 : f;
  const int64_t r = (int64_t)f % res;
  return r < 0 ? r + res : r;
}

SRT_HD V texel(const ShadeTables& s, int64_t tex, float u, float v) {
  const int32_t res = s.tex_res;
  const int64_t x = texel_coord(u, res);
  const int64_t y = texel_coord(v, res);
  const int64_t t = tex < 0 ? 0 : tex;
  const int32_t w = ldg(s.tex_packed + (t * res + y) * res + x);
  const float k = (float)(1.0 / 255.0);
  return V{(float)(w & 0xFF) * k, (float)((w >> 8) & 0xFF) * k,
           (float)((w >> 16) & 0xFF) * k};
}

// A hit lane's record (tri >= 0: the canonical slot, or inst * S8 + row
// on an instanced scene).
SRT_HD ShadeRec shade_lane(const ShadeTables& s, int64_t tri, float u,
                           float v) {
  int64_t row = tri;
  int64_t inst = 0;
  if (s.inst_nmat != nullptr) {
    inst = tri / s.inst_s8;
    row = tri % s.inst_s8;
  }
  const float* p = s.shade_tbl + row * 16;
  const F4 c0 = ld4(p), c1 = ld4(p + 4), c2 = ld4(p + 8), c3 = ld4(p + 12);
  const float w = 1.0f - u - v;
  float nx = w * c0.x + u * c0.w + v * c1.z;
  float ny = w * c0.y + u * c1.x + v * c1.w;
  float nz = w * c0.z + u * c1.y + v * c2.x;
  if (s.inst_nmat != nullptr) {
    const float* m = s.inst_nmat + inst * 9;
    float nm[9];
    SRT_UNROLL
    for (int k = 0; k < 9; k++) nm[k] = ldg(m + k);
    const float tx = nm[0] * nx + nm[1] * ny + nm[2] * nz;
    const float ty = nm[3] * nx + nm[4] * ny + nm[5] * nz;
    const float tz = nm[6] * nx + nm[7] * ny + nm[8] * nz;
    nx = tx;
    ny = ty;
    nz = tz;
  }
  ShadeRec r;
  r.normal = normalize(V{nx, ny, nz});
  const int64_t mid = (int64_t)c3.w;
  const int64_t tex = ldg(s.mat_tex + mid);
  if (s.tex_packed != nullptr && tex >= 0) {
    const float uv_u = w * c2.y + u * c2.w + v * c3.y;
    const float uv_v = w * c2.z + u * c3.x + v * c3.z;
    r.albedo = texel(s, tex, uv_u, uv_v);
  } else {
    r.albedo = V{ldg(s.mat_albedo + 3 * mid), ldg(s.mat_albedo + 3 * mid + 1),
                 ldg(s.mat_albedo + 3 * mid + 2)};
  }
  r.emissive = V{ldg(s.mat_emissive + 3 * mid),
                 ldg(s.mat_emissive + 3 * mid + 1),
                 ldg(s.mat_emissive + 3 * mid + 2)};
  r.mtype = (float)ldg(s.mat_type + mid);
  r.rough = ldg(s.mat_rough + mid);
  r.ior = ldg(s.mat_ior + mid);
  return r;
}

SRT_HD void store_rec(float* rec, int64_t n, int64_t i, const ShadeRec& r) {
  const float c[kRec] = {r.normal.x,   r.normal.y,   r.normal.z,
                         r.albedo.x,   r.albedo.y,   r.albedo.z,
                         r.emissive.x, r.emissive.y, r.emissive.z,
                         r.mtype,      r.rough,      r.ior};
  SRT_UNROLL
  for (int k = 0; k < kRec; k++) rec[k * n + i] = c[k];
}

SRT_HD ShadeRec load_rec(const float* rec, int64_t n, int64_t i) {
  float c[kRec];
  SRT_UNROLL
  for (int k = 0; k < kRec; k++) c[k] = ldg(rec + k * n + i);
  return ShadeRec{V{c[0], c[1], c[2]}, V{c[3], c[4], c[5]},
                  V{c[6], c[7], c[8]}, c[9], c[10], c[11]};
}

// ---- scatter (models/materials.py scatter) -------------------------------

constexpr int kDiffuse = 0;
constexpr int kMetallic = 1;
constexpr int kDielectric = 2;

struct Scattered {
  bool cont;
  V dir;  // not normalized (trace_ray.hpp:72-74)
  V att;
};

// material.hpp:120-125
SRT_HD float schlick(float cosine, float ref_idx) {
  float r0 = (1.0f - ref_idx) / (1.0f + ref_idx);
  r0 = r0 * r0;
  const float m = 1.0f - cosine;
  const float m2 = m * m;
  return r0 + (1.0f - r0) * (m2 * m2 * m);
}

// d_unit is the unit incoming direction; a type other than the three
// absorbs (cont false), as the torch selection does.
SRT_HD Scattered scatter_lane(const ShadeRec& s, V d_unit, uint32_t key,
                              uint32_t counter) {
  const int type = (int)s.mtype;
  const V n = s.normal;
  if (type == kDiffuse) {  // material.hpp:72-86
    const V dir = n + random_unit_vector(key, counter);
    return Scattered{true, near_zero(dir) ? n : dir, s.albedo};
  }
  if (type == kMetallic) {  // material.hpp:98-110
    const V dir = reflect(d_unit, n) + random_unit_vector(key, counter) *
                                           s.rough;
    return Scattered{dot(dir, n) > 0.0f, dir, s.albedo};
  }
  if (type == kDielectric) {  // material.hpp:127-156
    const float u1 = uniform(key, counter + kDielectricDraw);
    const bool front = dot(d_unit, n) < 0.0f;
    const V nf = front ? n : -n;
    const float ratio = front ? 1.0f / s.ior : s.ior;
    const float cos_t = clamp_hi(dot(-d_unit, nf), 1.0f);
    const float sin_t = sqrtf(clamp_lo(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = ratio * sin_t > 1.0f;
    const bool refl = cannot || schlick(cos_t, ratio) > u1;
    return Scattered{true, refl ? reflect(d_unit, nf)
                                : refract(d_unit, nf, ratio),
                     V{1.0f, 1.0f, 1.0f}};
  }
  return Scattered{false, d_unit, s.albedo};
}

// ---- the termination algebra -----------------------------------------------

constexpr float kRrFloor = 0.05f;  // models/trace.py RR_FLOOR

// One bounce's arguments, shared by both engines' scatter stage: the
// shading records, the hits' t and miss mask, the sky colour (device
// [3]), the draw counter (bounce + 2) and russian roulette (rr != 0 from
// bounce rr_start on, as in models/trace.py).
struct Bounce {
  const float* rec;      // [kRec, n]
  const float* hit_t;    // [n]
  const uint8_t* miss;   // [n]
  const float* sky;      // [3]
  int64_t n;
  uint32_t counter;
  int32_t rr;
  int32_t rr_start;
  int32_t pad_;
};

SRT_HD bool roulette_on(const Bounce& b) {
  return b.rr != 0 && (int64_t)b.counter - 2 >= b.rr_start;
}

// trace.rr_survive on the scattered attenuation: true and att scaled by
// 1/p, or false
SRT_HD bool roulette(V& att, uint32_t key, uint32_t counter) {
  const float m = att.y > att.z ? att.y : att.z;
  const float p = clamp_hi(clamp_lo(att.x > m ? att.x : m, kRrFloor), 1.0f);
  if (!(uniform(key, counter + kRouletteDraw) < p)) return false;
  const float inv_p = 1.0f / p;
  att = att * inv_p;
  return true;
}

SRT_HD V sky_term(const Bounce& b, V att, V rad) {
  return att * (V{ldg(b.sky), ldg(b.sky + 1), ldg(b.sky + 2)} + rad);
}

// The wavefront's queue (models/wavefront.py): rows of q are o, d, att,
// rad; the key of queue entry i is make_key(make_key(seed, sample_offset
// + q_id // n_pix), lane[q_id % n_pix]). Outputs: out rows new_dir,
// new_att, rad_hit (a miss lane writes d, att, rad), terminated, and
// contrib [n, 3], the colour a terminated ray adds to its pixel.
struct QueueIO {
  const float* q;         // [12, n]
  const int64_t* q_id;    // [n]
  const int64_t* lane;    // [n_pix]
  int64_t n_pix;
  int64_t sample_offset;
  float* out;             // [9, n]
  uint8_t* terminated;    // [n]
  float* contrib;         // [n, 3]
  uint32_t seed;
  int32_t pad_;
};

SRT_HD void queue_lane(const Bounce& b, const QueueIO& io, int64_t i) {
  const int64_t n = b.n;
  const float* q = io.q;
  const V d{ldg(q + 3 * n + i), ldg(q + 4 * n + i), ldg(q + 5 * n + i)};
  const V att{ldg(q + 6 * n + i), ldg(q + 7 * n + i), ldg(q + 8 * n + i)};
  const V rad{ldg(q + 9 * n + i), ldg(q + 10 * n + i), ldg(q + 11 * n + i)};
  V dir = d, new_att = att, rad_hit = rad, contrib;
  bool terminated = true;
  if (ldg(b.miss + i) != 0) {
    contrib = sky_term(b, att, rad);
  } else {
    const ShadeRec s = load_rec(b.rec, n, i);
    const int64_t qid = ldg(io.q_id + i);
    const int64_t pix = qid % io.n_pix;
    const uint32_t key = make_key(
        make_key(io.seed, (uint32_t)(io.sample_offset + qid / io.n_pix)),
        (uint32_t)ldg(io.lane + pix));
    const Scattered sc = scatter_lane(s, normalize(d), key, b.counter);
    rad_hit = rad + s.emissive;
    contrib = att * rad_hit;
    dir = sc.dir;
    new_att = att * sc.att;
    terminated = !sc.cont;
    if (sc.cont && roulette_on(b)) terminated = !roulette(new_att, key,
                                                          b.counter);
  }
  float* out = io.out;
  const float o9[9] = {dir.x,     dir.y,     dir.z,     new_att.x, new_att.y,
                       new_att.z, rad_hit.x, rad_hit.y, rad_hit.z};
  SRT_UNROLL
  for (int k = 0; k < 9; k++) out[k * n + i] = o9[k];
  io.terminated[i] = terminated ? 1 : 0;
  io.contrib[3 * i] = contrib.x;
  io.contrib[3 * i + 1] = contrib.y;
  io.contrib[3 * i + 2] = contrib.z;
}

// The megakernel's path state (models/trace.py PathState), updated in
// place: col rows o, d, att, rad, result (15 columns of n), done. A done
// lane reads its flag and nothing else.
struct PathIO {
  float* col[15];
  uint8_t* done;       // [n]
  const int64_t* key;  // [n]
};

SRT_HD V load3(float* const* col, int k, int64_t i) {
  return V{col[k][i], col[k + 1][i], col[k + 2][i]};
}

SRT_HD void store3(float* const* col, int k, int64_t i, V v) {
  col[k][i] = v.x;
  col[k + 1][i] = v.y;
  col[k + 2][i] = v.z;
}

SRT_HD void path_lane(const Bounce& b, const PathIO& io, int64_t i) {
  if (io.done[i] != 0) return;
  const V att = load3(io.col, 6, i);
  const V rad = load3(io.col, 9, i);
  if (ldg(b.miss + i) != 0) {
    store3(io.col, 12, i, sky_term(b, att, rad));
    io.done[i] = 1;
    return;
  }
  const ShadeRec s = load_rec(b.rec, b.n, i);
  const V d = load3(io.col, 3, i);
  const uint32_t key = (uint32_t)ldg(io.key + i);
  const Scattered sc = scatter_lane(s, normalize(d), key, b.counter);
  const V rad_hit = rad + s.emissive;
  V new_att = att * sc.att;
  if (!sc.cont || (roulette_on(b) && !roulette(new_att, key, b.counter))) {
    store3(io.col, 12, i, att * rad_hit);
    io.done[i] = 1;
    return;
  }
  store3(io.col, 0, i, load3(io.col, 0, i) + d * ldg(b.hit_t + i));
  store3(io.col, 3, i, sc.dir);
  store3(io.col, 6, i, new_att);
  store3(io.col, 9, i, rad_hit);
}

}  // namespace srt
