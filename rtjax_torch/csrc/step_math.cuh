// Device functions of the fused wavefront step (csrc/step_kernels.cu):
// each mirrors, op for op, the torch code of the plain version it stands
// for (kernels/step.py and the modules it calls), so that a lane's result
// is the plain version's bit for bit.
//
// Exactness rules (the library builds with --fmad=false, so no multiply
// and add contract, as none contract between torch's one-op kernels):
// - every expression keeps the torch code's operation order;
// - ``1.0 / x`` is torch's ``reciprocal(x) * 1.0``: the IEEE quotient;
// - a tensor divided by a host scalar is, on the card, a product with the
//   scalar's float reciprocal (torch's ``div_true`` for a CPU scalar);
//   a division by a tensor is the IEEE quotient;
// - ``torch.clamp`` returns a NaN input unchanged, ``torch.maximum``
//   propagates NaN; ``torch.round`` rounds half to even (rintf);
//   ``.to(torch.int32)`` truncates (cvt.rzi); ``.view`` reinterprets bits;
// - sqrtf, sinf and cosf are the CUDA math library's, as torch's kernels
//   call them.
//
// Two designs share this math (kernels/step.py): the record design (the
// default) and the first design (kV1, kept for same-run A/B).
// They differ in the bundle's layout and in where shade's material comes
// from, not in any operation on a value.
//
// The full-record modes (kMode: the unsorted engine kUnsorted,
// reference_parity kParity, both kParityUnsorted, and the sorted engine's
// wide bundle kWide) carry a lane's state at full precision (kFullWords
// words, kernels/step.py FULL_LAYOUT); all but kWide rank the camera rays
// by an exclusive prefix sum over blocks, by a warp's look-back on a
// persistent scratch (rank_*): the parity modes' route in slot order,
// into the record, and the unsorted engine's route and shade after its
// shading (the first designs' shade by a look-back scan before it,
// scan_*).  One-sample MIS (kOneSample, shade and
// resolve) and detailed_stats' bounce histogram (kStats, resolve) are
// template flags beside kMode.  Each mode's and flag's code paths compile
// out of the other instances under ``if constexpr``.

#pragma once

#include <math.h>

namespace rtjax_step {

// ---------------------------------------------------------------- the args

// One argument block for the three kernels, field for field kernels/step.py
// ``ARG_FIELDS`` (tests/test_torch_step_kernels.py holds the two equal):
// pointers first, then 64-bit, 32-bit integer and float scalars.  Vectors
// are three [n] columns; the shadow columns hold 2n lanes, NEE first.
struct StepArgs {
  // the path state [n]; shade writes pixel, rays, beta, bounces and acc
  int* pixel;
  float* ray_o[3];
  float* ray_d[3];
  const unsigned char* hit;
  const float* t;
  const float* normal[3];
  const int* prim;
  const int* src;
  int* bounces;
  float* beta[3];
  float* acc[3];
  const long long* words;  // [5, n]
  // route -> sort -> shade -> resolve
  int* keys;               // [n]
  int* bundle;             // [n, 10] records ([9, n] columns: kV1)
  long long* counts;       // [5]: continuing paths, path, NEE, MIS rays,
                           // dirty lanes
  const long long* order;  // [n], the sort's permutation
  const long long* it;     // null: it_value
  const long long* cam_start;
  float* fb;               // [num_pixels, 3]
  unsigned char* trace_mask;
  float* sh_o[3];          // [2n]
  float* sh_d[3];
  float* sh_tmax;
  int* sh_exclude;
  unsigned char* sh_mask;
  float* ah_L[3];          // [n]
  float* chs_L[3];
  const unsigned char* occluded;  // [2n]
  const double* rays_in;
  const double* occ_in;
  long long* cam_out;
  unsigned char* work_out;
  double* rays_out;
  double* occ_out;
  // the full-record modes: the camera rank's scan (shade's: the ticket,
  // the finished blocks, then one status word a shade block, zero between
  // launches; the parity modes' route: the rank's persistent scratch as
  // 32-bit words, rank_*), each position's limbo flag (shade -> resolve)
  // and the closest hits resolve restores limbo lanes into
  long long* scan;
  unsigned char* limbo;
  unsigned char* hit_out;
  float* t_out;
  float* normal_out[3];
  int* prim_out;
  int* src_out;
  // one-sample MIS: the BSDF-MIS channel's mask (shade -> resolve; resolve
  // reads the path rays' closest hits through hit, prim and src);
  // detailed_stats: the bounce histogram [max_bounces + 1] resolve adds to
  unsigned char* chs_mask;
  long long* hist;
  // the scene and the camera
  const int* prim_light;     // [num_prims]
  const int* prim_material;  // [num_prims]
  const int* inst_material;  // [instances], null for a single-level scene
  const int* mtype;          // [num_materials]
  const float* albedo;       // [num_materials, 3]
  const float* ior;
  const int* ltype;          // [num_light_rows]
  const float* lpos;         // [num_light_rows, 3]
  const float* lemit;
  const int* ltri;
  const float* ltp0;
  const float* lte1;
  const float* lte2;
  const float* ltn;
  const float* env;          // [3]
  const float* root_lo;      // the BVH root box, row 0 of [nodes, 3]
  const float* root_hi;
  const float* lookfrom;     // [3] each
  const float* upper_left;
  const float* horizontal;
  const float* vertical;
  const int* pixel_table;    // [num_pixels], null in scanline order
  const float* tri_p0;       // [num_tris, 3] the base scene's triangles
  const float* tri_e1;       // (parity's BSDF-MIS target), else null
  const float* tri_e2;
  const float* tri_n;
  long long it_value;
  int n;
  int num_prims;
  int num_tris;
  int num_materials;
  int num_light_rows;
  int num_lights;
  int max_bounces;
  int rr_start;
  int sort_key;     // index into config.SORT_KEYS
  int sort_every;   // the resolved cadence k
  int spp;
  int num_pixels;
  int width;
  int height;
  int cam_end;      // total camera rays
  float rr_threshold;
};

// ----------------------------------------------------------- constants

constexpr int kDeadBounces = 1 << 30;
// the step's modes (kernels/step.py step_mode): flags of the template
// parameter kMode
constexpr int kDefault = 0, kUnsorted = 1, kParity = 2,
              kParityUnsorted = kParity | kUnsorted, kWide = 4;
constexpr int kFullWords = 24;   // kernels/step.py FULL_ROWS
constexpr int kScanBlock = 128;  // lanes a shade block ranks
constexpr int kInactiveKey = 0x7FFFFFFF;
constexpr int kDirtyKey = 0x7FFFFFFE;
constexpr int kMaxLiveKey = 0x7FFFFFFD;
constexpr int kMatte = 0, kMirror = 1, kGlass = 2;
constexpr int kPointLight = 0, kAreaLight = 1;
// config.SORT_KEYS
constexpr int kMorton = 0, kMortonPos = 1, kMortonPos10 = 2, kPrim = 3,
              kPrimPos = 4, kNormalPos = 5;
// the Python constants as torch casts them: double, then float
#define RTJAX_F(x) static_cast<float>(x)
constexpr double kPi = 3.141592653589793;

// ----------------------------------------------------- scalar primitives

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_minf(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_maxf(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float maximumf(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// a / b with b a host scalar, as torch computes it on the card
__device__ __forceinline__ float div_host(float a, float b) {
  return a * (1.0f / b);
}
// floor division (torch.div(rounding_mode="floor")) of int32
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// Python-style remainder (torch's %) of int32
__device__ __forceinline__ int remainder(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
// int32 arithmetic that wraps, as torch's does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}
__device__ __forceinline__ int shl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}
// core/rng.py u01_pair: the high and the low 16 bits as U[0, 1)
__device__ __forceinline__ float u01_hi(long long w) {
  return static_cast<float>(w >> 16) * RTJAX_F(1.0 / 65536.0);
}
__device__ __forceinline__ float u01_lo(long long w) {
  return static_cast<float>(w & 0xFFFF) * RTJAX_F(1.0 / 65536.0);
}

// -------------------------------------------------------------- vectors

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }
// core/vec.py normalize: 1 / length, then scale
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = 1.0f / length(a);
  return scale(inv, a);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
__device__ __forceinline__ float vmax(V3 a) {
  return maximumf(maximumf(a.x, a.y), a.z);
}
__device__ __forceinline__ V3 load3(float* const c[3], long long i) {
  return {c[0][i], c[1][i], c[2][i]};
}
__device__ __forceinline__ V3 load3(const float* const c[3], long long i) {
  return {c[0][i], c[1][i], c[2][i]};
}
__device__ __forceinline__ void store3(float* const c[3], long long i,
                                       V3 v) {
  c[0][i] = v.x;
  c[1][i] = v.y;
  c[2][i] = v.z;
}
// row r of a [rows, 3] table
__device__ __forceinline__ V3 row3(const float* t, int r) {
  return {t[3 * r], t[3 * r + 1], t[3 * r + 2]};
}
// kernels/step.py accum: add where the mask holds and all three are finite
__device__ __forceinline__ V3 accum(V3 acc, V3 v, bool mask) {
  const bool ok = mask && finite3(v);
  return {acc.x + (ok ? v.x : 0.0f), acc.y + (ok ? v.y : 0.0f),
          acc.z + (ok ? v.z : 0.0f)};
}

// ------------------------------------------------------- render/sorting.py

__device__ __forceinline__ int part1by2(int x) {
  x = (x | shl(x, 16)) & 0x030000FF;
  x = (x | shl(x, 8)) & 0x0300F00F;
  x = (x | shl(x, 4)) & 0x030C30C3;
  x = (x | shl(x, 2)) & 0x09249249;
  return x;
}
// _morton: the cell of p in a (cells_max + 1)^3 grid over the root box
__device__ __forceinline__ int morton(const StepArgs& a, V3 p,
                                      float cells_max) {
  const float pc[3] = {p.x, p.y, p.z};
  int c[3];
  for (int k = 0; k < 3; ++k) {
    const float lo = a.root_lo[k];
    const float span = clamp_minf(a.root_hi[k] - lo, RTJAX_F(1e-30));
    const float g = (pc[k] - lo) / span;
    c[k] = static_cast<int>(clampf(g * cells_max, 0.0f, cells_max));
  }
  return part1by2(c[0]) | shl(part1by2(c[1]), 1) | shl(part1by2(c[2]), 2);
}
__device__ __forceinline__ int octant3(V3 d) {
  return (d.x < 0.0f ? 1 : 0) | (d.y < 0.0f ? 2 : 0) | (d.z < 0.0f ? 4 : 0);
}
// the seven ray_sort_keys_*_v3 of an active lane (``bounces`` already
// incremented, as the engine passes it)
__device__ __forceinline__ int sort_key(const StepArgs& a, V3 hp, V3 d,
                                        V3 nrm, int prim, int bounces) {
  const int prim24 = clampi(prim, 0, (1 << 24) - 1);
  switch (a.sort_key) {
    case kMorton:
      return shl(octant3(d), 27) | morton(a, hp, 511.0f);
    case kMortonPos:
      return shl(morton(a, hp, 511.0f), 3) | octant3(d);
    case kMortonPos10:
      return morton(a, hp, 1023.0f);
    case kPrim:
      return shl(octant3(d), 24) | prim24;
    case kPrimPos:
      return shl(prim24, 3) | octant3(d);
    case kNormalPos:
      return shl(morton(a, hp, 511.0f), 3) | octant3(nrm);
    default: {  // adaptive
      const int m = morton(a, hp, 511.0f);
      const int oc = octant3(nrm);
      const int key = bounces >= 2 ? ((1 << 30) | shl(oc, 27) | m)
                                   : (shl(m, 3) | oc);
      return min(key, kMaxLiveKey);
    }
  }
}

// oct_encode_v3: 16 + 16-bit octahedral direction
__device__ __forceinline__ int oct_encode(V3 n) {
  const float l1 = fabsf(n.x) + fabsf(n.y) + fabsf(n.z);
  const float inv = 1.0f / clamp_minf(l1, RTJAX_F(1e-37));
  const float px = n.x * inv, py = n.y * inv;
  const float sx = px >= 0.0f ? 1.0f : -1.0f;
  const float sy = py >= 0.0f ? 1.0f : -1.0f;
  const bool fold = n.z < 0.0f;
  const float fx = fold ? (1.0f - fabsf(py)) * sx : px;
  const float fy = fold ? (1.0f - fabsf(px)) * sy : py;
  const int qx = static_cast<int>(clampf((fx + 1.0f) * 32767.5f, 0.0f,
                                         65535.0f));
  const int qy = static_cast<int>(clampf((fy + 1.0f) * 32767.5f, 0.0f,
                                         65535.0f));
  return shl(qx, 16) | qy;
}
__device__ __forceinline__ V3 oct_decode(int w) {
  const float s = RTJAX_F(2.0 / 65535.0);
  float px = static_cast<float>((w >> 16) & 0xFFFF) * s - 1.0f;
  float py = static_cast<float>(w & 0xFFFF) * s - 1.0f;
  const float z = 1.0f - fabsf(px) - fabsf(py);
  const float t = clampf(-z, 0.0f, 1.0f);
  px = px + (px >= 0.0f ? -t : t);
  py = py + (py >= 0.0f ? -t : t);
  return {px, py, z};
}
// rgb9e5_encode_v3 / rgb9e5_decode_v3: shared-exponent RGB
__device__ __forceinline__ float rgb_sanitise(float c) {
  return clampf(isfinite(c) ? c : 0.0f, 0.0f,
                RTJAX_F(511.0 / 512.0 * 65536.0));
}
__device__ __forceinline__ int rgb9e5_encode(V3 v) {
  const float r = rgb_sanitise(v.x), g = rgb_sanitise(v.y),
              b = rgb_sanitise(v.z);
  const float m = maximumf(maximumf(r, g), b);
  const int eb = (__float_as_int(clamp_minf(m, RTJAX_F(2e-10))) >> 23) &
                 0xFF;
  int es = clampi(eb - 127, -16, 15) + 1;
  float sc = __int_as_float(shl(es + 118, 23));
  const bool bump = maximumf(maximumf(rintf(r / sc), rintf(g / sc)),
                             rintf(b / sc)) >= 512.0f;
  es = bump ? es + 1 : es;
  sc = bump ? sc * 2.0f : sc;
  const int er = static_cast<int>(clamp_maxf(rintf(r / sc), 511.0f));
  const int eg = static_cast<int>(clamp_maxf(rintf(g / sc), 511.0f));
  const int ebl = static_cast<int>(clamp_maxf(rintf(b / sc), 511.0f));
  return er | shl(eg, 9) | shl(ebl, 18) | shl(es + 15, 27);
}
__device__ __forceinline__ V3 rgb9e5_decode(int w) {
  const int es = (w >> 27) & 31;
  const float sc = __int_as_float(shl(es + 103, 23));
  return {static_cast<float>(w & 511) * sc,
          static_cast<float>((w >> 9) & 511) * sc,
          static_cast<float>((w >> 18) & 511) * sc};
}

// --------------------------------------------- core/sampling.py, geometry

// offset_ray_origin_v3: Wachter & Binder's self-intersection offset
__device__ __forceinline__ float offset_component(float p, float n) {
  const int of_i = static_cast<int>(truncf(256.0f * n));
  const int bits = wrap_add(__float_as_int(p), p < 0.0f ? -of_i : of_i);
  return fabsf(p) < RTJAX_F(1.0 / 32.0)
             ? p + RTJAX_F(1.0 / 65536.0) * n
             : __int_as_float(bits);
}
__device__ __forceinline__ V3 offset_origin(V3 p, V3 n) {
  return {offset_component(p.x, n.x), offset_component(p.y, n.y),
          offset_component(p.z, n.z)};
}
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float f2 = f * f;
  return f2 / (f2 + g * g);
}
// intersect_triangle_v3: Moeller-Trumbore with the reference's accept rule
__device__ __forceinline__ bool intersect_triangle(V3 o, V3 d, float tmax,
                                                   V3 p0, V3 e1, V3 e2,
                                                   V3 n, float* t_out,
                                                   float* u_out,
                                                   float* v_out) {
  const V3 c = sub(p0, o);
  const V3 r = cross(d, c);
  const float inv_det = 1.0f / dot(d, n);
  const float u = inv_det * dot(e2, r);
  const float v = inv_det * dot(e1, r);
  const float t = inv_det * dot(c, n);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f && t <= tmax;
}

// --------------------------------------------------- scene/material.py

struct Bsdf {
  V3 f, wi, n;
  float pdf;
};

__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  const float d = 2.0f * dot(v, n);
  return {v.x - d * n.x, v.y - d * n.y, v.z - d * n.z};
}
__device__ __forceinline__ V3 refract(V3 v, V3 n, float eta, float cos_t) {
  const V3 par = scale(eta, add(v, scale(cos_t, n)));
  const float perp_sq = clamp_minf(1.0f - dot(par, par), 0.0f);
  const float k = -sqrtf(perp_sq);
  return add(par, scale(k, n));
}
// sample_f_v3: the selected material's branch of the branchless sampler
__device__ __forceinline__ Bsdf sample_f(int mtype, V3 albedo, float ior,
                                         V3 wo, V3 n, float u1, float u2,
                                         float u3) {
  const V3 n_opp = dot(wo, n) > 0.0f ? neg(n) : n;
  const float inv_pi = RTJAX_F(1.0 / kPi);
  Bsdf r;
  r.n = n_opp;
  if (mtype == kMatte) {
    const float z = 1.0f - 2.0f * u1;
    const float rad = sqrtf(clamp_minf(1.0f - z * z, 0.0f));
    const float phi = RTJAX_F(2.0 * kPi) * u2;
    const V3 s = {rad * cosf(phi), rad * sinf(phi), z};
    r.wi = normalize(add(n_opp, s));
    r.pdf = dot(r.wi, n_opp) * inv_pi;
    r.f = scale(inv_pi, albedo);
    return r;
  }
  if (mtype == kMirror) {
    r.wi = reflect(wo, n_opp);
    r.pdf = 1.0f;
    r.f = scale(1.0f / dot(r.wi, n_opp), albedo);
    return r;
  }
  float cos_t = dot(wo, n);
  const bool front = cos_t < 0.0f;
  cos_t = fabsf(cos_t);
  const float inv_cos = 1.0f / cos_t;
  const float eta = front ? 1.0f / ior : ior;
  const float sin_t = sqrtf(clamp_minf(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot_refract = eta * sin_t > 1.0f;
  float r0 = (1.0f - ior) / (ior + 1.0f);
  r0 = r0 * r0;
  const float x = 1.0f - cos_t;
  const float x2 = x * x;
  const float x5 = x * (x2 * x2);   // lax.integer_pow's chain
  const float reflectance = r0 + (1.0f - r0) * x5;
  const bool do_reflect = cannot_refract || u3 < reflectance;
  const V3 n_front = front ? n : neg(n);
  float f_s;
  V3 n_glass;
  if (do_reflect) {
    r.wi = reflect(wo, n_front);
    r.pdf = cannot_refract ? 1.0f : reflectance;
    f_s = cannot_refract ? inv_cos : reflectance * inv_cos;
    n_glass = n_front;
  } else {
    r.wi = refract(wo, n_front, eta, cos_t);
    r.pdf = 1.0f - reflectance;
    n_glass = neg(n_front);
    f_s = r.pdf * eta * eta / dot(r.wi, n_glass);
  }
  r.f = {f_s, f_s, f_s};
  if (mtype == kGlass) r.n = n_glass;
  return r;
}

// ------------------------------------------------------ scene/light.py

// The scene's small tables a lane reads: the materials and the light rows,
// in global memory or staged in the block's shared memory (the same values).
struct Tables {
  const int* mtype;     // [num_materials]
  const float* albedo;  // [num_materials, 3]
  const float* ior;
  const int* ltype;     // [num_light_rows]
  const int* ltri;
  const float* lpos;    // [num_light_rows, 3]
  const float* lemit;
  const float* ltp0;
  const float* lte1;
  const float* lte2;
  const float* ltn;
};

__device__ __forceinline__ Tables global_tables(const StepArgs& a) {
  return {a.mtype, a.albedo, a.ior,  a.ltype, a.ltri, a.lpos,
          a.lemit, a.ltp0,   a.lte1, a.lte2,  a.ltn};
}

struct Light {
  int type, tri;
  V3 pos, emit, p0, e1, e2, n;
};

__device__ __forceinline__ Light load_light(const Tables& T, int r) {
  Light L;
  L.type = T.ltype[r];
  L.tri = T.ltri[r];
  L.pos = row3(T.lpos, r);
  L.emit = row3(T.lemit, r);
  L.p0 = row3(T.ltp0, r);
  L.e1 = row3(T.lte1, r);
  L.e2 = row3(T.lte2, r);
  L.n = row3(T.ltn, r);
  return L;
}

struct LightSample {
  V3 wi, li;
  float t, pdf;
};

// sample_li_v3: the picked light's branch
__device__ __forceinline__ LightSample sample_li(const Light& L, V3 p,
                                                 float u1, float u2) {
  LightSample s;
  if (L.type == kPointLight) {
    const V3 to_l = sub(L.pos, p);
    const float t_pt = length(to_l);
    s.wi = scale(1.0f / t_pt, to_l);
    s.li = scale(1.0f / (t_pt * t_pt), L.emit);
    s.t = t_pt;
    s.pdf = 1.0f;
    return s;
  }
  const float sq = sqrtf(u1);
  const float su = 1.0f - sq, sv = u2 * sq;
  const V3 tri_p = add(sub(L.p0, scale(su, L.e1)), scale(sv, L.e2));
  const float n_len = length(L.n);
  const float pdf_area = 1.0f / (0.5f * n_len);
  const V3 to_a = sub(tri_p, p);
  const float dist_sq = dot(to_a, to_a);
  const float t_ar = sqrtf(dist_sq);
  s.wi = scale(1.0f / t_ar, to_a);
  s.li = L.emit;
  s.t = t_ar;
  s.pdf = pdf_area * dist_sq * n_len / fabsf(dot(L.n, s.wi));
  return s;
}
// pdf_li_v3: solid-angle pdf of reaching the picked area light along wi
__device__ __forceinline__ float pdf_li(const Light& L, V3 p, V3 wi) {
  float t, u, v;
  const bool hit = intersect_triangle(p, wi, INFINITY, L.p0, L.e1, L.e2,
                                      L.n, &t, &u, &v);
  const V3 lp = add(sub(L.p0, scale(u, L.e1)), scale(v, L.e2));
  const float n_len = length(L.n);
  const float area = 0.5f * n_len;
  const V3 to = sub(lp, p);
  const float pdf = dot(to, to) * n_len / (area * fabsf(dot(L.n, wi)));
  return (L.type == kAreaLight && hit) ? pdf : 0.0f;
}

// ---------------------------------------------------------------- lanes

// the hit's material index (render/trace.py _hit_material_index: an
// instanced hit takes its instance's material), clamped to the table as
// the gather clamps it; prim -1 (a miss) reads row 0
__device__ __forceinline__ int hit_material(const StepArgs& a, int prim,
                                            int src) {
  int mi = __ldg(a.prim_material + clampi(prim, 0, a.num_prims - 1));
  if (a.inst_material != nullptr && src > 0)
    mi = __ldg(a.inst_material + max(src - 1, 0));
  return clampi(mi, 0, a.num_materials - 1);
}

// a lane's full-precision record (kernels/step.py pack_full); ``rank``
// the camera rank route carries under the parity modes (word 22)
struct FullRec {
  V3 o, d, normal, beta, acc;
  float t;
  int pixel, prim, src, bounces, mi, rank;
  bool mat, limbo;
};

// a record from its twelve 8-byte words (route_lane's rec)
__device__ __forceinline__ FullRec full_from_words(const int2* w) {
  const auto f = [](int x) { return __int_as_float(x); };
  FullRec r;
  r.o = {f(w[0].x), f(w[0].y), f(w[1].x)};
  r.t = f(w[1].y);
  r.d = {f(w[2].x), f(w[2].y), f(w[3].x)};
  r.pixel = w[3].y;
  r.normal = {f(w[4].x), f(w[4].y), f(w[5].x)};
  r.prim = w[5].y;
  r.beta = {f(w[6].x), f(w[6].y), f(w[7].x)};
  r.src = w[7].y;
  r.acc = {f(w[8].x), f(w[8].y), f(w[9].x)};
  r.bounces = w[9].y;
  r.mat = (w[10].x & 1) != 0;
  r.limbo = (w[10].x & 2) != 0;
  r.mi = w[10].y;
  r.rank = w[11].x;
  return r;
}

// the record of slot j: six read-only 16-byte loads (three 32-byte sectors)
__device__ __forceinline__ FullRec load_full(const StepArgs& a, long long j) {
  const int4* q = reinterpret_cast<const int4*>(a.bundle) + 6 * j;
  const int4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2),
             q3 = __ldg(q + 3), q4 = __ldg(q + 4), q5 = __ldg(q + 5);
  const auto f = [](int w) { return __int_as_float(w); };
  FullRec r;
  r.o = {f(q0.x), f(q0.y), f(q0.z)};
  r.t = f(q0.w);
  r.d = {f(q1.x), f(q1.y), f(q1.z)};
  r.pixel = q1.w;
  r.normal = {f(q2.x), f(q2.y), f(q2.z)};
  r.prim = q2.w;
  r.beta = {f(q3.x), f(q3.y), f(q3.z)};
  r.src = q3.w;
  r.acc = {f(q4.x), f(q4.y), f(q4.z)};
  r.bounces = q4.w;
  r.mat = (q5.x & 1) != 0;
  r.limbo = (q5.x & 2) != 0;
  r.mi = q5.y;
  r.rank = q5.z;
  return r;
}

struct RouteLane {
  bool mat, dirty, limbo;
};

// route (kernels/step.py route_ref) of slot i: the key and the bundle; the
// record design writes the lane's 40-byte record to ``rec`` (five 8-byte
// stores; the kernel stages the block's records in shared memory), the
// first design nine [n] columns.  The full-record modes (route_full_ref)
// write the 96-byte full record to ``rec`` (twelve 8-byte stores) and,
// under kParity on the sorted engine, the keys without the dirty class;
// the wide bundle (kWide) the default route's keys, dirty class and all.
template <bool kV1, int kMode = kDefault>
__device__ __forceinline__ RouteLane route_lane(const StepArgs& a, int i,
                                                int2* rec) {
  const long long n = a.n;
  const int prim = a.prim[i], src = a.src[i], bounces = a.bounces[i];
  // the hit's material, looked up first: its loads overlap the state's
  const int mi = kV1 ? 0 : hit_material(a, prim, src);
  const bool hit = a.hit[i] != 0;
  const V3 o = load3(a.ray_o, i), d = load3(a.ray_d, i);
  const V3 nrm = load3(a.normal, i), beta0 = load3(a.beta, i);
  const float u_rr = u01_hi(a.words[i]);

  // emission at camera-ray hits, the environment light on misses
  int light_idx = -1;
  if (a.num_lights > 0 && a.num_lights <= 16) {
    for (int l = 0; l < a.num_lights; ++l) {
      const int lt = a.ltri[l];
      if (prim == lt && lt >= 0 && src == 0) light_idx = l;
    }
  } else if (src == 0) {
    light_idx = a.prim_light[clampi(prim, 0, a.num_prims - 1)];
  }
  const bool emit0 = hit && light_idx >= 0 && bounces == 0;
  const int emit_row = clampi(max(light_idx, 0), 0, a.num_light_rows - 1);
  V3 acc = accum(load3(a.acc, i), row3(a.lemit, emit_row), emit0);
  const bool env_mask = !hit && bounces <= a.max_bounces;
  acc = accum(acc, mul(beta0, {a.env[0], a.env[1], a.env[2]}), env_mask);

  // Russian roulette
  const bool alive = bounces < a.max_bounces;
  const float beta_max = vmax(beta0);
  const bool rr_cand = alive && hit && bounces > a.rr_start &&
                       beta_max < a.rr_threshold;
  const float p_term = clamp_minf(1.0f - beta_max, RTJAX_F(0.05));
  const bool rr_kill = rr_cand && u_rr < p_term;
  const float rr_boost =
      (rr_cand && !rr_kill) ? 1.0f / (1.0f - p_term) : 1.0f;
  const V3 beta = scale(rr_boost, beta0);
  const int b1 = bounces + 1;
  const bool mat = alive && hit && !rr_kill;
  const float hp_t = mat ? a.t[i] : 0.0f;
  const V3 hp = add(o, scale(hp_t, d));
  if constexpr (kMode != kDefault) {
    const bool limbo = (kMode & kParity) != 0 && rr_kill;
    // the wide bundle carries the hit point in the origin words, and
    // bounces (15 bits, 0x7FFF dead) and the mat bit as the op-by-op
    // step's one packed word gives them back
    const bool dirty = kMode == kWide && !mat &&
                       (acc.x != 0.0f || acc.y != 0.0f || acc.z != 0.0f);
    const int meta = min(b1, 0x7FFF) | shl(mat ? 1 : 0, 15);
    const bool mat_r = kMode == kWide ? ((meta >> 15) & 1) != 0 : mat;
    const int b_r = kMode != kWide ? b1
                    : ((meta & 0x7FFF) >= 0x7FFF ? kDeadBounces
                                                 : (meta & 0x7FFF));
    const V3 o_r = kMode == kWide ? hp : o;
    if constexpr (kMode == kWide)
      a.keys[i] = dirty ? kDirtyKey
                        : (mat ? sort_key(a, hp, d, nrm, prim, b1)
                               : kInactiveKey);
    else if constexpr ((kMode & kUnsorted) == 0)
      a.keys[i] = mat ? sort_key(a, hp, d, nrm, prim, b1) : kInactiveKey;
    const int flags = (mat_r ? 1 : 0) | (limbo ? 2 : 0);
    const auto f = [](float x) { return __float_as_int(x); };
    rec[0] = make_int2(f(o_r.x), f(o_r.y));
    rec[1] = make_int2(f(o_r.z), f(a.t[i]));
    rec[2] = make_int2(f(d.x), f(d.y));
    rec[3] = make_int2(f(d.z), a.pixel[i]);
    rec[4] = make_int2(f(nrm.x), f(nrm.y));
    rec[5] = make_int2(f(nrm.z), prim);
    rec[6] = make_int2(f(beta.x), f(beta.y));
    rec[7] = make_int2(f(beta.z), src);
    rec[8] = make_int2(f(acc.x), f(acc.y));
    rec[9] = make_int2(f(acc.z), b_r);
    rec[10] = make_int2(flags, mi);
    rec[11] = make_int2(0, 0);
    return {mat_r, dirty, limbo};
  }

  const bool dirty = !mat && (acc.x != 0.0f || acc.y != 0.0f ||
                              acc.z != 0.0f);
  a.keys[i] = dirty ? kDirtyKey
                    : (mat ? sort_key(a, hp, d, nrm, prim, b1)
                           : kInactiveKey);
  const int w[9] = {__float_as_int(hp.x),
                    __float_as_int(hp.y),
                    __float_as_int(hp.z),
                    rgb9e5_encode(beta),
                    rgb9e5_encode(acc),
                    a.pixel[i] | shl(min(b1, 127), 21) | shl(mat ? 1 : 0, 28),
                    (prim + 1) | shl(src, 23),
                    oct_encode(nrm),
                    oct_encode(d)};
  if constexpr (kV1) {
    for (int k = 0; k < 9; ++k) a.bundle[k * n + i] = w[k];
  } else {
    rec[0] = make_int2(w[0], w[1]);
    rec[1] = make_int2(w[2], w[3]);
    rec[2] = make_int2(w[4], w[5]);
    rec[3] = make_int2(w[6], w[7]);
    rec[4] = make_int2(w[8], mi);
  }
  return {mat, dirty};
}

// whether the iteration sorts, generates and flushes (kernels/step.py
// cadence): every k-th one, or when the continuing paths fall below 3/4
__device__ __forceinline__ bool cadence(const StepArgs& a) {
  if (a.sort_every <= 1) return true;
  const long long it = a.it ? *a.it : a.it_value;
  const long long rem = it % a.sort_every;
  return a.counts[0] * 4 < static_cast<long long>(a.n) * 3 ||
         (rem < 0 ? rem + a.sort_every : rem) == 0;
}

// what the shade kernel does with a lane beyond its own outputs
struct ShadeLane {
  bool trace, nee, mis, flush;
  int pixel;
  V3 flushed;
};

// the camera ray through normalized image coordinates x, y (Camera.get_rays)
__device__ __forceinline__ V3 camera_dir(const StepArgs& a, float x,
                                         float y) {
  const float* ul = a.upper_left;
  const float* h = a.horizontal;
  const float* v = a.vertical;
  const float* lf = a.lookfrom;
  const V3 d = {ul[0] + x * h[0] + y * v[0] - lf[0],
                ul[1] + x * h[1] + y * v[1] - lf[1],
                ul[2] + x * h[2] + y * v[2] - lf[2]};
  return normalize(d);
}

// the NEE and BSDF-MIS shadow rays of position i (kernels/step.py
// shade_math with lights) into the [2n] shadow columns, with their
// radiance; under kParity the reference's two quirks (the truncated second
// pdfs, the BSDF-MIS target on the path's own triangle).  Under
// kOneSample the BSDF-MIS channel reuses the path sample ``s1`` and has
// no ray of its own (resolve reads the path ray's closest hit): the NEE
// ray into [n] columns, the channel's mask into chs_mask and its radiance
// zero off the mask (shade_math's ``one_sample_mis`` branch)
struct ShadowLane {
  bool nee, mis;
};

template <bool kParity, bool kOneSample = false>
__device__ __forceinline__ ShadowLane shadow_rays(
    const StepArgs& a, int i, const Tables& T, bool mat, V3 p, V3 wo, V3 n_g,
    V3 beta, int mtype, V3 albedo, float ior, float u_pick, float luv1,
    float luv2, float b2u1, float b2u2, int prim, int src, const Bsdf& s1) {
  const long long n = a.n;
  ShadowLane r;
  const float num_l = static_cast<float>(a.num_lights);
  const V3 multiplier = scale(num_l, beta);
  const int pick = min(static_cast<int>(u_pick * num_l),
                       a.num_lights - 1);
  const Light L = load_light(T, clampi(pick, 0, a.num_light_rows - 1));
  const bool delta = L.type == kPointLight;
  // light-sampling MIS -> the NEE shadow ray
  const LightSample ls = sample_li(L, p, luv1, luv2);
  const V3 n_l = dot(n_g, ls.wi) > 0.0f ? n_g : neg(n_g);
  const bool got_f = mtype == kMatte &&
                     dot(wo, n_l) * dot(ls.wi, n_l) < 0.0f;
  const float inv_pi = RTJAX_F(1.0 / kPi);
  const V3 f_l = scale(inv_pi, albedo);
  const float scat_pdf = dot(ls.wi, n_l) * inv_pi;
  const V3 f_lc = scale(dot(ls.wi, n_l), f_l);
  // the reference truncates the power heuristic's second pdf
  const float g_l = kParity ? truncf(scat_pdf) : scat_pdf;
  const float w_l = delta ? 1.0f : power_heuristic(ls.pdf, g_l);
  const V3 ah_L = mul(multiplier, scale(w_l / ls.pdf, mul(f_lc, ls.li)));
  const V3 ah_o = offset_origin(p, n_l);
  // BSDF-sampling MIS toward the picked light's triangle
  const Bsdf s2 = kOneSample ? s1
                             : sample_f(mtype, albedo, ior, wo, n_g, b2u1,
                                        b2u2, b2u1);
  const V3 f2c = scale(dot(s2.wi, s2.n), s2.f);
  const bool spec = mtype == kMirror || mtype == kGlass;
  const float lpdf2 = pdf_li(L, p, s2.wi);
  const float g_2 = kParity ? truncf(lpdf2) : lpdf2;
  const float w2 = spec ? 1.0f : power_heuristic(s2.pdf, g_2);
  const V3 chs_L = mul(multiplier, scale(w2 / s2.pdf, mul(f2c, L.emit)));
  if constexpr (kOneSample) {
    const bool chs = mat && !delta && (spec || lpdf2 > 0.0f);
    r.nee = mat && got_f;
    r.mis = false;  // no ray: counts[3] stays 0
    store3(a.sh_o, i, ah_o);
    store3(a.sh_d, i, ls.wi);
    a.sh_tmax[i] = ls.t;
    a.sh_exclude[i] = L.tri;
    a.sh_mask[i] = r.nee ? 1 : 0;
    a.chs_mask[i] = chs ? 1 : 0;
    store3(a.ah_L, i, ah_L);
    store3(a.chs_L, i, chs ? chs_L : V3{0.0f, 0.0f, 0.0f});
    return r;
  }
  const V3 chs_o = offset_origin(p, s2.n);
  float chs_t, u, v;
  bool chs_hit;
  int chs_tgt = L.tri;
  if constexpr (kParity) {
    // the reference's target is the triangle the path stands on (an
    // instanced hit has none: the channel is masked off there)
    const int own = clampi(prim, 0, a.num_tris - 1);
    chs_hit = intersect_triangle(chs_o, s2.wi, INFINITY, row3(a.tri_p0, own),
                                 row3(a.tri_e1, own), row3(a.tri_e2, own),
                                 row3(a.tri_n, own), &chs_t, &u, &v) &&
              src == 0;
    chs_tgt = src == 0 ? prim : -1;
  } else {
    chs_hit = intersect_triangle(chs_o, s2.wi, INFINITY, L.p0, L.e1, L.e2,
                                 L.n, &chs_t, &u, &v);
  }
  r.nee = mat && got_f;
  r.mis = mat && !delta && (spec || lpdf2 > 0.0f) && chs_hit;
  store3(a.sh_o, i, ah_o);
  store3(a.sh_o, n + i, chs_o);
  store3(a.sh_d, i, ls.wi);
  store3(a.sh_d, n + i, s2.wi);
  a.sh_tmax[i] = ls.t;
  a.sh_tmax[n + i] = chs_t;
  a.sh_exclude[i] = L.tri;
  a.sh_exclude[n + i] = chs_tgt;
  a.sh_mask[i] = r.nee ? 1 : 0;
  a.sh_mask[n + i] = r.mis ? 1 : 0;
  store3(a.ah_L, i, ah_L);
  store3(a.chs_L, i, chs_L);
  return r;
}

// a sorted position's lane as the gather gives it: the decoded compact
// record (or the wide bundle's full one) and the material index it carries
// (the first design looks it up in shade_math)
struct SortedLane {
  V3 p, beta, acc, normal, wo;
  int pixel, bounces, prim, src, mi;
  bool mat;
};

// the random words of a sorted position (kernels/step.py W_*): the light
// pick, the first BSDF sample, the light's barycentrics, the second BSDF
// sample (not read under one-sample MIS) and the subpixel jitter
struct ShadeWords {
  long long pick, bsdf1, light, bsdf2, gen;
};

// the compact record's nine codec words decoded (``mi`` its material word)
__device__ __forceinline__ SortedLane decode_compact(const int w[9], int mi) {
  SortedLane s;
  s.p = {__int_as_float(w[0]), __int_as_float(w[1]), __int_as_float(w[2])};
  s.beta = rgb9e5_decode(w[3]);
  s.acc = rgb9e5_decode(w[4]);
  const int pbm = w[5], sp = w[6];
  s.normal = oct_decode(w[7]);
  s.wo = oct_decode(w[8]);
  s.pixel = pbm & 0x1FFFFF;
  const int b_dec = (pbm >> 21) & 0x7F;
  s.bounces = b_dec >= 127 ? kDeadBounces : b_dec;
  s.mat = ((pbm >> 28) & 1) != 0;
  s.prim = (sp & 0x7FFFFF) - 1;
  s.src = (sp >> 23) & 0xFF;
  s.mi = mi;
  return s;
}

// shade (kernels/step.py shade_ref) of sorted position i given its lane
// ``s`` and words ``u``, its materials and lights read from T; ``do_gen``:
// cadence(a).  The one copy of the sorted engine's lane math: shade_lane
// gathers the lane and calls it, the one-sample shade's tile walk
// (shade_1s_walk) calls it on the lane its pipeline staged
template <bool kV1, int kMode = kDefault, bool kOneSample = false>
__device__ __forceinline__ ShadeLane shade_math(const StepArgs& a, int i,
                                                const Tables& T, bool do_gen,
                                                const SortedLane& s,
                                                const ShadeWords& u) {
  const V3 p = s.p, beta = s.beta, normal = s.normal, wo = s.wo;
  V3 acc = s.acc;
  const int pixel = s.pixel, bounces = s.bounces, prim = s.prim,
            src = s.src;
  int mi = s.mi;
  const bool mat = s.mat;
  const float u_pick = u01_lo(u.pick);
  const float b1u1 = u01_hi(u.bsdf1), b1u2 = u01_lo(u.bsdf1);
  const float luv1 = u01_hi(u.light), luv2 = u01_lo(u.light);
  // one-sample MIS draws no second BSDF sample
  const float b2u1 = kOneSample ? 0.0f : u01_hi(u.bsdf2);
  const float b2u2 = kOneSample ? 0.0f : u01_lo(u.bsdf2);
  const float gen_u = u01_hi(u.gen), gen_v = u01_lo(u.gen);

  // the hit's material: looked up here in the first design, carried in
  // the record (route's lookup) in the record design
  if constexpr (kV1) mi = hit_material(a, prim, src);
  const int mtype = T.mtype[mi];
  const V3 albedo = row3(T.albedo, mi);
  const float ior = T.ior[mi];

  // the next path ray (the record design computes it only for the lanes
  // that take it, and a camera ray only for the lanes that get one)
  const V3 n_g = neg(normalize(normal));
  Bsdf s1 = {};
  V3 next_o = {}, next_beta = {};
  if (kV1 || mat) {
    s1 = sample_f(mtype, albedo, ior, wo, n_g, b1u1, b1u2, b1u1);
    next_o = offset_origin(p, s1.n);
    next_beta = mul(beta, scale(dot(s1.wi, s1.n) / s1.pdf, s1.f));
    if (!finite3(next_beta)) next_beta = {0.0f, 0.0f, 0.0f};
  }

  ShadeLane r;
  r.nee = r.mis = false;
  if (a.num_lights > 0) {
    const ShadowLane sl = shadow_rays<false, kOneSample>(
        a, i, T, mat, p, wo, n_g, beta, mtype, albedo, ior, u_pick, luv1,
        luv2, b2u1, b2u2, prim, src, s1);
    r.nee = sl.nee;
    r.mis = sl.mis;
  }

  // camera generation into the dead suffix
  const int num_mat = static_cast<int>(a.counts[0]);
  const int cam_id = wrap_add(static_cast<int>(*a.cam_start),
                              max(i - num_mat, 0));
  const bool got_ray = i >= num_mat && cam_id < a.cam_end && do_gen;
  const bool flushing = !mat && do_gen;
  int pix_new = 0;
  V3 cam_d = {};
  if (kV1 || got_ray) {
    const int pix_rank = min(floordiv(cam_id, a.spp), a.num_pixels - 1);
    pix_new = a.pixel_table ? a.pixel_table[pix_rank] : pix_rank;
    const float ci = static_cast<float>(remainder(pix_new, a.width));
    const float cj = static_cast<float>(floordiv(pix_new, a.width));
    cam_d = camera_dir(a, div_host(ci + gen_u, static_cast<float>(a.width)),
                       div_host(cj + gen_v, static_cast<float>(a.height)));
  }
  const V3 cam_o = {a.lookfrom[0], a.lookfrom[1], a.lookfrom[2]};

  // the flush (added by the kernel) and the merge
  r.flush = flushing;
  r.pixel = pixel;
  r.flushed = acc;
  if (flushing) acc = {0.0f, 0.0f, 0.0f};
  store3(a.acc, i, acc);
  store3(a.ray_o, i, mat ? next_o : (got_ray ? cam_o : p));
  store3(a.ray_d, i, mat ? s1.wi : (got_ray ? cam_d : wo));
  a.pixel[i] = got_ray ? pix_new : pixel;
  store3(a.beta, i,
         mat ? next_beta : (got_ray ? V3{1.0f, 1.0f, 1.0f} : beta));
  a.bounces[i] = got_ray ? 0 : (!mat ? kDeadBounces : bounces);
  r.trace = mat || got_ray;
  a.trace_mask[i] = r.trace ? 1 : 0;
  return r;
}

// shade of sorted position i: its lane gathered through the sort's order
// (the identity on a skip iteration) and its words loaded, then
// shade_math.  kMode kWide: the lane's full-precision record of the wide
// bundle (shade_full_ref of the sorted engine) in place of the compact
// one; kOneSample: one-sample MIS
template <bool kV1, int kMode = kDefault, bool kOneSample = false>
__device__ __forceinline__ ShadeLane shade_lane(const StepArgs& a, int i,
                                                const Tables& T,
                                                bool do_gen) {
  const long long n = a.n;
  const long long j = do_gen ? a.order[i] : i;
  SortedLane s;
  if constexpr (kMode == kWide) {
    // the hit point rides in the record's origin words
    const FullRec r = load_full(a, j);
    s.p = r.o;
    s.beta = r.beta;
    s.acc = r.acc;
    s.normal = r.normal;
    s.wo = r.d;
    s.pixel = r.pixel;
    s.bounces = r.bounces;
    s.mat = r.mat;
    s.prim = r.prim;
    s.src = r.src;
    s.mi = r.mi;
  } else {
    int w[9];
    int mi = 0;
    if constexpr (kV1) {
      for (int k = 0; k < 9; ++k) w[k] = a.bundle[k * n + j];
    } else {
      // five read-only 8-byte loads of the lane's record (two sectors)
      const int2* r = reinterpret_cast<const int2*>(a.bundle) + 5 * j;
      const int2 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2),
                 r3 = __ldg(r + 3), r4 = __ldg(r + 4);
      w[0] = r0.x; w[1] = r0.y; w[2] = r1.x; w[3] = r1.y;
      w[4] = r2.x; w[5] = r2.y; w[6] = r3.x; w[7] = r3.y;
      w[8] = r4.x;
      mi = r4.y;
    }
    s = decode_compact(w, mi);
  }
  const long long* wd = a.words;
  const ShadeWords u = {wd[i], wd[n + i], wd[2 * n + i],
                        kOneSample ? 0LL : wd[3 * n + i], wd[4 * n + i]};
  return shade_math<kV1, kMode, kOneSample>(a, i, T, do_gen, s, u);
}

// ------------------------------- the sorted engine's one-sample shade walk

// The redesigned one-sample shade (step_kernels.cu shade_1s_kernel): a
// resident grid of blocks, each walking tiles of kShadeTile sorted
// positions (block b the tiles b, b + grid, ...), each thread one position
// of a tile.  A position's chain is three dependent reads: its order word,
// then its record through it (five 8-byte words) beside its four random
// words, then the shading.  Each thread pipelines its own chain in shared
// memory with asynchronous copies (cp.async, __pipeline_*): while it shades
// tile k, its record and words of tile k + 1 and its order word of tile
// k + 2 are in flight.  Two stages of each: tile k + 2's order goes where
// tile k's was, tile k + 1's lane where tile k - 1's was.  A thread reads
// only what its own copies wrote, so the walk needs no barrier (a copy is
// visible to the thread that made it once it waits for it).  On a cadence
// skip iteration the order is the identity: no order is read and the
// record is the position's own.
constexpr int kShadeTile = 128;

struct ShadeStages {
  long long order[2][kShadeTile];
  int2 rec[2][5][kShadeTile];
  long long words[2][4][kShadeTile];   // pick, bsdf1, light, gen
};

struct WalkCounts {
  int trace, nee, mis;
};

// thread ``t``'s walk over the tiles ``first``, ``first + stride``, ...:
// every position shaded by shade_math (one-sample MIS), ``flush(i, lane)``
// called for each; returns the thread's counts of traced, NEE and MIS lanes
template <class Flush>
__device__ __forceinline__ WalkCounts shade_1s_walk(const StepArgs& a,
                                                    const Tables& T,
                                                    ShadeStages& s, int t,
                                                    int first, int stride,
                                                    bool do_gen, Flush flush) {
  const long long n = a.n;
  const long long tiles = (n + kShadeTile - 1) / kShadeTile;
  const auto tile = [&](int k) {
    return first + static_cast<long long>(k) * stride;
  };
  // the thread's position in its k-th tile; -1 past the pool
  const auto pos = [&](int k) {
    const long long i = tile(k) * kShadeTile + t;
    return tile(k) < tiles && i < n ? i : -1LL;
  };
  const auto fetch_order = [&](int k) {
    const long long i = pos(k);
    if (do_gen && i >= 0)
      __pipeline_memcpy_async(&s.order[k & 1][t], a.order + i, 8);
  };
  const auto fetch_lane = [&](int k) {
    const long long i = pos(k);
    if (i < 0) return;
    const long long j = do_gen ? s.order[k & 1][t] : i;
    const int2* r = reinterpret_cast<const int2*>(a.bundle) + 5 * j;
    for (int w = 0; w < 5; ++w)
      __pipeline_memcpy_async(&s.rec[k & 1][w][t], r + w, 8);
    // the words but the second BSDF sample's (rows 0, 1, 2 and 4)
    for (int w = 0; w < 4; ++w)
      __pipeline_memcpy_async(&s.words[k & 1][w][t],
                              a.words + (w + w / 3) * n + i, 8);
  };
  WalkCounts c = {0, 0, 0};
  fetch_order(0);
  __pipeline_commit();
  fetch_order(1);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  fetch_lane(0);
  __pipeline_commit();
  for (int k = 0; tile(k) < tiles; ++k) {
    __pipeline_wait_prior(0);  // tile k's lane and tile k + 1's order in
    fetch_lane(k + 1);
    fetch_order(k + 2);
    __pipeline_commit();
    const long long i = pos(k);
    if (i < 0) continue;
    const int b = k & 1;
    const int w[9] = {s.rec[b][0][t].x, s.rec[b][0][t].y, s.rec[b][1][t].x,
                      s.rec[b][1][t].y, s.rec[b][2][t].x, s.rec[b][2][t].y,
                      s.rec[b][3][t].x, s.rec[b][3][t].y, s.rec[b][4][t].x};
    const ShadeWords u = {s.words[b][0][t], s.words[b][1][t],
                          s.words[b][2][t], 0LL, s.words[b][3][t]};
    const ShadeLane r = shade_math<false, kDefault, true>(
        a, static_cast<int>(i), T, do_gen,
        decode_compact(w, s.rec[b][4][t].y), u);
    c.trace += r.trace;
    c.nee += r.nee;
    c.mis += r.mis;
    flush(i, r);
  }
  __pipeline_wait_prior(0);
  return c;
}

// ---------------------------------------------- the full-record modes

// The first designs' camera rank, a single-pass scan with decoupled
// look-back: a shade block takes its index from the ticket (so a block
// waits only on blocks that already run), publishes its count of lanes
// that take a camera ray
// (kScanAggregate; block 0 its inclusive prefix, kScanPrefix), then sums
// its predecessors' words back to the first inclusive prefix and
// publishes its own.  A status word is one 64-bit store: the flag and the
// value can not tear, and 0 is "not yet published".
constexpr unsigned long long kScanAggregate = 1ULL << 62;
constexpr unsigned long long kScanPrefix = 1ULL << 63;
constexpr unsigned long long kScanValue = kScanAggregate - 1;

__device__ __forceinline__ void scan_store(unsigned long long* p,
                                           unsigned long long w) {
  atomicExch(p, w);
}
__device__ __forceinline__ unsigned long long scan_load(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}
// block b's count ``agg``, as its aggregate (block 0: its prefix)
__device__ __forceinline__ void scan_publish(unsigned long long* status,
                                             int b, long long agg) {
  scan_store(status + b, static_cast<unsigned long long>(agg) |
                             (b == 0 ? kScanPrefix : kScanAggregate));
}
// block b's exclusive prefix, after scan_publish; publishes its inclusive
// prefix
__device__ __forceinline__ long long scan_lookback(
    unsigned long long* status, int b, long long agg) {
  if (b == 0) return 0;
  long long ex = 0;
  for (int j = b - 1;;) {
    const unsigned long long w = scan_load(status + j);
    if (w == 0) continue;
    ex += static_cast<long long>(w & kScanValue);
    if (w & kScanPrefix) break;
    --j;
  }
  scan_store(status + b,
             static_cast<unsigned long long>(ex + agg) | kScanPrefix);
  return ex;
}

// The camera rank by blocks on a persistent scratch: a lane's exclusive
// count among the slots' lanes that take a camera ray.  The parity modes'
// route takes it in slot order and carries it in the record (word 22):
// the parity sort's keys have no dirty class, so every such lane (and
// every limbo lane) takes the inactive key and the stable sort keeps them
// in slot order, and the count over slots is the count over sorted
// positions that shade reads.  The unsorted engine's route and shade
// takes it over its own blocks after the shading.  A block (kRankBlock
// slots of a parity route, kScanBlock lanes of the unsorted engine's
// route and shade) takes its index from a ticket on a persistent scratch
// (kernels/step.py rank_scratch, zeroed once, one a block count): word 0
// the ticket, which atomicInc runs over [0, 2 * blocks), so that a launch
// takes [0, blocks) or [blocks, 2 * blocks) and the ticket gives the
// block's index and the launch's parity (two consecutive launches on a
// scratch differ, whichever kernel made them); then one status word
// a block, never zeroed: bit 31 the tag of the launch that wrote it (a
// launch of parity q writes tag q ^ 1, so a fresh scratch's zeros and
// every word of the launch before read as not published), bit 30 set on
// an inclusive prefix, else the block's own count, bits 0-29 the count.
// One 32-bit word: tag, flag and count cannot tear.  A block publishes its
// count, then one warp walks back kRankLook words a step (a lane a word)
// to the first prefix, and publishes its own.
constexpr int kRankBlock = 256;   // slots a parity route block ranks
constexpr int kRankLook = 32;     // status words a look-back step reads
constexpr unsigned kRankTag = 1u << 31;
constexpr unsigned kRankPrefix = 1u << 30;
constexpr unsigned kRankValue = kRankPrefix - 1;

__device__ __forceinline__ unsigned rank_ticket_limit(int blocks) {
  return 2u * static_cast<unsigned>(blocks) - 1u;
}
__device__ __forceinline__ unsigned rank_parity(unsigned ticket, int blocks) {
  return ticket >= static_cast<unsigned>(blocks) ? 1u : 0u;
}
__device__ __forceinline__ int rank_block(unsigned ticket, int blocks) {
  return static_cast<int>(ticket) -
         (ticket >= static_cast<unsigned>(blocks) ? blocks : 0);
}
__device__ __forceinline__ unsigned rank_word(unsigned parity, bool prefix,
                                              unsigned value) {
  return (parity ? 0u : kRankTag) | (prefix ? kRankPrefix : 0u) | value;
}
__device__ __forceinline__ bool rank_published(unsigned w, unsigned parity) {
  return (w & kRankTag) == (parity ? 0u : kRankTag);
}

// One look-back step over kRankLook status words, the nearest first, given
// by the lanes that read them: ``unpublished`` and ``prefix`` (a bit a
// word).  ``take`` the words whose counts add to the block's prefix:
// those before the first prefix or the first unpublished word, and that
// prefix; ``back`` -1 when a prefix ended the walk, else how many words to
// step back (kRankLook past aggregates only; fewer to read an unpublished
// word again, where the walk waits)
struct RankStep {
  unsigned take;
  int back;
};
__device__ __forceinline__ int lowest_bit(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}
__device__ __forceinline__ RankStep rank_step(unsigned unpublished,
                                              unsigned prefix) {
  const unsigned stop = unpublished | prefix;
  if (stop == 0) return {0xFFFFFFFFu, kRankLook};
  const int first = lowest_bit(stop);
  const unsigned below = first == 0 ? 0u : 0xFFFFFFFFu >> (32 - first);
  if ((prefix >> first) & 1u) return {below | (1u << first), -1};
  return {below, first};
}

// shade (kernels/step.py shade_full_ref) of position i under a
// full-record mode, in two parts: the shading (shade_full_math: a
// continuing lane's BSDF sample and next path ray, every lane's shadow
// rays and flush) and the camera ray of a lane that takes one
// (camera_full, by its rank), then the merge (store_full).  ``r`` is the
// lane's record (gathered by the sort's order under kParity, slot i on the
// unsorted engine).  The camera part reads only the rank, the lane's
// subpixel words and the camera, so a kernel may shade first and rank
// after (step_kernels.cu route_shade)
struct FullShade {
  ShadeLane s;  // trace: r.mat; the camera ray's lanes add theirs
  V3 next_o, next_d, next_beta;
};

template <int kMode, bool kOneSample = false>
__device__ __forceinline__ FullShade shade_full_math(const StepArgs& a,
                                                     int i, const Tables& T,
                                                     const FullRec& r) {
  const long long n = a.n;
  const long long* wd = a.words;
  const float u_pick = u01_lo(wd[i]);
  const float b1u1 = u01_hi(wd[n + i]), b1u2 = u01_lo(wd[n + i]);
  const float luv1 = u01_hi(wd[2 * n + i]), luv2 = u01_lo(wd[2 * n + i]);
  const float b2u1 = kOneSample ? 0.0f : u01_hi(wd[3 * n + i]);
  const float b2u2 = kOneSample ? 0.0f : u01_lo(wd[3 * n + i]);
  const int mtype = T.mtype[r.mi];
  const V3 albedo = row3(T.albedo, r.mi);
  const float ior = T.ior[r.mi];
  // the hit point after the permutation, in rtjax's operation order
  const V3 p = add(r.o, scale(r.mat ? r.t : 0.0f, r.d));

  const V3 n_g = neg(normalize(r.normal));
  Bsdf s1 = {};
  FullShade f = {};
  if (r.mat) {
    s1 = sample_f(mtype, albedo, ior, r.d, n_g, b1u1, b1u2, b1u1);
    f.next_o = offset_origin(p, s1.n);
    f.next_d = s1.wi;
    f.next_beta = mul(r.beta, scale(dot(s1.wi, s1.n) / s1.pdf, s1.f));
    if (!finite3(f.next_beta)) f.next_beta = {0.0f, 0.0f, 0.0f};
  }
  f.s.nee = f.s.mis = false;
  if (a.num_lights > 0) {
    const ShadowLane sl = shadow_rays<(kMode & kParity) != 0, kOneSample>(
        a, i, T, r.mat, p, r.d, n_g, r.beta, mtype, albedo, ior, u_pick,
        luv1, luv2, b2u1, b2u2, r.prim, r.src, s1);
    f.s.nee = sl.nee;
    f.s.mis = sl.mis;
  }
  // every lane that takes a camera ray (neither continuing nor in limbo)
  // flushes
  f.s.flush = !r.mat && !r.limbo;
  f.s.pixel = r.pixel;
  f.s.flushed = r.acc;
  f.s.trace = r.mat;
  return f;
}

// the camera ray of position i, a lane that takes one, by its exclusive
// ``rank`` among such lanes; ``got`` false past the frame's last camera ray
struct CameraRay {
  bool got;
  int pixel;
  V3 d;
};

__device__ __forceinline__ CameraRay camera_full(const StepArgs& a, int i,
                                                 long long rank) {
  const long long n = a.n;
  const long long cam_id = *a.cam_start + rank;
  CameraRay c = {cam_id < a.cam_end, 0, {}};
  if (c.got) {
    const long long w = a.words[4 * n + i];
    const float gen_u = u01_hi(w), gen_v = u01_lo(w);
    const int pix_rank = static_cast<int>(
        min(cam_id / a.spp, static_cast<long long>(a.num_pixels) - 1));
    c.pixel = a.pixel_table ? a.pixel_table[pix_rank] : pix_rank;
    const float ci = static_cast<float>(remainder(c.pixel, a.width));
    const float cj = static_cast<float>(floordiv(c.pixel, a.width));
    c.d = camera_dir(a, div_host(ci + gen_u, static_cast<float>(a.width)),
                     div_host(cj + gen_v, static_cast<float>(a.height)));
  }
  return c;
}

// the traced lanes of a block of ``valid`` lanes, ``total`` of them
// taking camera rays with ranks from ``prefix`` on (consecutive): the
// continuing lanes and the camera rays before the frame's end
__device__ __forceinline__ long long traced_lanes(const StepArgs& a,
                                                  int valid, unsigned total,
                                                  unsigned prefix) {
  const long long left = a.cam_end - (*a.cam_start + prefix);
  return valid - static_cast<long long>(total) +
         max(0LL, min(static_cast<long long>(total), left));
}

// the merge of position i: its next state from the shading ``f`` (a
// continuing lane) or the camera ray ``c`` (a lane that takes one; a lane
// past the frame's last camera ray keeps its ray, throughput and pixel
// and is dead), a limbo lane's state kept
template <int kMode>
__device__ __forceinline__ void store_full(const StepArgs& a, int i,
                                           const FullRec& r,
                                           const FullShade& f,
                                           const CameraRay& c) {
  const bool gen = !r.mat && !r.limbo;
  const bool got_ray = gen && c.got;
  const V3 cam_o = {a.lookfrom[0], a.lookfrom[1], a.lookfrom[2]};
  store3(a.acc, i, gen ? V3{0.0f, 0.0f, 0.0f} : r.acc);
  store3(a.ray_o, i, r.mat ? f.next_o : (got_ray ? cam_o : r.o));
  store3(a.ray_d, i, r.mat ? f.next_d : (got_ray ? c.d : r.d));
  a.pixel[i] = got_ray ? c.pixel : r.pixel;
  store3(a.beta, i,
         r.mat ? f.next_beta : (got_ray ? V3{1.0f, 1.0f, 1.0f} : r.beta));
  a.bounces[i] = got_ray ? 0 : (gen ? kDeadBounces : r.bounces);
  a.trace_mask[i] = r.mat || got_ray ? 1 : 0;
  if constexpr ((kMode & kParity) != 0) a.limbo[i] = r.limbo ? 1 : 0;
}

// the three in one: shade of position i with its camera rank ``rank``
template <int kMode, bool kOneSample = false>
__device__ __forceinline__ ShadeLane shade_full_lane(const StepArgs& a,
                                                     int i, const Tables& T,
                                                     const FullRec& r,
                                                     long long rank) {
  FullShade f = shade_full_math<kMode, kOneSample>(a, i, T, r);
  CameraRay c = {};
  if (f.s.flush) c = camera_full(a, i, rank);
  store_full<kMode>(a, i, r, f, c);
  f.s.trace = r.mat || (f.s.flush && c.got);
  return f.s;
}

// resolve (kernels/step.py resolve_ref) of lane i: the shadow results;
// under kOneSample the BSDF-MIS channel lands where the path ray's closest
// hit (hit, src and prim, the traversal's outputs) is the picked light's
// triangle (the NEE ray's exclude)
template <bool kOneSample = false>
__device__ __forceinline__ void resolve_lane(const StepArgs& a, int i) {
  const long long n = a.n;
  V3 acc = load3(a.acc, i);
  acc = accum(acc, load3(a.ah_L, i), a.sh_mask[i] && !a.occluded[i]);
  if constexpr (kOneSample) {
    const bool chs_ok =
        a.hit[i] != 0 && a.src[i] == 0 && a.prim[i] == a.sh_exclude[i];
    acc = accum(acc, load3(a.chs_L, i), a.chs_mask[i] && chs_ok);
  } else {
    acc = accum(acc, load3(a.chs_L, i),
                a.sh_mask[n + i] && !a.occluded[n + i]);
  }
  store3(a.acc, i, acc);
}

// detailed_stats' bounce histogram (render/wavefront.py): a traced lane's
// bin, clamp(bounces, 0, max_bounces), after the merge; -1 for the others
__device__ __forceinline__ int hist_bin(const StepArgs& a, int i) {
  return a.trace_mask[i] ? clampi(a.bounces[i], 0, a.max_bounces) : -1;
}

// under the parity modes (kernels/step.py resolve_full_ref), a limbo
// lane's hit, t, normal, prim and src restored from its record: it did not
// trace, and keeps its payload for the next re-roll
__device__ __forceinline__ void restore_limbo(const StepArgs& a, int i) {
  if (!a.limbo[i]) return;
  const long long j = a.order ? a.order[i] : i;
  const int* w = a.bundle + static_cast<long long>(kFullWords) * j;
  a.hit_out[i] = 1;
  a.t_out[i] = __int_as_float(w[3]);
  for (int k = 0; k < 3; ++k) a.normal_out[k][i] = __int_as_float(w[8 + k]);
  a.prim_out[i] = w[11];
  a.src_out[i] = w[15];
}

// resolve's counters, once a step; under the parity modes counts[4] holds
// the limbo lanes, which take no camera ray and hold the frame open
template <int kMode = kDefault>
__device__ __forceinline__ void resolve_counters(const StepArgs& a) {
  const long long* c = a.counts;
  if constexpr ((kMode & kParity) != 0) {
    *a.cam_out = *a.cam_start + (a.n - c[0] - c[4]);
    *a.work_out = (c[1] > 0 || c[4] > 0) ? 1 : 0;
  } else {
    const long long num_gen = cadence(a) ? a.n - c[0] : 0;
    *a.cam_out = *a.cam_start + num_gen;
    *a.work_out = c[1] > 0 ? 1 : 0;
  }
  *a.rays_out = *a.rays_in + static_cast<double>(c[1] + c[2] + c[3]);
  // a tensor divided by a host scalar: the product with its reciprocal
  *a.occ_out = *a.occ_in + static_cast<double>(c[1]) *
                               (1.0 / static_cast<double>(a.n));
}

}  // namespace rtjax_step
