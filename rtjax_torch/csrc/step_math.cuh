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
  long long it_value;
  int n;
  int num_prims;
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

struct RouteLane {
  bool mat, dirty;
};

// route (kernels/step.py route_ref) of slot i: the key and the bundle; the
// record design writes the lane's 40-byte record to ``rec`` (five 8-byte
// stores; the kernel stages the block's records in shared memory), the
// first design nine [n] columns
template <bool kV1>
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

// shade (kernels/step.py shade_ref) of sorted position i, its materials
// and lights read from T; ``do_gen``: cadence(a)
template <bool kV1>
__device__ __forceinline__ ShadeLane shade_lane(const StepArgs& a, int i,
                                                const Tables& T,
                                                bool do_gen) {
  const long long n = a.n;
  const long long j = do_gen ? a.order[i] : i;
  int w[9];
  int mi;
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
  const V3 p = {__int_as_float(w[0]), __int_as_float(w[1]),
                __int_as_float(w[2])};
  const V3 beta = rgb9e5_decode(w[3]);
  V3 acc = rgb9e5_decode(w[4]);
  const int pbm = w[5], sp = w[6];
  const V3 normal = oct_decode(w[7]);
  const V3 wo = oct_decode(w[8]);
  const int pixel = pbm & 0x1FFFFF;
  const int b_dec = (pbm >> 21) & 0x7F;
  const int bounces = b_dec >= 127 ? kDeadBounces : b_dec;
  const bool mat = ((pbm >> 28) & 1) != 0;
  const int prim = (sp & 0x7FFFFF) - 1;
  const int src = (sp >> 23) & 0xFF;
  const long long* wd = a.words;
  const float u_pick = u01_lo(wd[i]);
  const float b1u1 = u01_hi(wd[n + i]), b1u2 = u01_lo(wd[n + i]);
  const float luv1 = u01_hi(wd[2 * n + i]), luv2 = u01_lo(wd[2 * n + i]);
  const float b2u1 = u01_hi(wd[3 * n + i]), b2u2 = u01_lo(wd[3 * n + i]);
  const float gen_u = u01_hi(wd[4 * n + i]), gen_v = u01_lo(wd[4 * n + i]);

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
    const float w_l = delta ? 1.0f : power_heuristic(ls.pdf, scat_pdf);
    const V3 ah_L = mul(multiplier, scale(w_l / ls.pdf, mul(f_lc, ls.li)));
    const V3 ah_o = offset_origin(p, n_l);
    // BSDF-sampling MIS toward the picked light's triangle
    const Bsdf s2 = sample_f(mtype, albedo, ior, wo, n_g, b2u1, b2u2, b2u1);
    const V3 f2c = scale(dot(s2.wi, s2.n), s2.f);
    const bool spec = mtype == kMirror || mtype == kGlass;
    const float lpdf2 = pdf_li(L, p, s2.wi);
    const float w2 = spec ? 1.0f : power_heuristic(s2.pdf, lpdf2);
    const V3 chs_L = mul(multiplier, scale(w2 / s2.pdf, mul(f2c, L.emit)));
    const V3 chs_o = offset_origin(p, s2.n);
    float chs_t, u, v;
    const bool chs_hit = intersect_triangle(chs_o, s2.wi, INFINITY, L.p0,
                                            L.e1, L.e2, L.n, &chs_t, &u, &v);
    r.nee = mat && got_f;
    r.mis = mat && !delta && (spec || lpdf2 > 0.0f) && chs_hit;
    store3(a.sh_o, i, ah_o);
    store3(a.sh_o, n + i, chs_o);
    store3(a.sh_d, i, ls.wi);
    store3(a.sh_d, n + i, s2.wi);
    a.sh_tmax[i] = ls.t;
    a.sh_tmax[n + i] = chs_t;
    a.sh_exclude[i] = L.tri;
    a.sh_exclude[n + i] = L.tri;
    a.sh_mask[i] = r.nee ? 1 : 0;
    a.sh_mask[n + i] = r.mis ? 1 : 0;
    store3(a.ah_L, i, ah_L);
    store3(a.chs_L, i, chs_L);
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

// resolve (kernels/step.py resolve_ref) of lane i: the shadow results
__device__ __forceinline__ void resolve_lane(const StepArgs& a, int i) {
  const long long n = a.n;
  V3 acc = load3(a.acc, i);
  acc = accum(acc, load3(a.ah_L, i), a.sh_mask[i] && !a.occluded[i]);
  acc = accum(acc, load3(a.chs_L, i),
              a.sh_mask[n + i] && !a.occluded[n + i]);
  store3(a.acc, i, acc);
}

// resolve's counters, once a step
__device__ __forceinline__ void resolve_counters(const StepArgs& a) {
  const long long* c = a.counts;
  const long long num_gen = cadence(a) ? a.n - c[0] : 0;
  *a.cam_out = *a.cam_start + num_gen;
  *a.work_out = c[1] > 0 ? 1 : 0;
  *a.rays_out = *a.rays_in + static_cast<double>(c[1] + c[2] + c[3]);
  // a tensor divided by a host scalar: the product with its reciprocal
  *a.occ_out = *a.occ_in + static_cast<double>(c[1]) *
                               (1.0 / static_cast<double>(a.n));
}

}  // namespace rtjax_step
