// The step kernels' launch logic on the host, over the device code of
// rtjax_torch/csrc/step_math.cuh compiled as C++ (tests/
// test_torch_step_kernels.py builds it with g++ and binds it with
// kernels/step.py ``bind``, so that the real ctypes wrappers run it on CPU
// tensors).  Each entry point of csrc/step_kernels.cu is a loop over the
// lanes in order, the shared-memory tables as host copies, the atomics as
// plain adds (so the flush adds in index_add_'s order).
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>
#define __device__
#define __forceinline__ inline
using std::min; using std::max; using std::isnan; using std::isfinite;
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int2 __ldg(const int2* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
#include "step_math.cuh"
using namespace rtjax_step;

template <bool kV1> static void route(const StepArgs* a) {
  for (int i = 0; i < a->n; ++i) {
    RouteLane r = route_lane<kV1>(*a, i, kV1 ? nullptr : reinterpret_cast<int2*>(a->bundle) + 5LL * i);
    a->counts[0] += r.mat;
    a->counts[4] += r.dirty;
  }
}
struct Staged {  // the block's shared-memory copy
  std::vector<int> mtype, ltype, ltri;
  std::vector<float> albedo, ior, rows[6];
};
static Tables stage(const StepArgs& a, Staged& s) {
  Tables T = global_tables(a);
  s.mtype.assign(a.mtype, a.mtype + a.num_materials);
  s.ior.assign(a.ior, a.ior + a.num_materials);
  s.albedo.assign(a.albedo, a.albedo + 3 * a.num_materials);
  T.mtype = s.mtype.data(); T.ior = s.ior.data(); T.albedo = s.albedo.data();
  if (a.num_light_rows > 0) {
    s.ltype.assign(a.ltype, a.ltype + a.num_light_rows);
    s.ltri.assign(a.ltri, a.ltri + a.num_light_rows);
    const float* src[6] = {a.lpos, a.lemit, a.ltp0, a.lte1, a.lte2, a.ltn};
    for (int t = 0; t < 6; ++t) s.rows[t].assign(src[t], src[t] + 3 * a.num_light_rows);
    T.ltype = s.ltype.data(); T.ltri = s.ltri.data();
    T.lpos = s.rows[0].data(); T.lemit = s.rows[1].data(); T.ltp0 = s.rows[2].data();
    T.lte1 = s.rows[3].data(); T.lte2 = s.rows[4].data(); T.ltn = s.rows[5].data();
  }
  return T;
}
extern "C" int rtjax_step_route(const StepArgs* a, void*) { route<false>(a); return 0; }
extern "C" int rtjax_step_route_v1(const StepArgs* a, void*) { route<true>(a); return 0; }
extern "C" int rtjax_step_shade(const StepArgs* a, void*) {
  Staged st;
  const Tables T = stage(*a, st);
  const bool do_gen = cadence(*a);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < a->n; ++i) {
    ShadeLane r = shade_lane<false>(*a, i, T, do_gen);
    c1 += r.trace; c2 += r.nee; c3 += r.mis;
    const long long lo = a->counts[0];
    if (r.flush && i >= lo && i < lo + a->counts[4]) {
      const V3 v = r.flushed;
      float* px = a->fb + 3 * (long long)r.pixel;
      if (v.x != 0.0f) px[0] += v.x;
      if (v.y != 0.0f) px[1] += v.y;
      if (v.z != 0.0f) px[2] += v.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
extern "C" int rtjax_step_shade_v1(const StepArgs* a, void*) {
  const bool do_gen = cadence(*a);
  long long c1 = 0, c2 = 0, c3 = 0;
  for (int i = 0; i < a->n; ++i) {
    ShadeLane r = shade_lane<true>(*a, i, global_tables(*a), do_gen);
    c1 += r.trace; c2 += r.nee; c3 += r.mis;
    if (r.flush) {
      float* px = a->fb + 3 * (long long)r.pixel;
      px[0] += r.flushed.x; px[1] += r.flushed.y; px[2] += r.flushed.z;
    }
  }
  a->counts[1] += c1; a->counts[2] += c2; a->counts[3] += c3;
  return 0;
}
extern "C" int rtjax_step_resolve(const StepArgs* a, void*) {
  for (int i = 0; i < a->n; ++i) if (a->num_lights > 0) resolve_lane(*a, i);
  resolve_counters(*a);
  return 0;
}
extern "C" int rtjax_step_kernel_info(int, int* r, int* l, int* b, int* k) {
  *r = *l = *b = *k = 0; return 0;
}
