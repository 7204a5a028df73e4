// Device functions of the tiny-scene direct pair (csrc/direct_traverse.cu):
// the triangle record, a ray, and the tests of both designs.  The header
// compiles as host C++ too (tests/direct_kernels_host.cpp), so that the
// tests run the same tests on CPU tensors.
//
// Exactness (the library builds with --fmad=false): every test keeps
// core/geometry.py intersect_triangle_v3's operation order, c = p0 - o,
// r = d x c, inv_det = 1 / (d . n) (the IEEE quotient), then u, v and t,
// each dot product summed left to right, and rtjax's accept rule
// u >= 0, v >= 0, u + v <= 1, 0 < t <= tmax.

#pragma once

namespace rtjax_direct {

constexpr float kBig = 3.4e38f;  // t of a miss / an inactive lane

// One triangle as the any-hit kernel stages it in shared memory: p0, e1,
// e2 and n, 12 floats, 48 B (three 16-byte loads a test).
struct alignas(16) Tri {
  float p0[3], e1[3], e2[3], n[3];
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax;
};

// A closest-hit lane's result so far: t, the leaf-order prim, the normal.
struct Hit {
  float best;
  int prim;
  float nx, ny, nz;
};

__device__ __forceinline__ Hit no_hit() {
  return Hit{kBig, -1, 0.0f, 0.0f, 0.0f};
}

// The closest-hit test (and the first design's any-hit test): every value,
// then the accept rule; p0, e1, e2 and n each three floats.
__device__ __forceinline__ bool mt_full(const float* p0, const float* e1,
                                        const float* e2, const float* n,
                                        const Ray& r, float* t_out) {
  const float cx = p0[0] - r.ox;
  const float cy = p0[1] - r.oy;
  const float cz = p0[2] - r.oz;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float inv_det = 1.0f / (r.dx * n[0] + r.dy * n[1] + r.dz * n[2]);
  const float u = inv_det * (e2[0] * rx + e2[1] * ry + e2[2] * rz);
  const float v = inv_det * (e1[0] * rx + e1[1] * ry + e1[2] * rz);
  const float t = inv_det * (cx * n[0] + cy * n[1] + cz * n[2]);
  *t_out = t;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= r.tmax);
}

// The any-hit test, rejecting on t first.  t needs only c, inv_det and n,
// formed by mt_full's operations in its order; a triangle whose t fails
// 0 < t <= tmax (NaN fails both) is one mt_full rejects too, so r, u and
// v, which decide nothing else, are formed only for the others, and then
// are mt_full's values: the occlusion is mt_full's bit for bit.
__device__ __forceinline__ bool anyhit_test(const Tri& tr, const Ray& r) {
  const float cx = tr.p0[0] - r.ox;
  const float cy = tr.p0[1] - r.oy;
  const float cz = tr.p0[2] - r.oz;
  const float inv_det =
      1.0f / (r.dx * tr.n[0] + r.dy * tr.n[1] + r.dz * tr.n[2]);
  const float t = inv_det * (cx * tr.n[0] + cy * tr.n[1] + cz * tr.n[2]);
  if (!((t > 0.0f) & (t <= r.tmax))) return false;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float u = inv_det * (tr.e2[0] * rx + tr.e2[1] * ry + tr.e2[2] * rz);
  const float v = inv_det * (tr.e1[0] * rx + tr.e1[1] * ry + tr.e1[2] * rz);
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);
}

}  // namespace rtjax_direct
