// The direct pair's launch logic on the host, over the device code of
// rtjax_torch/csrc/direct_math.cuh compiled as C++ (tests/
// test_torch_direct.py builds it with g++ and binds it with
// kernels/direct.py ``bind``, so that the real ctypes wrappers run it on
// CPU tensors).  Each entry point of csrc/direct_traverse.cu is a loop:
// closest hit and any hit's first design lane by lane; any hit window by
// window (the window's dead lanes get 0, then its live lanes, in order,
// the triangle loop over the staged records).
#include <vector>
#define __device__
#define __forceinline__ inline
#include "direct_math.cuh"
using namespace rtjax_direct;

namespace {
constexpr int kWindow = 2 * 128;  // csrc/direct_traverse.cu kWindow
constexpr int kInvalid = 1;       // cudaErrorInvalidValue

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  Ray at(int i) const {
    return Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i], tmax[i]};
  }
};

// The records any hit stages from the four [T, 3] arrays.
std::vector<Tri> records(const float* const* arr, int num) {
  std::vector<Tri> tris(num);
  for (int k = 0; k < num; ++k) {
    float* dst = reinterpret_cast<float*>(&tris[k]);
    for (int f = 0; f < 12; ++f) dst[f] = arr[f / 3][3 * k + f % 3];
  }
  return tris;
}
}  // namespace

extern "C" int rtjax_direct_closest(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, void*) {
  if (n <= 0) return 0;
  if (num < 0) return kInvalid;
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax};
  for (int i = 0; i < n; ++i) {
    Hit h = no_hit();
    if (active[i]) {
      const Ray r = rays.at(i);
      for (int k = 0; k < num; ++k) {
        float tk;
        if (mt_full(p0 + 3 * k, e1 + 3 * k, e2 + 3 * k, nrm + 3 * k, r,
                    &tk) && tk < h.best)
          h = Hit{tk, k, nrm[3 * k], nrm[3 * k + 1], nrm[3 * k + 2]};
      }
    }
    hit[i] = h.prim >= 0 ? 1 : 0;
    t[i] = h.best;
    prim[i] = h.prim;
    nx[i] = h.nx;
    ny[i] = h.ny;
    nz[i] = h.nz;
  }
  return 0;
}

extern "C" int rtjax_direct_anyhit(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void*) {
  if (n <= 0) return 0;
  if (num < 0) return kInvalid;
  const float* arr[4] = {p0, e1, e2, nrm};
  const std::vector<Tri> tris = records(arr, num);
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax};
  std::vector<int> list;
  for (int base = 0; base < n; base += kWindow) {
    list.clear();
    for (int i = base; i < n && i < base + kWindow; ++i) {
      if (active[i]) list.push_back(i);
      else occ[i] = 0;
    }
    for (int i : list) {
      const Ray r = rays.at(i);
      bool o = false;
      for (int k = 0; k < num && !o; ++k)
        o = k != exclude[i] && anyhit_test(tris[k], r);
      occ[i] = o ? 1 : 0;
    }
  }
  return 0;
}

extern "C" int rtjax_direct_anyhit_v1(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void*) {
  if (n <= 0) return 0;
  if (num < 0) return kInvalid;
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax};
  for (int i = 0; i < n; ++i) {
    bool o = false;
    if (active[i]) {
      const Ray r = rays.at(i);
      for (int k = 0; k < num && !o; ++k) {
        float tk;
        o = mt_full(p0 + 3 * k, e1 + 3 * k, e2 + 3 * k, nrm + 3 * k, r,
                    &tk) && k != exclude[i];
      }
    }
    occ[i] = o ? 1 : 0;
  }
  return 0;
}
