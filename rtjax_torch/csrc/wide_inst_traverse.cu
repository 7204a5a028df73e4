// Two-level (instanced) BVH traversal for Hopper (sm_90a): closest hit and
// any hit over the base scene and every instance in one launch, on the
// concatenated tables of rtjax_torch/accel/wide.py (InstancedTables).
//
// Replaces: rtjax/kernels/pallas_wide.py, wide_traverse_closest_inst
// (_make_closest_inst_kernel) and wide_traverse_anyhit_inst
// (_make_anyhit_inst_kernel).
//
// What bounds it on this card: the same pointer chase as the persistent
// walkers (persist_traverse.cu), once per instance a ray visits.  The
// tables of a 16-bunny scene are one BLAS (about 6 MB) plus the base, so
// they stay in the 50 MB L2 however many instances there are; the
// instance records (19 words each) stay in L1.  The limit is the latency
// of dependent L2 loads and the divergence of rays in a warp that visit
// different instances and subtrees.
//
// What the design does about it: the TPU kernel decides per 2048-ray tile
// which instances to visit and walks the tile's union of them; here one
// thread walks one ray, so each ray visits only the instances its own
// slab test admits.  Per ray: the world-ray slab precompute; each
// instance's entry distance (rtjax's _inst_entry_dist for this ray
// alone); instances visited nearest-first, lowest index on ties, each
// re-culled against the current best t so that closer hits prune farther
// instances; the ray moved into the instance's frame with the affine rows
// (not renormalised, so t stays in world units); then the persistent
// walkers' walk (wide_walk.cuh) from the instance's BLAS root.  The visit
// order needs no per-thread array: each step rescans the instances for the
// least (distance, index) above the last one visited.  Any hit passes the
// excluded prim only while walking instance 0 (lights live in the base
// scene) and returns at the first occluding instance.
//
// Exactness: the build uses --fmad=false and the plain versions
// (kernels/wide_inst.py) visit instances and nodes in the same order with
// the same operation order, so results agree bit for bit.  The normal is
// the LOCAL cross(e1, e2); the caller applies the instance's cofactor.

#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::Ray;
using rtjax::grid_for;
using rtjax::kBig;
using rtjax::kBlock;
using rtjax::make_ray;
using rtjax::slab;
using rtjax::walk;

constexpr int kAff = 18;  // 12 world->local affine floats + 6 AABB floats

// Entry distance of instance k's world AABB: max(entry, 0) when the box is
// hit within tmax, else kBig.
__device__ __forceinline__ float entry_dist(const float* __restrict__ aff,
                                            int k, const Ray& w, float tmax) {
  float entry, exit_;
  slab(aff + kAff * k + 12, w, &entry, &exit_);
  bool hit = (entry <= exit_) & (exit_ >= 0.0f) & (entry <= tmax);
  return hit ? fmaxf(entry, 0.0f) : kBig;
}

// The next instance after (d_last, k_last) in (distance, index) order,
// culled ones (kBig) left out; -1 when none is left.
__device__ __forceinline__ int next_inst(const float* __restrict__ aff,
                                         int n_inst, const Ray& w,
                                         float tmax0, float d_last,
                                         int k_last, float* d_next) {
  int best_k = -1;
  float best_d = kBig;
  for (int k = 0; k < n_inst; ++k) {
    float d = entry_dist(aff, k, w, tmax0);
    bool after = d > d_last || (d == d_last && k > k_last);
    if (after && d < best_d) {
      best_d = d;
      best_k = k;
    }
  }
  *d_next = best_d;
  return best_k;
}

// Re-cull of instance k against the current tmax (rtjax's fused _slab
// accept rule).
__device__ __forceinline__ bool still_hit(const float* __restrict__ aff,
                                          int k, const Ray& w, float tmax) {
  float entry, exit_;
  slab(aff + kAff * k + 12, w, &entry, &exit_);
  return fmaxf(entry, 0.0f) <= fminf(exit_, tmax);
}

// The world ray in instance k's frame, in rtjax's _inst_local_rays
// operation order.
__device__ __forceinline__ Ray local_ray(const float* __restrict__ aff, int k,
                                         const Ray& w) {
  const float* a = aff + kAff * k;
  float a0 = __ldg(a + 0), a1 = __ldg(a + 1), a2 = __ldg(a + 2);
  float a3 = __ldg(a + 3), a4 = __ldg(a + 4), a5 = __ldg(a + 5);
  float a6 = __ldg(a + 6), a7 = __ldg(a + 7), a8 = __ldg(a + 8);
  float a9 = __ldg(a + 9), a10 = __ldg(a + 10), a11 = __ldg(a + 11);
  return make_ray(a0 * w.ox + a1 * w.oy + a2 * w.oz + a3,
                  a4 * w.ox + a5 * w.oy + a6 * w.oz + a7,
                  a8 * w.ox + a9 * w.oy + a10 * w.oz + a11,
                  a0 * w.dx + a1 * w.dy + a2 * w.dz,
                  a4 * w.dx + a5 * w.dy + a6 * w.dz,
                  a8 * w.dx + a9 * w.dy + a10 * w.dz);
}

template <int W>
__global__ void __launch_bounds__(kBlock)
inst_closest_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                    const int* __restrict__ ni, const float* __restrict__ lt,
                    const int* __restrict__ root,
                    const float* __restrict__ aff, int n_inst,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ tmax_in,
                    const unsigned char* __restrict__ active, int n,
                    unsigned char* __restrict__ hit, float* __restrict__ t_out,
                    int* __restrict__ prim, int* __restrict__ inst,
                    float* __restrict__ nx, float* __restrict__ ny,
                    float* __restrict__ nz) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Closest best;
    int best_inst = 0;
    if (active[i]) {
      Ray w = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      const float tmax0 = tmax_in[i];
      float tmax = tmax0;
      float d = -1.0f;
      int k = -1;
      while ((k = next_inst(aff, n_inst, w, tmax0, d, k, &d)) >= 0) {
        if (!still_hit(aff, k, w, tmax)) continue;
        Closest c;
        walk<W, false>(nb, cm, ni, lt, local_ray(aff, k, w), tmax, -1, &c,
                       __ldg(root + k));
        if (c.prim >= 0) {
          best = c;
          best_inst = k;
          tmax = c.t;
        }
      }
    }
    hit[i] = best.prim >= 0 ? 1 : 0;
    t_out[i] = best.t;
    prim[i] = best.prim;
    inst[i] = best_inst;
    nx[i] = best.nx;
    ny[i] = best.ny;
    nz[i] = best.nz;
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
inst_anyhit_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                   const int* __restrict__ ni, const float* __restrict__ lt,
                   const int* __restrict__ root,
                   const float* __restrict__ aff, int n_inst,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tmax_in,
                   const unsigned char* __restrict__ active,
                   const int* __restrict__ exclude, int n,
                   unsigned char* __restrict__ occ) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool o = false;
    if (active[i]) {
      Ray w = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      const float tmax = tmax_in[i];
      float d = -1.0f;
      int k = -1;
      while (!o && (k = next_inst(aff, n_inst, w, tmax, d, k, &d)) >= 0) {
        if (!still_hit(aff, k, w, tmax)) continue;
        o = walk<W, true>(nb, cm, ni, lt, local_ray(aff, k, w), tmax,
                          k == 0 ? exclude[i] : -1, nullptr,
                          __ldg(root + k));
      }
    }
    occ[i] = o ? 1 : 0;
  }
}

}  // namespace

extern "C" int rtjax_inst_closest(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active, int n,
    unsigned char* hit, float* t, int* prim, int* inst, float* nx, float* ny,
    float* nz, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    inst_closest_kernel<8><<<grid_for(inst_closest_kernel<8>, n), kBlock, 0,
                             s>>>(nb, cm, ni, lt, root, aff, n_inst, ox, oy,
                                  oz, dx, dy, dz, tmax, active, n, hit, t,
                                  prim, inst, nx, ny, nz);
  } else if (width == 16) {
    inst_closest_kernel<16><<<grid_for(inst_closest_kernel<16>, n), kBlock, 0,
                              s>>>(nb, cm, ni, lt, root, aff, n_inst, ox, oy,
                                   oz, dx, dy, dz, tmax, active, n, hit, t,
                                   prim, inst, nx, ny, nz);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_inst_anyhit(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active,
    const int* exclude, int n, unsigned char* occ, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    inst_anyhit_kernel<8><<<grid_for(inst_anyhit_kernel<8>, n), kBlock, 0,
                            s>>>(nb, cm, ni, lt, root, aff, n_inst, ox, oy,
                                 oz, dx, dy, dz, tmax, active, exclude, n,
                                 occ);
  } else if (width == 16) {
    inst_anyhit_kernel<16><<<grid_for(inst_anyhit_kernel<16>, n), kBlock, 0,
                             s>>>(nb, cm, ni, lt, root, aff, n_inst, ox, oy,
                                  oz, dx, dy, dz, tmax, active, exclude, n,
                                  occ);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
