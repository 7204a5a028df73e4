// Persistent-walker BVH traversal for Hopper (sm_90a): closest hit and
// any hit over the wide-node tables of rtjax_torch/accel/wide.py.
//
// Replaces: rtjax/kernels/pallas_lane_persist.py, persist_traverse_closest
// (_make_persist_closest_kernel) and persist_traverse_anyhit
// (_make_persist_anyhit_kernel).
//
// What bounds it on this card: a pointer chase.  Every step loads one
// node row, slab-tests its 8 or 16 children and decides where to go next;
// every leaf visit loads one 512-byte leaf row and runs 8 ray-triangle
// tests.  The tables of the headline scene (about 6.5 MB) stay resident
// in the 50 MB L2, so DRAM bandwidth is not the limit, and the tensor
// cores have nothing to do.  The limit is the latency of the dependent
// L2 loads and the divergence of rays in a warp that walk different
// subtrees.
//
// What the design does about it: one thread walks one ray with a private
// stack of (node, remaining-children mask) entries, so no ray waits for
// another at a barrier (the TPU kernel emulates exactly this with 16
// sublane walkers and leaf FIFO rings, which exist only to hide the TPU's
// vector->scalar latency and have no counterpart here).  Threads are
// persistent: a grid sized to the card's resident capacity strides over
// the rays, and the engine sorts rays by origin cell and direction
// beforehand, so neighbouring threads walk similar subtrees.  Tables are
// read through the read-only path (__ldg).  Leaf children are tested
// inline, so tmax shrinks as early as possible and prunes the rest of the
// walk.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain versions (kernels/persist.py),
// which walk the same order; results agree bit for bit.  The walk itself
// is in wide_walk.cuh, shared with the two-level kernels.

#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::Ray;
using rtjax::grid_for;
using rtjax::kBlock;
using rtjax::load_ray;
using rtjax::walk;

template <int W>
__global__ void __launch_bounds__(kBlock)
persist_closest_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                       const int* __restrict__ ni, const float* __restrict__ lt,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float* __restrict__ tmax_in,
                       const unsigned char* __restrict__ active, int n,
                       unsigned char* __restrict__ hit,
                       float* __restrict__ t_out, int* __restrict__ prim,
                       float* __restrict__ nx, float* __restrict__ ny,
                       float* __restrict__ nz) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Closest best;
    if (active[i]) {
      Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      walk<W, false>(nb, cm, ni, lt, r, tmax_in[i], -1, &best, 0);
    }
    hit[i] = best.prim >= 0 ? 1 : 0;
    t_out[i] = best.t;
    prim[i] = best.prim;
    nx[i] = best.nx;
    ny[i] = best.ny;
    nz[i] = best.nz;
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
persist_anyhit_kernel(const float* __restrict__ nb, const int* __restrict__ cm,
                      const int* __restrict__ ni, const float* __restrict__ lt,
                      const float* __restrict__ ox,
                      const float* __restrict__ oy,
                      const float* __restrict__ oz,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ dz,
                      const float* __restrict__ tmax_in,
                      const unsigned char* __restrict__ active,
                      const int* __restrict__ exclude, int n,
                      unsigned char* __restrict__ occ) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool o = false;
    if (active[i]) {
      Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      o = walk<W, true>(nb, cm, ni, lt, r, tmax_in[i], exclude[i], nullptr,
                       0);
    }
    occ[i] = o ? 1 : 0;
  }
}

}  // namespace

extern "C" int rtjax_persist_closest(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    persist_closest_kernel<8><<<grid_for(persist_closest_kernel<8>, n),
                                kBlock, 0, s>>>(
        nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, n, hit, t, prim,
        nx, ny, nz);
  } else if (width == 16) {
    persist_closest_kernel<16><<<grid_for(persist_closest_kernel<16>, n),
                                 kBlock, 0, s>>>(
        nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, n, hit, t, prim,
        nx, ny, nz);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_persist_anyhit(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n, unsigned char* occ,
    void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    persist_anyhit_kernel<8><<<grid_for(persist_anyhit_kernel<8>, n), kBlock,
                               0, s>>>(
        nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, exclude, n, occ);
  } else if (width == 16) {
    persist_anyhit_kernel<16><<<grid_for(persist_anyhit_kernel<16>, n),
                                kBlock, 0, s>>>(
        nb, cm, ni, lt, ox, oy, oz, dx, dy, dz, tmax, active, exclude, n, occ);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
