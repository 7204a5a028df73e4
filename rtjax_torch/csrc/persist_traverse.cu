// Persistent-walker BVH traversal for Hopper (sm_90a): closest hit and
// any hit over the wide-node tables of rtjax_torch/accel/wide.py.
//
// Replaces: rtjax/kernels/pallas_lane_persist.py, persist_traverse_closest
// (_make_persist_closest_kernel) and persist_traverse_anyhit
// (_make_persist_anyhit_kernel).
//
// What bounds it on this card.  Counted from the rays (chip_smoke.py prints
// it per launch): the bytes that must move -- each ray's inputs read once,
// its results written once, and once each the child boxes, metas and info
// word of every node visited and the real triangles of every leaf row
// tested -- over 3.35 TB/s, against ~25 float operations per non-empty
// child slab test and ~42 per triangle test over 67 TFLOP/s.  Bytes set
// the bound, 2-6 microseconds for 2^17-2^19 rays; the kernels take some
// 17-45 times that.  What holds them there is the walk's loads: a node
// visit reads its child boxes (24 bytes a child) and metas, and each leaf
// row up to 8 triangles of 48 bytes, every lane from its own row, and
// each read waits on L1 or L2 before the tests that need it.
// tools/persist_variants.py times the design against each part of it
// undone (a patched copy of this file per variant), on one H100: the load
// shape carries the gain; refilling lanes, the stack's place, the block
// size and a register count that does not spill each move the time by at
// most ~12% (PERF.md).
//
// What the design does about it:
// - wide loads: child boxes and triangles are read as float4 (three per
//   child pair, three per triangle), the child metas as int4, all through
//   the read-only path, where the upper levels, which every ray reads,
//   stay in L1;
// - leaf slots four at a time: the loads of four triangles are issued
//   together, then the four are tested in slot order, so a leaf row costs
//   two round trips, not eight (96 registers, no spills);
// - dynamic fetch (fetch_walk.cuh, shared with the two-level kernels):
//   each warp draws rays from a self-resetting work counter, a lane whose
//   walk ends writes its results and draws a new ray at the warp's next
//   step (kRefill 1), so a long walk holds one lane, not 31; inactive rays
//   are written out while drawing and never take a step;
// - the stack in shared memory: tables.depth + 1 entries per thread (the
//   wrapper passes the length), entry-major, instead of a 64-entry array
//   in local memory.
//
// The first design (each thread walks a fixed share of the rays, grid
// stride, with wide_walk.cuh's walk<>: scalar loads, one slot at a time,
// a 64-entry local-memory stack) stays behind the ``_stride`` entry
// points, which only the chip check and the card tests call, to time both
// designs in one run.
//
// The stats instances (``rtjax_persist_*_stats``, fetch_stats_kernel) are
// the same walk with fetch_walk.cuh's counting on: per lane, the node
// visits and leaf rows of the rays it walks, summed per warp into a
// two-word 64-bit buffer that the wrapper zeroes (not the work counter,
// which stays self-resetting).  The counts equal the plain walk's
// ``node_visits`` and ``leaf_rows`` as integers, and the results equal
// the default instances' bit for bit.  The default instances are
// unchanged.  The port counts per-ray node visits and leaf rows; rtjax's
// Pallas kernels count TPU walk rounds per sublane tile, a count of the
// TPU's structure that is not carried over.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain versions (kernels/persist.py),
// which walk each ray in the same order; results agree bit for bit.

#include <cuda_runtime.h>

#include "fetch_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::Lane;
using rtjax::Ray;
using rtjax::Rays;
using rtjax::Tables;
using rtjax::enter;
using rtjax::fetch_grid;
using rtjax::fetch_rays;
using rtjax::grid_for;
using rtjax::kBlock;
using rtjax::kFetchBlock;
using rtjax::kStack;
using rtjax::load_ray;
using rtjax::walk;

struct Outs {
  unsigned char* hit;  // any hit: occluded
  float* t;
  int* prim;
  float *nx, *ny, *nz;
};

__device__ __forceinline__ void store_closest(const Outs& o, int i,
                                              const Closest& b) {
  o.hit[i] = b.prim >= 0 ? 1 : 0;
  o.t[i] = b.t;
  o.prim[i] = b.prim;
  o.nx[i] = b.nx;
  o.ny[i] = b.ny;
  o.nz[i] = b.nz;
}

// fetch_rays' job: one walk from the root per ray.  Inactive rays are
// written out while drawing and never take a step.
template <bool ANY>
struct Walk {
  static constexpr int kRefill = 1;
  const Rays& rays;
  const Outs& out;

  __device__ __forceinline__ bool start(Lane& s, int i) const {
    if (!rays.active[i]) {
      if constexpr (ANY) {
        out.hit[i] = 0;
      } else {
        store_closest(out, i, Closest());
      }
      return false;
    }
    s.r = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz, i);
    s.tmax = rays.tmax[i];
    if constexpr (ANY) s.exclude = rays.exclude[i];
    s.best = Closest();
    enter(s, 0);
    return true;
  }

  __device__ __forceinline__ bool after(Lane& s, int i, bool done,
                                        bool hit) const {
    if (!done) return false;
    if constexpr (ANY) {
      out.hit[i] = hit ? 1 : 0;
    } else {
      store_closest(out, i, s.best);
    }
    return true;
  }
};

template <int W, bool ANY>
__global__ void __launch_bounds__(kFetchBlock)
fetch_kernel(const Tables tb, const Rays rays, const int n, const Outs out,
             unsigned* __restrict__ work, const int stack_len) {
  extern __shared__ int stack[];
  int* st_node = stack + threadIdx.x;
  unsigned* st_mask =
      reinterpret_cast<unsigned*>(stack + stack_len * kFetchBlock) +
      threadIdx.x;
  Walk<ANY> job{rays, out};
  fetch_rays<W, ANY>(tb, job, n, work, st_node, st_mask);
}

// The stats instance: the same walk, counting (fetch_walk.cuh) into
// ``stats`` (two zeroed 64-bit words: node visits, leaf rows).
template <int W, bool ANY>
__global__ void __launch_bounds__(kFetchBlock)
fetch_stats_kernel(const Tables tb, const Rays rays, const int n,
                   const Outs out, unsigned* __restrict__ work,
                   const int stack_len,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ int stack[];
  Walk<ANY> job{rays, out};
  fetch_rays<W, ANY, true>(
      tb, job, n, work, stack + threadIdx.x,
      reinterpret_cast<unsigned*>(stack + stack_len * kFetchBlock) +
          threadIdx.x,
      stats);
}

// ``stats`` null: the default instance; else the stats instance.
template <int W, bool ANY>
int launch_fetch(const Tables& tb, const Rays& rays, int n, const Outs& out,
                 unsigned* work, int stack_len, unsigned long long* stats,
                 cudaStream_t s) {
  if (stack_len < 1 || stack_len > kStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 4 * stack_len * kFetchBlock;
  if (stats != nullptr) {
    const int grid = fetch_grid<fetch_stats_kernel<W, ANY>>(n, smem);
    if (grid < 0) return static_cast<int>(cudaErrorInvalidDevice);
    fetch_stats_kernel<W, ANY><<<grid, kFetchBlock, smem, s>>>(
        tb, rays, n, out, work, stack_len, stats);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = fetch_grid<fetch_kernel<W, ANY>>(n, smem);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidDevice);
  fetch_kernel<W, ANY><<<grid, kFetchBlock, smem, s>>>(tb, rays, n, out, work,
                                                        stack_len);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the first design

template <int W>
__global__ void __launch_bounds__(kBlock)
stride_closest_kernel(const Tables tb, const Rays rays, const int n,
                      const Outs out) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Closest best;
    if (rays.active[i]) {
      Ray r = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz,
                       i);
      walk<W, false>(tb.nb, tb.cm, tb.ni, tb.lt, r, rays.tmax[i], -1, &best,
                     0);
    }
    store_closest(out, i, best);
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
stride_anyhit_kernel(const Tables tb, const Rays rays, const int n,
                     const Outs out) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool o = false;
    if (rays.active[i]) {
      Ray r = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz,
                       i);
      o = walk<W, true>(tb.nb, tb.cm, tb.ni, tb.lt, r, rays.tmax[i],
                        rays.exclude[i], nullptr, 0);
    }
    out.hit[i] = o ? 1 : 0;
  }
}

template <int W, bool ANY>
int launch_stride(const Tables& tb, const Rays& rays, int n, const Outs& out,
                  cudaStream_t s) {
  if constexpr (ANY) {
    stride_anyhit_kernel<W><<<grid_for(stride_anyhit_kernel<W>, n), kBlock,
                              0, s>>>(tb, rays, n, out);
  } else {
    stride_closest_kernel<W><<<grid_for(stride_closest_kernel<W>, n), kBlock,
                               0, s>>>(tb, rays, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- entry points

template <bool ANY>
int dispatch(int width, bool stride, const Tables& tb, const Rays& rays,
             int n, const Outs& out, unsigned* work, int stack_len,
             void* stream, unsigned long long* stats = nullptr) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    return stride ? launch_stride<8, ANY>(tb, rays, n, out, s)
                  : launch_fetch<8, ANY>(tb, rays, n, out, work, stack_len,
                                         stats, s);
  }
  if (width == 16) {
    return stride ? launch_stride<16, ANY>(tb, rays, n, out, s)
                  : launch_fetch<16, ANY>(tb, rays, n, out, work, stack_len,
                                          stats, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ``work``: two zeroed unsigned words per device and stream, left zeroed
// by every launch.  ``stack_len``: stack entries per ray, 1..64.
extern "C" int rtjax_persist_closest(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, unsigned* work, int stack_len,
    void* stream) {
  return dispatch<false>(width, false, {nb, cm, ni, lt},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, nx, ny, nz}, work, stack_len, stream);
}

extern "C" int rtjax_persist_anyhit(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n, unsigned char* occ,
    unsigned* work, int stack_len, void* stream) {
  return dispatch<true>(width, false, {nb, cm, ni, lt},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr},
                        work, stack_len, stream);
}

// The stats instances: as above, plus ``stats``, two zeroed 64-bit words
// to which the launch adds its node visits and leaf rows.
extern "C" int rtjax_persist_closest_stats(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, unsigned* work, int stack_len,
    unsigned long long* stats, void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(width, false, {nb, cm, ni, lt},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, nx, ny, nz}, work, stack_len, stream,
                         stats);
}

extern "C" int rtjax_persist_anyhit_stats(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n, unsigned char* occ,
    unsigned* work, int stack_len, unsigned long long* stats, void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(width, false, {nb, cm, ni, lt},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr},
                        work, stack_len, stream, stats);
}

// The first design, for same-run A/B only (no engine path reaches these).
extern "C" int rtjax_persist_closest_stride(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, void* stream) {
  return dispatch<false>(width, true, {nb, cm, ni, lt},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, nx, ny, nz}, nullptr, 0, stream);
}

extern "C" int rtjax_persist_anyhit_stride(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n, unsigned char* occ,
    void* stream) {
  return dispatch<true>(width, true, {nb, cm, ni, lt},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr},
                        nullptr, 0, stream);
}
