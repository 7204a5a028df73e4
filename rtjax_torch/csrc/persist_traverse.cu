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
// - dynamic fetch (Aila & Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009, persistent while-while): a grid of the
//   card's resident blocks, each warp drawing rays from one work counter.
//   A lane whose walk ends writes its results and, at the warp's next
//   step, draws a new ray (one atomicAdd per warp for all its empty lanes),
//   so a long walk holds one lane, not 31.  Inactive rays are written out
//   while drawing and never take a step.  The counter is a two-word
//   buffer per device and stream that the kernel resets itself: the last
//   block to finish zeroes it, so a launch costs no memset;
// - the stack in shared memory: tables.depth + 1 entries per thread (the
//   wrapper passes the length), laid out entry-major so that a warp's
//   lanes touch 32 banks, instead of a 64-entry array in local memory;
// - one step is the pending leaf rows of the current node, then the next
//   node's visit: every lane of a warp visits a node in the same step.
//
// The first design (each thread walks a fixed share of the rays, grid
// stride, with wide_walk.cuh's walk<>: scalar loads, one slot at a time,
// a 64-entry local-memory stack) stays behind the ``_stride`` entry
// points, which only the chip check and the card tests call, to time both
// designs in one run.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain versions (kernels/persist.py),
// which walk each ray in the same order; results agree bit for bit.

#include <cuda_runtime.h>

#include "wide_walk.cuh"

namespace {

using rtjax::Closest;
using rtjax::Ray;
using rtjax::grid_for;
using rtjax::kBlock;
using rtjax::kStack;
using rtjax::leaf_any_v;
using rtjax::leaf_closest_v;
using rtjax::load_ray;
using rtjax::pick;
using rtjax::slab_hits_v;
using rtjax::walk;

constexpr int kFetchBlock = 128;
constexpr unsigned kWarp = 0xffffffffu;
// leaf slots whose loads are issued together
constexpr int kLeafChunk = 4;
static_assert(8 % kLeafChunk == 0, "a leaf chunk must divide the 8 slots");

struct Tables {
  const float* nb;
  const int* cm;
  const int* ni;
  const float* lt;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmax;
  const unsigned char* active;
  const int* exclude;  // any hit only
};

struct Outs {
  unsigned char* hit;  // any hit: occluded
  float* t;
  int* prim;
  float *nx, *ny, *nz;
};

// One lane's walk: its ray and where it stands.
struct Lane {
  Ray r;
  float tmax;
  int exclude;
  Closest best;
  int cur;          // the node last visited; -1 before the root
  unsigned leaves;  // its hit leaf children not tested yet
  unsigned inner;   // its hit internal children
  unsigned rev;     // descend order at cur
  int sp;           // stack depth
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

// One step of a lane's walk: the leaf rows pending at its node in
// ascending slot order, then the next node (the first hit internal child,
// the rest pushed as one entry; else the top of the stack) and its slab
// tests.  Returns true when the walk is over: the stack is empty, or (any
// hit) a leaf occludes, which sets ``*occ``.
// The stack is entry-major in shared memory: a thread's entries lie
// kFetchBlock words apart.
template <int W, bool ANY>
__device__ __forceinline__ bool step(const Tables& tb, Lane& s,
                                     int* st_node, unsigned* st_mask,
                                     bool* occ) {
  constexpr unsigned kAll = (1u << W) - 1u;
  while (s.leaves) {
    const int c = __ffs(s.leaves) - 1;
    s.leaves &= s.leaves - 1u;
    const int mc = __ldg(tb.cm + (size_t)s.cur * W + c);
    const float* row = tb.lt + (size_t)(mc >> 4) * 128;
    if constexpr (ANY) {
      if (leaf_any_v<kLeafChunk>(row, mc & 15, s.r, s.tmax, s.exclude)) {
        *occ = true;
        return true;
      }
    } else {
      leaf_closest_v<kLeafChunk>(row, mc & 15, s.r, &s.tmax, &s.best);
    }
  }
  int next;
  if (s.cur < 0) {
    next = 0;
  } else if (s.inner) {
    const int first = pick(s.inner, s.rev);
    const unsigned rest = s.inner & ~(1u << first);
    if (rest) {
      st_node[s.sp * kFetchBlock] = s.cur;
      st_mask[s.sp * kFetchBlock] = (rest << 1) | s.rev;
      ++s.sp;
    }
    next = __ldg(tb.cm + (size_t)s.cur * W + first) >> 4;
  } else if (s.sp > 0) {
    const int top = (s.sp - 1) * kFetchBlock;
    const int pnode = st_node[top];
    const unsigned pm = st_mask[top];
    const unsigned m = pm >> 1, rev = pm & 1u;
    const int first = pick(m, rev);
    const unsigned rest = m & ~(1u << first);
    if (rest == 0u) --s.sp; else st_mask[top] = (rest << 1) | rev;
    next = __ldg(tb.cm + (size_t)pnode * W + first) >> 4;
  } else {
    return true;
  }
  const int info = __ldg(tb.ni + next);
  const unsigned lm = (unsigned)info & kAll;
  const float* row = tb.nb + (size_t)next * 128;
  const int* meta = tb.cm + (size_t)next * W;
  const unsigned hits = slab_hits_v<W>(row, meta, lm, s.r, s.tmax);
  s.cur = next;
  s.leaves = hits & lm;
  s.inner = hits & ~lm & kAll;
  s.rev = (s.r.oct >> ((info >> W) & 3)) & 1u;
  return false;
}

template <int W, bool ANY>
__global__ void __launch_bounds__(kFetchBlock)
fetch_kernel(const Tables tb, const Rays rays, const int n, const Outs out,
             unsigned* __restrict__ work, const int stack_len) {
  extern __shared__ int stack[];
  int* st_node = stack + threadIdx.x;
  unsigned* st_mask =
      reinterpret_cast<unsigned*>(stack + stack_len * kFetchBlock) +
      threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  bool more = true;  // warp-uniform: the counter may still hold rays
  int ray = -1;      // this lane's ray; -1 when it has none
  Lane s;
  while (true) {
    // refill: the empty lanes draw consecutive rays with one atomicAdd;
    // an inactive ray is written out at once and its lane draws again
    while (more) {
      const unsigned want = __ballot_sync(kWarp, ray < 0);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      const unsigned k = __popc(want);
      unsigned base = 0u;
      if ((int)lane == leader) base = atomicAdd(work, k);
      base = __shfl_sync(kWarp, base, leader);
      more = base + k < (unsigned)n;
      if (ray < 0) {
        const unsigned i = base + __popc(want & below);
        if (i < (unsigned)n) {
          if (rays.active[i]) {
            ray = (int)i;
            s.r = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy,
                           rays.dz, ray);
            s.tmax = rays.tmax[i];
            if constexpr (ANY) s.exclude = rays.exclude[i];
            s.best = Closest();
            s.cur = -1;
            s.leaves = 0u;
            s.inner = 0u;
            s.sp = 0;
          } else if constexpr (ANY) {
            out.hit[i] = 0;
          } else {
            store_closest(out, (int)i, Closest());
          }
        }
      }
    }
    if (__ballot_sync(kWarp, ray >= 0) == 0u) break;
    if (ray >= 0) {
      bool occ = false;
      if (step<W, ANY>(tb, s, st_node, st_mask, &occ)) {
        if constexpr (ANY) {
          out.hit[ray] = occ ? 1 : 0;
        } else {
          store_closest(out, ray, s.best);
        }
        ray = -1;
      }
    }
  }
  // the last block to finish resets the counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {
      atomicExch(work, 0u);
      atomicExch(work + 1, 0u);
    }
  }
}

// Resident blocks of fetch_kernel<W, ANY> at ``smem`` bytes of stack,
// cached per device and stack length; raises the kernel's dynamic shared
// memory cap above the default 48 KB where the stack needs it.
template <int W, bool ANY>
int fetch_grid(int n, int smem) {
  constexpr int kDevices = 16;
  static int cache[kDevices][kStack + 1];
  int dev = 0;
  cudaGetDevice(&dev);
  const int len = smem / (2 * 4 * kFetchBlock);
  int resident = dev < kDevices ? cache[dev][len] : 0;
  if (resident == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(fetch_kernel<W, ANY>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fetch_kernel<W, ANY>,
                                                  kFetchBlock, smem);
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kDevices) cache[dev][len] = resident;
  }
  const int needed = (n + kFetchBlock - 1) / kFetchBlock;
  return needed < resident ? needed : resident;
}

template <int W, bool ANY>
int launch_fetch(const Tables& tb, const Rays& rays, int n, const Outs& out,
                 unsigned* work, int stack_len, cudaStream_t s) {
  if (stack_len < 1 || stack_len > kStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 4 * stack_len * kFetchBlock;
  const int grid = fetch_grid<W, ANY>(n, smem);
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
             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) {
    return stride ? launch_stride<8, ANY>(tb, rays, n, out, s)
                  : launch_fetch<8, ANY>(tb, rays, n, out, work, stack_len, s);
  }
  if (width == 16) {
    return stride ? launch_stride<16, ANY>(tb, rays, n, out, s)
                  : launch_fetch<16, ANY>(tb, rays, n, out, work, stack_len,
                                          s);
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
