// Two-level (instanced) BVH traversal for Hopper (sm_90a): closest hit and
// any hit over the base scene and every instance in one launch, on the
// concatenated tables of rtjax_torch/accel/wide.py (InstancedTables).
//
// Replaces: rtjax/kernels/pallas_wide.py, wide_traverse_closest_inst
// (_make_closest_inst_kernel) and wide_traverse_anyhit_inst
// (_make_anyhit_inst_kernel).
//
// What bounds it on this card.  Counted from the rays (chip_smoke.py
// prints it per launch): the bytes that must move -- each ray's inputs and
// results, the instance records once, and once each the child boxes,
// metas and info word of every node visited and the real triangles of
// every leaf row tested -- over 3.35 TB/s, against ~25 float operations
// per box test (instance boxes included), ~42 per triangle test and ~51
// per instance entered over 67 TFLOP/s.  Bytes set the bound at config
// 4's 17 instances, a few microseconds for 2^17-2^18 rays; the instance
// box tests set it at 64.  What holds a kernel far above it is the same
// pointer chase as the persistent walkers' (persist_traverse.cu), once per
// instance a ray enters, and, per entry, the search for the next instance
// in visit order: a full rescan of the I instance boxes, so that a ray
// entering v of them makes about I * (v + 1) box tests besides its walks.
//
// What the design does about it: it is the persistent walkers' fetch
// design (fetch_walk.cuh) with an instance loop around each lane's walk.
// - Dynamic fetch from the persist kernels' work counter (one per device
//   and stream, shared with them).  A lane is a persist lane plus its
//   instance state: the instance it walks, the last (distance, index)
//   visited and, for closest hit, the instance of its best hit.  When a
//   lane's walk of one BLAS ends, the same warp step picks its next
//   instance, re-culls it, moves the ray into its frame and sets the walk
//   at its root, which the next step visits; when no instance is left the
//   lane writes its results and draws a new ray at a later refill: the
//   warp draws once 8 of its lanes are empty, so that the first scans of
//   the rays drawn (every instance box) run together, not one lane's while
//   31 wait.  A ray that is inactive or meets no instance box is written
//   out while drawing and never takes a step.  Per-ray work varies more
//   than in a single-level walk (0 to several instance walks), and a few
//   lanes, not a warp, wait for it.
// - The instance records in shared memory: each block copies the I x 18
//   affine and box floats and the I roots once, with coalesced loads, so
//   the rescans, re-culls and transforms read shared memory (a warp's
//   lanes at one instance read one word: a broadcast).  The records are 76
//   bytes each, not 16-byte aligned, and need no change of layout to be
//   staged this way.  Where the records and the stack would pass the
//   card's opt-in shared memory per block, the wrapper picks the same
//   kernel template reading them from global memory (STAGED false).
// - 16-byte loads of child boxes, metas and triangles, four leaf slots'
//   loads issued together (wide_walk.cuh's *_v tests).
// - The stack in shared memory, depth + 1 entries per thread, where the
//   concatenated tables' depth is the deepest of the base tree and every
//   BLAS; a walk ends with an empty stack, so a ray's instances share it.
// - The world ray and its slab precompute stay in registers across a
//   ray's instances: 95-127 registers, no spills at widths 8 and 16.
// - The visit order needs no per-thread array of distances: each entry
//   rescans the instances for the least (distance, index) above the last
//   one visited, which is the plain version's stable sort, ties included.
//   A ray's first scan tests every instance; a 64-bit mask then keeps
//   which of instances 0..63 are still in reach and not yet passed, and
//   later scans test only those (and every instance from 64 on), so the
//   rescans cost about I + v * (instances in reach) box tests, not
//   I * (v + 1).
// Any hit passes the excluded prim only while walking instance 0 (lights
// live in the base scene) and ends at the first occluding instance.
//
// The first design (one thread per ray, grid stride, the instance records
// read from global memory, wide_walk.cuh's walk<> with scalar loads, one
// leaf slot at a time and a 64-entry local-memory stack) stays
// behind the ``_stride`` entry points, which only the chip check and the
// card tests call, to time both designs in one run.
//
// The stats instances (the ``rtjax_inst_*_stats`` entries) run the same
// walk with fetch_walk.cuh's STATS flag: each lane counts the node visits
// and leaf rows of every BLAS walk it makes, the plain two-level walk's
// ``node_visits`` and ``leaf_rows`` (kernels/wide_inst.py), and each warp
// adds its sums to a two-word buffer that the wrapper zeroes.  The first
// design has none.
//
// Exactness: the build uses --fmad=false and the plain versions
// (kernels/wide_inst.py) visit instances and nodes in the same order with
// the same operation order, so results agree bit for bit.  The normal is
// the LOCAL cross(e1, e2); the caller applies the instance's cofactor.

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
using rtjax::kBig;
using rtjax::kBlock;
using rtjax::kFetchBlock;
using rtjax::kStack;
using rtjax::load_ray;
using rtjax::make_ray;
using rtjax::slab6;
using rtjax::walk;

constexpr int kAff = 18;  // 12 world->local affine floats + 6 AABB floats
// bytes of one instance record staged in shared memory: affine, box, root
constexpr int kRecord = 4 * (kAff + 1);

struct Insts {
  const int* root;
  const float* aff;
  int n;
};

struct Outs {
  unsigned char* hit;  // any hit: occluded
  float* t;
  int* prim;
  int* inst;
  float *nx, *ny, *nz;
};

// A record word: from shared memory (SHARED) or through the read-only
// path from global memory.
template <bool SHARED, typename T>
__device__ __forceinline__ T rec(const T* p) {
  if constexpr (SHARED) return *p; else return __ldg(p);
}

// Slab entry and exit of instance k's world AABB.
template <bool SHARED>
__device__ __forceinline__ void inst_slab(const float* aff, int k,
                                          const Ray& w, float* entry,
                                          float* exit_) {
  const float* b = aff + kAff * k + 12;
  slab6(rec<SHARED>(b + 0), rec<SHARED>(b + 1), rec<SHARED>(b + 2),
        rec<SHARED>(b + 3), rec<SHARED>(b + 4), rec<SHARED>(b + 5), w, entry,
        exit_);
}

// Entry distance of instance k's world AABB: max(entry, 0) when the box is
// hit within tmax, else kBig.  (The plain version writes +0 for a -0
// entry; the compares below do not tell them apart.)
template <bool SHARED>
__device__ __forceinline__ float entry_dist(const float* aff, int k,
                                            const Ray& w, float tmax) {
  float entry, exit_;
  inst_slab<SHARED>(aff, k, w, &entry, &exit_);
  bool hit = (entry <= exit_) & (exit_ >= 0.0f) & (entry <= tmax);
  return hit ? fmaxf(entry, 0.0f) : kBig;
}

// The next instance after (d_last, k_last) in (distance, index) order,
// culled ones (kBig) left out; -1 when none is left.
template <bool SHARED>
__device__ __forceinline__ int next_inst(const float* aff, int n_inst,
                                         const Ray& w, float tmax0,
                                         float d_last, int k_last,
                                         float* d_next) {
  int best_k = -1;
  float best_d = kBig;
  for (int k = 0; k < n_inst; ++k) {
    float d = entry_dist<SHARED>(aff, k, w, tmax0);
    bool after = d > d_last || (d == d_last && k > k_last);
    if (after && d < best_d) {
      best_d = d;
      best_k = k;
    }
  }
  *d_next = best_d;
  return best_k;
}

// next_inst over the instances a ray can still visit: the set bits of
// ``*near`` among instances 0..63, and every instance from 64 on.  The
// first scan of a ray (``first``) tests instances 0..63 and sets ``*near``
// to those whose entry distance is below kBig; a later scan clears the
// instances at or before (d_last, k_last) in the visit order.  An instance
// left out can never come after the last one visited (its distance does
// not change), so the result is next_inst's, ties included, and a ray
// entering v of I instances makes about I + v * (the instances in reach)
// box tests instead of I * (v + 1).
template <bool SHARED>
__device__ __forceinline__ int next_near(const float* aff, int n_inst,
                                         const Ray& w, float tmax0,
                                         float d_last, int k_last,
                                         unsigned long long* near,
                                         bool first, float* d_next) {
  int best_k = -1;
  float best_d = kBig;
  const int low = n_inst < 64 ? n_inst : 64;
  unsigned long long m = first ? (low == 64 ? ~0ull : (1ull << low) - 1ull)
                               : *near;
  unsigned long long keep = 0ull;
  for (; m; m &= m - 1ull) {
    const int k = __ffsll(m) - 1;
    const float d = entry_dist<SHARED>(aff, k, w, tmax0);
    const bool after = d > d_last || (d == d_last && k > k_last);
    if (after && d < kBig) keep |= 1ull << k;
    if (after && d < best_d) {
      best_d = d;
      best_k = k;
    }
  }
  *near = keep;
  for (int k = low; k < n_inst; ++k) {
    const float d = entry_dist<SHARED>(aff, k, w, tmax0);
    const bool after = d > d_last || (d == d_last && k > k_last);
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
template <bool SHARED>
__device__ __forceinline__ bool still_hit(const float* aff, int k,
                                          const Ray& w, float tmax) {
  float entry, exit_;
  inst_slab<SHARED>(aff, k, w, &entry, &exit_);
  return fmaxf(entry, 0.0f) <= fminf(exit_, tmax);
}

// The world ray in instance k's frame, in rtjax's _inst_local_rays
// operation order.
template <bool SHARED>
__device__ __forceinline__ Ray local_ray(const float* aff, int k,
                                         const Ray& w) {
  const float* a = aff + kAff * k;
  float a0 = rec<SHARED>(a + 0), a1 = rec<SHARED>(a + 1);
  float a2 = rec<SHARED>(a + 2), a3 = rec<SHARED>(a + 3);
  float a4 = rec<SHARED>(a + 4), a5 = rec<SHARED>(a + 5);
  float a6 = rec<SHARED>(a + 6), a7 = rec<SHARED>(a + 7);
  float a8 = rec<SHARED>(a + 8), a9 = rec<SHARED>(a + 9);
  float a10 = rec<SHARED>(a + 10), a11 = rec<SHARED>(a + 11);
  return make_ray(a0 * w.ox + a1 * w.oy + a2 * w.oz + a3,
                  a4 * w.ox + a5 * w.oy + a6 * w.oz + a7,
                  a8 * w.ox + a9 * w.oy + a10 * w.oz + a11,
                  a0 * w.dx + a1 * w.dy + a2 * w.dz,
                  a4 * w.dx + a5 * w.dy + a6 * w.dz,
                  a8 * w.dx + a9 * w.dy + a10 * w.dz);
}

__device__ __forceinline__ void store_closest(const Outs& o, int i,
                                              const Closest& b, int inst) {
  o.hit[i] = b.prim >= 0 ? 1 : 0;
  o.t[i] = b.t;
  o.prim[i] = b.prim;
  o.inst[i] = inst;
  o.nx[i] = b.nx;
  o.ny[i] = b.ny;
  o.nz[i] = b.nz;
}

// fetch_rays' job: one BLAS walk per instance a ray visits.  Closest hit
// carries the lane's best hit and tmax across its instances.
template <bool ANY, bool SHARED>
struct InstWalk {
  // a lane that draws a ray scans every instance before its first walk:
  // lanes that draw together scan together
  static constexpr int kRefill = 8;
  const Rays& rays;
  const Outs& out;
  const float* aff;   // the records, in shared or global memory
  const int* root;
  int n_inst;
  int k;          // the instance walked
  float d;        // its entry distance
  int best_inst;  // closest hit: the instance of s.best
  unsigned long long near;  // next_near's instances in reach
  Ray world;                // the ray in world space

  // Set the lane at the root of ray i's next instance that the re-cull
  // keeps, in that instance's frame; false when none is left.  ``first``:
  // the ray's first call.
  __device__ __forceinline__ bool next(Lane& s, int i, bool first) {
    const Ray& w = world;
    const float tmax0 = rays.tmax[i];
    while ((k = next_near<SHARED>(aff, n_inst, w, tmax0, d, k, &near, first,
                                  &d)) >= 0) {
      first = false;
      if (!still_hit<SHARED>(aff, k, w, s.tmax)) continue;
      s.r = local_ray<SHARED>(aff, k, w);
      if constexpr (ANY) s.exclude = k == 0 ? rays.exclude[i] : -1;
      enter(s, rec<SHARED>(root + k));
      return true;
    }
    return false;
  }

  __device__ __forceinline__ void finish(const Lane& s, int i, bool occ) {
    if constexpr (ANY) {
      out.hit[i] = occ ? 1 : 0;
    } else {
      store_closest(out, i, s.best, best_inst);
    }
  }

  __device__ __forceinline__ bool start(Lane& s, int i) {
    s.best = Closest();
    best_inst = 0;
    if (rays.active[i]) {
      s.tmax = rays.tmax[i];
      k = -1;
      d = -1.0f;
      world = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz,
                       i);
      if (next(s, i, true)) return true;
    }
    finish(s, i, false);
    return false;
  }

  __device__ __forceinline__ bool after(Lane& s, int i, bool done,
                                        bool hit) {
    if constexpr (!ANY) {
      if (hit) best_inst = k;
    }
    if (!done) return false;
    if (ANY && hit) {
      finish(s, i, true);
      return true;
    }
    if (next(s, i, false)) return false;
    finish(s, i, false);
    return true;
  }
};

// Dynamic shared memory: the stack (stack_len entries of node and mask per
// thread), then, when STAGED, the n_inst x 18 record floats and the n_inst
// roots.  STATS: count into ``stats`` (the default instances take null).
template <int W, bool ANY, bool STAGED, bool STATS>
__global__ void __launch_bounds__(kFetchBlock)
inst_fetch(const Tables tb, const Insts in, const Rays rays, const int n,
           const Outs out, unsigned* __restrict__ work, const int stack_len,
           unsigned long long* __restrict__ stats) {
  extern __shared__ int smem[];
  int* st_node = smem + threadIdx.x;
  unsigned* st_mask =
      reinterpret_cast<unsigned*>(smem + stack_len * kFetchBlock) +
      threadIdx.x;
  const float* aff = in.aff;
  const int* root = in.root;
  if constexpr (STAGED) {
    float* s_aff =
        reinterpret_cast<float*>(smem + 2 * stack_len * kFetchBlock);
    int* s_root = reinterpret_cast<int*>(s_aff + kAff * in.n);
    for (int j = threadIdx.x; j < kAff * in.n; j += kFetchBlock)
      s_aff[j] = __ldg(in.aff + j);
    for (int j = threadIdx.x; j < in.n; j += kFetchBlock)
      s_root[j] = __ldg(in.root + j);
    __syncthreads();
    aff = s_aff;
    root = s_root;
  }
  InstWalk<ANY, STAGED> job{rays, out, aff, root, in.n, -1, -1.0f, 0, 0ull};
  fetch_rays<W, ANY, STATS>(tb, job, n, work, st_node, st_mask, stats);
}

template <int W, bool ANY, bool STAGED, bool STATS>
int launch_fetch(const Tables& tb, const Insts& in, const Rays& rays, int n,
                 const Outs& out, unsigned* work, int stack_len,
                 unsigned long long* stats, cudaStream_t s) {
  if (stack_len < 1 || stack_len > kStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * 4 * stack_len * kFetchBlock + (STAGED ? kRecord * in.n
                                                             : 0);
  const int grid = fetch_grid<inst_fetch<W, ANY, STAGED, STATS>>(n, smem);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidDevice);
  inst_fetch<W, ANY, STAGED, STATS><<<grid, kFetchBlock, smem, s>>>(
      tb, in, rays, n, out, work, stack_len, stats);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- the first design

template <int W>
__global__ void __launch_bounds__(kBlock)
stride_closest(const Tables tb, const Insts in, const Rays rays, const int n,
               const Outs out) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    Closest best;
    int best_inst = 0;
    if (rays.active[i]) {
      Ray w = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz,
                       i);
      const float tmax0 = rays.tmax[i];
      float tmax = tmax0;
      float d = -1.0f;
      int k = -1;
      while ((k = next_inst<false>(in.aff, in.n, w, tmax0, d, k, &d)) >= 0) {
        if (!still_hit<false>(in.aff, k, w, tmax)) continue;
        Closest c;
        walk<W, false>(tb.nb, tb.cm, tb.ni, tb.lt,
                       local_ray<false>(in.aff, k, w), tmax, -1, &c,
                       __ldg(in.root + k));
        if (c.prim >= 0) {
          best = c;
          best_inst = k;
          tmax = c.t;
        }
      }
    }
    store_closest(out, i, best, best_inst);
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
stride_anyhit(const Tables tb, const Insts in, const Rays rays, const int n,
              const Outs out) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    bool o = false;
    if (rays.active[i]) {
      Ray w = load_ray(rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz,
                       i);
      const float tmax = rays.tmax[i];
      float d = -1.0f;
      int k = -1;
      while (!o &&
             (k = next_inst<false>(in.aff, in.n, w, tmax, d, k, &d)) >= 0) {
        if (!still_hit<false>(in.aff, k, w, tmax)) continue;
        o = walk<W, true>(tb.nb, tb.cm, tb.ni, tb.lt,
                          local_ray<false>(in.aff, k, w), tmax,
                          k == 0 ? rays.exclude[i] : -1, nullptr,
                          __ldg(in.root + k));
      }
    }
    out.hit[i] = o ? 1 : 0;
  }
}

template <int W, bool ANY>
int launch_stride(const Tables& tb, const Insts& in, const Rays& rays, int n,
                  const Outs& out, cudaStream_t s) {
  if constexpr (ANY) {
    stride_anyhit<W><<<grid_for(stride_anyhit<W>, n), kBlock, 0, s>>>(
        tb, in, rays, n, out);
  } else {
    stride_closest<W><<<grid_for(stride_closest<W>, n), kBlock, 0, s>>>(
        tb, in, rays, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- entry points

template <int W, bool ANY, bool STATS>
int fetch_staged(bool staged, const Tables& tb, const Insts& in,
                 const Rays& rays, int n, const Outs& out, unsigned* work,
                 int stack_len, unsigned long long* stats, cudaStream_t s) {
  return staged ? launch_fetch<W, ANY, true, STATS>(tb, in, rays, n, out,
                                                    work, stack_len, stats, s)
                : launch_fetch<W, ANY, false, STATS>(tb, in, rays, n, out,
                                                     work, stack_len, stats,
                                                     s);
}

// ``stats`` null: the default instances; else the stats instances.
template <int W, bool ANY>
int launch(bool stride, bool staged, const Tables& tb, const Insts& in,
           const Rays& rays, int n, const Outs& out, unsigned* work,
           int stack_len, unsigned long long* stats, cudaStream_t s) {
  if (stride) return launch_stride<W, ANY>(tb, in, rays, n, out, s);
  return stats != nullptr
             ? fetch_staged<W, ANY, true>(staged, tb, in, rays, n, out, work,
                                          stack_len, stats, s)
             : fetch_staged<W, ANY, false>(staged, tb, in, rays, n, out, work,
                                           stack_len, nullptr, s);
}

template <bool ANY>
int dispatch(int width, bool stride, bool staged, const Tables& tb,
             const Insts& in, const Rays& rays, int n, const Outs& out,
             unsigned* work, int stack_len, void* stream,
             unsigned long long* stats = nullptr) {
  if (n <= 0) return 0;
  if (in.n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8)
    return launch<8, ANY>(stride, staged, tb, in, rays, n, out, work,
                          stack_len, stats, s);
  if (width == 16)
    return launch<16, ANY>(stride, staged, tb, in, rays, n, out, work,
                           stack_len, stats, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ``work``: the persist kernels' work counter for this device and stream
// (two zeroed unsigned words, left zeroed by every launch).
// ``stack_len``: stack entries per ray, 1..64.  ``staged``: copy the
// instance records into shared memory (the wrapper checks that they fit).
extern "C" int rtjax_inst_closest(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active, int n,
    unsigned char* hit, float* t, int* prim, int* inst, float* nx, float* ny,
    float* nz, unsigned* work, int stack_len, int staged, void* stream) {
  return dispatch<false>(width, false, staged != 0, {nb, cm, ni, lt},
                         {root, aff, n_inst},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, inst, nx, ny, nz}, work, stack_len,
                         stream);
}

extern "C" int rtjax_inst_anyhit(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active,
    const int* exclude, int n, unsigned char* occ, unsigned* work,
    int stack_len, int staged, void* stream) {
  return dispatch<true>(width, false, staged != 0, {nb, cm, ni, lt},
                        {root, aff, n_inst},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr},
                        work, stack_len, stream);
}

// The stats instances: as above, plus ``stats``, two zeroed 64-bit words
// to which the launch adds its node visits and leaf rows.
extern "C" int rtjax_inst_closest_stats(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active, int n,
    unsigned char* hit, float* t, int* prim, int* inst, float* nx, float* ny,
    float* nz, unsigned* work, int stack_len, int staged,
    unsigned long long* stats, void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(width, false, staged != 0, {nb, cm, ni, lt},
                         {root, aff, n_inst},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, inst, nx, ny, nz}, work, stack_len,
                         stream, stats);
}

extern "C" int rtjax_inst_anyhit_stats(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active,
    const int* exclude, int n, unsigned char* occ, unsigned* work,
    int stack_len, int staged, unsigned long long* stats, void* stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(width, false, staged != 0, {nb, cm, ni, lt},
                        {root, aff, n_inst},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr},
                        work, stack_len, stream, stats);
}

// The first design, for same-run A/B only (no engine path reaches these).
extern "C" int rtjax_inst_closest_stride(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active, int n,
    unsigned char* hit, float* t, int* prim, int* inst, float* nx, float* ny,
    float* nz, void* stream) {
  return dispatch<false>(width, true, false, {nb, cm, ni, lt},
                         {root, aff, n_inst},
                         {ox, oy, oz, dx, dy, dz, tmax, active, nullptr}, n,
                         {hit, t, prim, inst, nx, ny, nz}, nullptr, 0, stream);
}

extern "C" int rtjax_inst_anyhit_stride(
    int width, const float* nb, const int* cm, const int* ni, const float* lt,
    const int* root, const float* aff, int n_inst, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active,
    const int* exclude, int n, unsigned char* occ, void* stream) {
  return dispatch<true>(width, true, false, {nb, cm, ni, lt},
                        {root, aff, n_inst},
                        {ox, oy, oz, dx, dy, dz, tmax, active, exclude}, n,
                        {occ, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr},
                        nullptr, 0, stream);
}
