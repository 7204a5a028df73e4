// Binary-BVH traversal for Hopper (sm_90a): closest hit and any hit over
// the flattened binary BVH (rtjax_torch/accel/bvh.py BvhArrays) and the
// leaf-order triangles (core/geometry.py Triangles) as the scene holds
// them on the device.
//
// Replaces: rtjax/kernels/traversal.py, traverse_closest and
// traverse_anyhit -- not Pallas kernels but a vmap-ped lax.while_loop that
// XLA fuses into one device loop.  In PyTorch that loop would be a Python
// loop of some twenty tensor ops per node-pair step, for as many steps as
// the batch's longest walk; here it is one thread per ray with a private
// stack, the reference's own walk (bvh.cuh:221-357).
//
// What bounds it on this card.  Counted from the rays (chip_smoke.py
// prints it per launch): each ray's inputs read once and its results
// written once, and once each the node pairs (two boxes and the two
// children's left_first and num_prims words, 64 bytes) and triangles (48
// bytes) the walk reads, over 3.35 TB/s; against two slab tests a
// node-pair step and one Moeller-Trumbore test a triangle over 67 TFLOP/s.
// The walk re-reads the upper levels of the tree for every ray, and its
// slab test does not clip to [0, tmax], so a ray visits every box it
// crosses, near a hit or behind it.
//
// What the design does about it: nothing yet -- a plain, correct kernel
// (one ray per thread, scalar read-only loads, the stack in shared
// memory), kept for rtjax's traversal="xla" and for scenes without wide
// tables.  Its times stand in PERF.md beside the persist kernels'.
//
// The stack: ``stack_len`` entries per thread in dynamic shared memory,
// entry-major (entry k of thread j at k * kBlock + j), sized by the
// wrapper from the tree (max(stack_size, max_depth + 1); at most
// kMaxStack).  A push that finds the stack full traps: the launch fails,
// and no push is ever dropped.
//
// The stats instances (STATS = true) count, per lane, rtjax's node-pair
// steps and leaf visits, sum them over the warp and add the sums, in 64
// bits, to a two-word buffer that the wrapper zeroes.  The results are
// the default instances' bit for bit.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain versions
// (kernels/traversal.py), which walk each ray in the same order; results
// agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 232448 / (4 * kBlock);
constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON
constexpr unsigned kWarp = 0xffffffffu;

struct Bvh {
  const float* bmin;  // [M, 3]
  const float* bmax;  // [M, 3]
  const int* left_first;
  const int* num_prims;
};

struct Tris {
  const float* p0;  // [P, 3] each
  const float* e1;
  const float* e2;
  const float* n;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* tmax;
  const unsigned char* active;
  const int* exclude;  // any hit only
};

struct Outs {
  unsigned char* hit;  // any hit: occluded
  float *t, *u, *v;
  int* prim;
  float *nx, *ny, *nz;
};

// A ray and its slab-test state (core/geometry.py ray_slab_precompute).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / direction, clamped away from zero
  float sx, sy, sz;  // -origin * (1 / direction)
  bool nx, ny, nz;   // direction component < 0
};

__device__ __forceinline__ float clamp_dir(float d) {
  return fabsf(d) < kEps ? copysignf(kEps, d) : d;
}

__device__ __forceinline__ Ray load_ray(const Rays& rays, int i) {
  Ray r;
  r.ox = rays.ox[i]; r.oy = rays.oy[i]; r.oz = rays.oz[i];
  r.dx = rays.dx[i]; r.dy = rays.dy[i]; r.dz = rays.dz[i];
  r.ix = 1.0f / clamp_dir(r.dx);
  r.iy = 1.0f / clamp_dir(r.dy);
  r.iz = 1.0f / clamp_dir(r.dz);
  r.sx = -r.ox * r.ix;
  r.sy = -r.oy * r.iy;
  r.sz = -r.oz * r.iz;
  r.nx = r.dx < 0.0f;
  r.ny = r.dy < 0.0f;
  r.nz = r.dz < 0.0f;
  return r;
}

__device__ __forceinline__ float max2(float a, float b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float min2(float a, float b) {
  return a < b ? a : b;
}

// Slab test of node ``node``'s box on the infinite ray (core/geometry.py
// intersect_aabb, in its operation order): whether it is hit, and the
// entry distance.
__device__ __forceinline__ bool slab(const Bvh& b, int node, const Ray& r,
                                     float* entry) {
  const float* lo = b.bmin + 3 * node;
  const float* hi = b.bmax + 3 * node;
  const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
  const float hx = __ldg(hi), hy = __ldg(hi + 1), hz = __ldg(hi + 2);
  const float ex = r.ix * (r.nx ? hx : lx) + r.sx;
  const float ey = r.iy * (r.ny ? hy : ly) + r.sy;
  const float ez = r.iz * (r.nz ? hz : lz) + r.sz;
  const float xx = r.ix * (r.nx ? lx : hx) + r.sx;
  const float xy = r.iy * (r.ny ? ly : hy) + r.sy;
  const float xz = r.iz * (r.nz ? lz : hz) + r.sz;
  const float en = max2(max2(ex, ey), ez);
  const float xt = min2(min2(xx, xy), xz);
  *entry = en;
  return en <= xt;
}

// Moeller-Trumbore with the reference's accept rule, in
// core/geometry.py intersect_triangle_v3's operation order.
__device__ __forceinline__ bool mt(const Tris& tr, int ti, const Ray& r,
                                   float tmax, float* t_out, float* u_out,
                                   float* v_out) {
  const float* p0 = tr.p0 + 3 * ti;
  const float* e1 = tr.e1 + 3 * ti;
  const float* e2 = tr.e2 + 3 * ti;
  const float* n = tr.n + 3 * ti;
  const float cx = __ldg(p0) - r.ox;
  const float cy = __ldg(p0 + 1) - r.oy;
  const float cz = __ldg(p0 + 2) - r.oz;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float nx = __ldg(n), ny = __ldg(n + 1), nz = __ldg(n + 2);
  const float inv_det = 1.0f / (r.dx * nx + r.dy * ny + r.dz * nz);
  const float u = inv_det * (__ldg(e2) * rx + __ldg(e2 + 1) * ry +
                             __ldg(e2 + 2) * rz);
  const float v = inv_det * (__ldg(e1) * rx + __ldg(e1 + 1) * ry +
                             __ldg(e1 + 2) * rz);
  const float t = inv_det * (cx * nx + cy * ny + cz * nz);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= tmax);
}

// The closest-hit state of one ray.
struct Best {
  float tmax, t, u, v;
  int prim;
};

// One leaf, closest hit: every triangle in leaf order, tmax shrinking on
// each hit (of equal t the later triangle wins).
__device__ __forceinline__ void leaf_closest(const Tris& tr, int first,
                                             int count, const Ray& r,
                                             Best* b) {
  for (int k = 0; k < count; ++k) {
    float t, u, v;
    if (mt(tr, first + k, r, b->tmax, &t, &u, &v)) {
      b->tmax = t;
      b->t = t;
      b->u = u;
      b->v = v;
      b->prim = first + k;
    }
  }
}

// One leaf, any hit: stops at the first triangle that is not ``exclude``.
__device__ __forceinline__ bool leaf_anyhit(const Tris& tr, int first,
                                            int count, const Ray& r,
                                            float tmax, int exclude) {
  for (int k = 0; k < count; ++k) {
    float t, u, v;
    if (mt(tr, first + k, r, tmax, &t, &u, &v) && first + k != exclude)
      return true;
  }
  return false;
}

// The sum over the warp of a 32-bit count, exact in 64 bits: the two
// 16-bit halves are summed apart (each sum < 2^21).
__device__ __forceinline__ unsigned long long warp_sum64(unsigned c) {
  const unsigned lo = __reduce_add_sync(kWarp, c & 0xffffu);
  const unsigned hi = __reduce_add_sync(kWarp, c >> 16);
  return ((unsigned long long)hi << 16) + lo;
}

// One ray's walk from the root.  ANY: stop at the first occluding hit.
// Returns whether an any-hit ray is occluded; the closest hit goes to
// ``best``.  ``steps`` / ``leaves`` count rtjax's node-pair steps and leaf
// visits.
template <bool ANY>
__device__ __forceinline__ bool walk(const Bvh& bv, const Tris& tr,
                                     const Ray& r, float tmax, int exclude,
                                     Best* best, int* st, int stack_len,
                                     unsigned* steps, unsigned* leaves) {
  int cur = __ldg(bv.left_first);
  int sp = 0;
  while (true) {
    const int l = cur, rn = cur + 1;
    float e_l, e_r;
    const bool ok_l = slab(bv, l, r, &e_l);
    const bool ok_r = slab(bv, rn, r, &e_r);
    const int np_l = __ldg(bv.num_prims + l);
    const int np_r = __ldg(bv.num_prims + rn);
    const int c_l = __ldg(bv.left_first + l);
    const int c_r = __ldg(bv.left_first + rn);
    const bool leaf_l = ok_l && np_l > 0, leaf_r = ok_r && np_r > 0;
    *steps += 1u;
    *leaves += (leaf_l ? 1u : 0u) + (leaf_r ? 1u : 0u);
    if constexpr (ANY) {
      if (leaf_l && leaf_anyhit(tr, c_l, np_l, r, tmax, exclude)) return true;
      if (leaf_r && leaf_anyhit(tr, c_r, np_r, r, tmax, exclude)) return true;
    } else {
      if (leaf_l) leaf_closest(tr, c_l, np_l, r, best);
      if (leaf_r) leaf_closest(tr, c_r, np_r, r, best);
    }
    const bool live_l = ok_l && np_l == 0, live_r = ok_r && np_r == 0;
    if (live_l && live_r) {
      const bool l_far = e_l > e_r;
      if (sp >= stack_len) __trap();  // never drop a push
      st[sp * kBlock] = l_far ? c_l : c_r;
      ++sp;
      cur = l_far ? c_r : c_l;
    } else if (live_l) {
      cur = c_l;
    } else if (live_r) {
      cur = c_r;
    } else if (sp > 0) {
      --sp;
      cur = st[sp * kBlock];
    } else {
      return false;
    }
  }
}

template <bool STATS>
__global__ void __launch_bounds__(kBlock)
closest_kernel(const Bvh bv, const Tris tr, const Rays rays, const int n,
               const Outs out, const int stack_len,
               unsigned long long* __restrict__ stats) {
  extern __shared__ int stack[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  unsigned steps = 0u, leaves = 0u;
  if (i < n) {
    Best b{0.0f, __int_as_float(0x7f800000), 0.0f, 0.0f, -1};
    if (rays.active[i]) {
      const Ray r = load_ray(rays, i);
      b.tmax = rays.tmax[i];
      walk<false>(bv, tr, r, b.tmax, -1, &b, stack + threadIdx.x, stack_len,
                  &steps, &leaves);
    }
    const bool hit = b.prim >= 0;
    out.hit[i] = hit ? 1 : 0;
    out.t[i] = b.t;
    out.u[i] = b.u;
    out.v[i] = b.v;
    out.prim[i] = b.prim;
    out.nx[i] = hit ? __ldg(tr.n + 3 * b.prim) : 0.0f;
    out.ny[i] = hit ? __ldg(tr.n + 3 * b.prim + 1) : 0.0f;
    out.nz[i] = hit ? __ldg(tr.n + 3 * b.prim + 2) : 0.0f;
  }
  if constexpr (STATS) {
    const unsigned long long s = warp_sum64(steps);
    const unsigned long long l = warp_sum64(leaves);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, s);
      atomicAdd(stats + 1, l);
    }
  }
}

template <bool STATS>
__global__ void __launch_bounds__(kBlock)
anyhit_kernel(const Bvh bv, const Tris tr, const Rays rays, const int n,
              unsigned char* __restrict__ occ, const int stack_len,
              unsigned long long* __restrict__ stats) {
  extern __shared__ int stack[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  unsigned steps = 0u, leaves = 0u;
  if (i < n) {
    bool o = false;
    if (rays.active[i]) {
      const Ray r = load_ray(rays, i);
      o = walk<true>(bv, tr, r, rays.tmax[i], rays.exclude[i], nullptr,
                     stack + threadIdx.x, stack_len, &steps, &leaves);
    }
    occ[i] = o ? 1 : 0;
  }
  if constexpr (STATS) {
    const unsigned long long s = warp_sum64(steps);
    const unsigned long long l = warp_sum64(leaves);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, s);
      atomicAdd(stats + 1, l);
    }
  }
}

// Launch ``kernel`` over ``n`` rays with ``stack_len`` entries of stack a
// thread; the launch's error code (0 when queued).
template <typename K, typename... Args>
int launch(K kernel, int n, int stack_len, cudaStream_t s, Args... args) {
  if (n <= 0) return 0;
  if (stack_len < 1 || stack_len > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * stack_len * kBlock;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``stack_len``: stack entries per ray, 1..kMaxStack.  ``stats``: null for
// the default instance, else two zeroed 64-bit words to which the launch
// adds its node-pair steps and leaf visits (the stats instance).
extern "C" int rtjax_binary_closest(
    const float* bmin, const float* bmax, const int* left_first,
    const int* num_prims, const float* p0, const float* e1, const float* e2,
    const float* nrm, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    float* u, float* v, int* prim, float* nx, float* ny, float* nz,
    int stack_len, unsigned long long* stats, void* stream) {
  const Bvh bv{bmin, bmax, left_first, num_prims};
  const Tris tr{p0, e1, e2, nrm};
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, nullptr};
  const Outs out{hit, t, u, v, prim, nx, ny, nz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch(closest_kernel<true>, n, stack_len, s, bv, tr, rays, n, out,
                  stack_len, stats);
  return launch(closest_kernel<false>, n, stack_len, s, bv, tr, rays, n, out,
                stack_len, stats);
}

extern "C" int rtjax_binary_anyhit(
    const float* bmin, const float* bmax, const int* left_first,
    const int* num_prims, const float* p0, const float* e1, const float* e2,
    const float* nrm, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, int stack_len, unsigned long long* stats,
    void* stream) {
  const Bvh bv{bmin, bmax, left_first, num_prims};
  const Tris tr{p0, e1, e2, nrm};
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, exclude};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch(anyhit_kernel<true>, n, stack_len, s, bv, tr, rays, n, occ,
                  stack_len, stats);
  return launch(anyhit_kernel<false>, n, stack_len, s, bv, tr, rays, n, occ,
                stack_len, stats);
}
