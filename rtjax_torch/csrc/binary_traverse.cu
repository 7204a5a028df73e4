// Binary-BVH traversal for Hopper (sm_90a): closest hit and any hit over
// the flattened binary BVH (rtjax_torch/accel/bvh.py BvhArrays) and the
// leaf-order triangles (core/geometry.py Triangles) as the scene holds
// them on the device.
//
// Replaces: rtjax/kernels/traversal.py, traverse_closest and
// traverse_anyhit -- not Pallas kernels but a vmap-ped lax.while_loop that
// XLA fuses into one device loop.  In PyTorch that loop would be a Python
// loop of some twenty tensor ops per node-pair step, for as many steps as
// the batch's longest walk; here each ray is walked by one thread with a
// private stack, the reference's own walk (bvh.cuh:221-357).
//
// What bounds it on this card.  Counted from the rays (chip_smoke.py
// prints it per launch): each ray's inputs read once and its results
// written once, and once each the node pairs (two boxes and the two
// children's words, 64 bytes) and triangles (48 bytes) the walk reads,
// over 3.35 TB/s; against two slab tests a node-pair step and one
// Moeller-Trumbore test a triangle over 67 TFLOP/s.  The walk re-reads the
// upper levels of the tree for every ray, and its slab test does not clip
// to [0, tmax], so a ray visits every box it crosses, near a hit or behind
// it.  Its loads form one dependent chain a ray, and a warp's lanes part
// ways: some test a leaf's triangles while the rest wait.
//
// What the design does about it (the fetch kernels, the default; each
// part timed against its undoing by tools/binary_variants.py):
// - a node-pair record: children (c, c + 1) are adjacent, so one 64-byte
//   record holds both boxes and both children's words, read as four
//   128-bit read-only loads where the first design made 16 scalar loads
//   from four arrays (four cache lines, each waiting on the last);
//   records are numbered by pair and an internal child's word is its
//   children's pair, so the walk needs no map (kernels/traversal.py
//   BinaryRecords, built once per BVH on the device);
// - a triangle record: p0, e1, e2, n in 48 bytes, three 128-bit loads
//   where the first design made 12 scalar ones;
// - persistent blocks with refill (Aila & Laine's dynamic fetch, as
//   csrc/fetch_walk.cuh): a grid of the card's resident blocks, each warp
//   drawing rays from a per-stream work counter with one atomicAdd for
//   its empty lanes once kRefill of them are empty, so a long walk holds
//   one lane, not the warp; the last block resets the counter, so a
//   launch costs no memset and a CUDA-graph replay finds it zeroed;
// - leaf phases (Aila & Laine's while-while): a step records its hit
//   leaves, and the warp tests its lanes' recorded leaves together once
//   three quarters of its live lanes have some, instead of each step's
//   few leaf-holding lanes testing while the rest of the warp waits;
// - record and row addresses in 64 bits (a scene past 2^24 triangles
//   takes this walk, with more than 2^25 nodes).
// The visit order is the first design's exactly, so results and counts
// are the same bit for bit.  The first design (one thread a ray over a
// grid of ceil(n / kBlock) blocks, scalar loads from BvhArrays; the
// ``_thread`` entry points) stays for a same-call A/B.
//
// The stack: ``stack_len`` entries per thread slot in dynamic shared
// memory, entry-major (entry k of slot j at k * kBlock + j), sized by the
// wrapper from the tree (max(stack_size, max_depth + 1); at most
// kMaxStack).  A push that finds the stack full traps: the launch fails,
// and no push is ever dropped.  A slot refilled with a new ray starts from
// an empty stack.
//
// The stats instances (STATS = true) count, per lane, rtjax's node-pair
// steps and leaf visits, sum them over the warp and add the sums, in 64
// bits, to a two-word buffer that the wrapper zeroes.  A lane's counts
// outlive its rays, so a refill neither drops nor doubles one.  The
// results are the default instances' bit for bit.
//
// Exactness: the build uses --fmad=false, so each product and sum rounds
// like the separate torch ops of the plain versions
// (kernels/traversal.py), which walk each ray in the same order; results
// agree bit for bit.

#include <cuda_runtime.h>

#include "fetch_walk.cuh"

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

// ------------------------------------------------ the fetch design

// How many of a warp's lanes must be empty before it draws rays (16: 1.05-
// 1.08x faster than drawing for every empty lane, tools/binary_variants.py).
constexpr int kRefill = 16;

// Slab test of one child box held in registers, in slab()'s order.
__device__ __forceinline__ bool slab_v(float lx, float ly, float lz, float hx,
                                       float hy, float hz, const Ray& r,
                                       float* entry) {
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

// Moeller-Trumbore of triangle record ``ti`` (p0, e1, e2, n: three float4),
// in mt()'s order.
__device__ __forceinline__ bool mt_v(const float4* __restrict__ tris,
                                     long long ti, const Ray& r, float tmax,
                                     float* t_out, float* u_out,
                                     float* v_out) {
  const float4* q = tris + ti * 3;
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  const float cx = a.x - r.ox;
  const float cy = a.y - r.oy;
  const float cz = a.z - r.oz;
  const float rx = r.dy * cz - r.dz * cy;
  const float ry = r.dz * cx - r.dx * cz;
  const float rz = r.dx * cy - r.dy * cx;
  const float inv_det = 1.0f / (r.dx * c.y + r.dy * c.z + r.dz * c.w);
  const float u = inv_det * (b.z * rx + b.w * ry + c.x * rz);
  const float v = inv_det * (a.w * rx + b.x * ry + b.y * rz);
  const float t = inv_det * (cx * c.y + cy * c.z + cz * c.w);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= tmax);
}

// One lane's ray and where its walk stands.
struct Slot {
  Ray r;
  Best b;       // closest hit; b.tmax is an any-hit ray's tmax too
  int exclude;  // any hit only
  int cur;      // the node pair to visit next
  int sp;       // stack depth
};

// The hit leaves a lane's last node-pair step recorded, in test order (the
// left one first): ``n0`` / ``n1`` triangles from ``f0`` / ``f1`` (0: none);
// ``last``: that step ended the walk.
struct Pending {
  int f0, n0, f1, n1;
  bool last;
};

// One leaf's triangles in leaf order, closest hit (tmax shrinking on each
// hit; of equal t the later triangle wins) or any hit (true at the first
// triangle that is not ``exclude``).
template <bool ANY>
__device__ __forceinline__ bool leaf_tests(const float4* __restrict__ tris,
                                           Slot& s, int first, int count) {
  for (int k = 0; k < count; ++k) {
    float t, u, v;
    if (!mt_v(tris, (long long)first + k, s.r, s.b.tmax, &t, &u, &v))
      continue;
    if constexpr (ANY) {
      if (first + k != s.exclude) return true;
    } else {
      s.b.tmax = t;
      s.b.t = t;
      s.b.u = u;
      s.b.v = v;
      s.b.prim = first + k;
    }
  }
  return false;
}

// One node-pair step of a lane's walk, in walk()'s order but for its
// leaves, which it records in ``p`` for the leaf phase: both children's slab
// tests, then descend, push or pop.  Returns true when nothing is left to
// visit.
__device__ __forceinline__ bool pair_visit(const float4* __restrict__ pairs,
                                           Slot& s, int* st, int stack_len,
                                           Pending& p, unsigned* steps,
                                           unsigned* leaves) {
  const float4* q = pairs + (long long)s.cur * 4;
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
  const int4 w = __ldg(reinterpret_cast<const int4*>(q + 3));
  float e_l, e_r;
  const bool ok_l = slab_v(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, s.r, &e_l);
  const bool ok_r = slab_v(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, s.r, &e_r);
  const int c_l = w.x, np_l = w.y, c_r = w.z, np_r = w.w;
  const bool leaf_l = ok_l && np_l > 0, leaf_r = ok_r && np_r > 0;
  *steps += 1u;
  *leaves += (leaf_l ? 1u : 0u) + (leaf_r ? 1u : 0u);
  p.n0 = 0;
  p.n1 = 0;
  if (leaf_l) { p.f0 = c_l; p.n0 = np_l; }
  if (leaf_r) {
    if (p.n0) { p.f1 = c_r; p.n1 = np_r; } else { p.f0 = c_r; p.n0 = np_r; }
  }
  const bool live_l = ok_l && np_l == 0, live_r = ok_r && np_r == 0;
  if (live_l && live_r) {
    const bool l_far = e_l > e_r;
    if (s.sp >= stack_len) __trap();  // never drop a push
    st[s.sp * kBlock] = l_far ? c_l : c_r;
    ++s.sp;
    s.cur = l_far ? c_r : c_l;
  } else if (live_l) {
    s.cur = c_l;
  } else if (live_r) {
    s.cur = c_r;
  } else if (s.sp > 0) {
    --s.sp;
    s.cur = st[s.sp * kBlock];
  } else {
    return true;
  }
  return false;
}

// The closest-hit results of ray i (inactive: hit 0, t inf, u = v = 0,
// prim -1, normal 0).
__device__ __forceinline__ void put_closest(const Outs& out,
                                            const float4* __restrict__ tris,
                                            int i, const Best& b) {
  const bool hit = b.prim >= 0;
  float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (hit) c = __ldg(tris + (long long)b.prim * 3 + 2);
  out.hit[i] = hit ? 1 : 0;
  out.t[i] = b.t;
  out.u[i] = b.u;
  out.v[i] = b.v;
  out.prim[i] = b.prim;
  out.nx[i] = c.y;
  out.ny[i] = c.z;
  out.nz[i] = c.w;
}

// The fetch kernel: every thread slot walks rays drawn from ``work`` until
// the counter is spent, then the last block to finish resets it.  ANY:
// occlusion into ``occ``, else the closest hit into ``out``.
template <bool ANY, bool STATS>
__global__ void __launch_bounds__(kBlock)
fetch_kernel(const float4* __restrict__ pairs,
             const float4* __restrict__ tris, const int root, const Rays rays,
             const int n, const Outs out, unsigned char* __restrict__ occ,
             const int stack_len, unsigned* __restrict__ work,
             unsigned long long* __restrict__ stats) {
  extern __shared__ int stack[];
  int* st = stack + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  const Best none{0.0f, __int_as_float(0x7f800000), 0.0f, 0.0f, -1};
  unsigned steps = 0u, leaves = 0u;
  bool more = true;  // warp-uniform: the counter may still hold rays
  int ray = -1;      // this lane's ray; -1 when it has none
  Slot s;
  Pending p{0, 0, 0, 0, false};
  while (true) {
    // refill: the empty lanes draw consecutive rays with one atomicAdd; an
    // inactive ray is written out at once and its lane draws again
    while (more) {
      const unsigned want = __ballot_sync(kWarp, ray < 0);
      if (__popc(want) < kRefill) break;
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
            s.r = load_ray(rays, (int)i);
            s.b = none;
            s.b.tmax = rays.tmax[i];
            if constexpr (ANY) s.exclude = rays.exclude[i];
            s.cur = root;
            s.sp = 0;
            p.n0 = 0;
            p.n1 = 0;
            p.last = false;
            ray = (int)i;
          } else if constexpr (ANY) {
            occ[i] = 0;
          } else {
            put_closest(out, tris, (int)i, none);
          }
        }
      }
    }
    if (__ballot_sync(kWarp, ray >= 0) == 0u) break;
    // a lane whose step recorded hit leaves waits for the warp's leaf
    // phase, which comes once three quarters of the live lanes wait; the
    // other lanes step meanwhile.  Each lane still steps and tests in
    // walk()'s order, so results and counts are the first design's.
    const bool live = ray >= 0;
    const bool waiting = live && p.n0 > 0;
    const int n_live = __popc(__ballot_sync(kWarp, live));
    const int n_wait = __popc(__ballot_sync(kWarp, waiting));
    if (4 * n_wait >= 3 * n_live) {
      if (waiting) {
        bool hit = leaf_tests<ANY>(tris, s, p.f0, p.n0);
        if (!(ANY && hit) && p.n1) hit = leaf_tests<ANY>(tris, s, p.f1, p.n1);
        p.n0 = 0;
        p.n1 = 0;
        if ((ANY && hit) || p.last) {
          if constexpr (ANY) occ[ray] = hit ? 1 : 0;
          else put_closest(out, tris, ray, s.b);
          ray = -1;
        }
      }
    } else if (live && !waiting) {
      if (pair_visit(pairs, s, st, stack_len, p, &steps, &leaves)) {
        if (p.n0 == 0) {
          if constexpr (ANY) occ[ray] = 0;
          else put_closest(out, tris, ray, s.b);
          ray = -1;
        } else {
          p.last = true;
        }
      }
    }
  }
  // the loop ends on a warp vote, so every lane of the warp is here
  if constexpr (STATS) {
    const unsigned long long a = warp_sum64(steps);
    const unsigned long long b = warp_sum64(leaves);
    if (lane == 0u) {
      atomicAdd(stats, a);
      atomicAdd(stats + 1, b);
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

// Launch a fetch kernel over ``n`` rays on the card's resident grid; the
// launch's error code (0 when queued).
template <bool ANY, bool STATS>
int launch_fetch(const float4* pairs, const float4* tris, int root,
                 const Rays& rays, int n, const Outs& out,
                 unsigned char* occ, int stack_len, unsigned* work,
                 unsigned long long* stats, cudaStream_t s) {
  if (n <= 0) return 0;
  if (stack_len < 1 || stack_len > kMaxStack)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * stack_len * kBlock;
  const int grid = rtjax::fetch_grid<fetch_kernel<ANY, STATS>>(n, smem,
                                                                kBlock);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  fetch_kernel<ANY, STATS><<<grid, kBlock, smem, s>>>(
      pairs, tris, root, rays, n, out, occ, stack_len, work, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first design's entry points (one thread a ray, BvhArrays and the
// Triangles arrays as they are).  ``stack_len``: stack entries per ray,
// 1..kMaxStack.  ``stats``: null for the default instance, else two
// zeroed 64-bit words to which the launch adds its node-pair steps and
// leaf visits (the stats instance).
extern "C" int rtjax_binary_closest_thread(
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

extern "C" int rtjax_binary_anyhit_thread(
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

// The fetch design's entry points.  ``pairs``: the node-pair records
// ([P, 4] float4), ``tris``: the triangle records ([T, 3] float4), both
// 16-byte aligned; ``root``: the root's children's pair.  ``work``: the
// stream's work counter (two zeroed words, left zeroed).  ``stack_len``
// and ``stats`` as for the first design.
extern "C" int rtjax_binary_closest(
    const void* pairs, const void* tris, int root, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active, int n,
    unsigned char* hit, float* t, float* u, float* v, int* prim, float* nx,
    float* ny, float* nz, int stack_len, unsigned* work,
    unsigned long long* stats, void* stream) {
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, nullptr};
  const Outs out{hit, t, u, v, prim, nx, ny, nz};
  const auto* pr = static_cast<const float4*>(pairs);
  const auto* tr = static_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch_fetch<false, true>(pr, tr, root, rays, n, out, nullptr,
                                     stack_len, work, stats, s);
  return launch_fetch<false, false>(pr, tr, root, rays, n, out, nullptr,
                                    stack_len, work, stats, s);
}

extern "C" int rtjax_binary_anyhit(
    const void* pairs, const void* tris, int root, const float* ox,
    const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmax, const unsigned char* active,
    const int* exclude, int n, unsigned char* occ, int stack_len,
    unsigned* work, unsigned long long* stats, void* stream) {
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, exclude};
  const Outs out{};
  const auto* pr = static_cast<const float4*>(pairs);
  const auto* tr = static_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats != nullptr)
    return launch_fetch<true, true>(pr, tr, root, rays, n, out, occ,
                                    stack_len, work, stats, s);
  return launch_fetch<true, false>(pr, tr, root, rays, n, out, occ,
                                   stack_len, work, stats, s);
}
