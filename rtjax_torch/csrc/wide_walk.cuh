// One ray's walk over the wide-node tables of rtjax_torch/accel/wide.py,
// and the tests it is made of, shared by the persistent walkers
// (persist_traverse.cu) and the two-level kernels (wide_inst_traverse.cu)
// -- the 16-byte loaders below in their fetch design (fetch_walk.cuh),
// walk<> in their stride design -- and the group walks (group_walk.cuh).
//
// Visit order (the plain PyTorch versions in kernels/persist.py walk the
// same one): at a node, slab-test every non-empty child against the
// current tmax; Moeller-Trumbore-test the hit leaf children in ascending
// slot order (each leaf row's slots against the row's entry tmax, the
// closest strictly-smaller hit wins, then tmax shrinks to it); descend
// into the first hit internal child in the node's build-time axis order
// (reversed when the ray points down that axis) and push the rest as one
// (node, remaining-mask) stack entry; pop when nothing was hit.
//
// Exactness: the sources build with --fmad=false, so each product and sum
// rounds like the separate torch ops of the plain versions.  Empty child
// slots are NaN boxes in the tables; fminf/fmaxf would drop the NaN and
// accept them, so empties are skipped by their meta (leaf bit set, count
// 0).

#pragma once

#include <cuda_runtime.h>

namespace rtjax {

constexpr int kStack = 64;
constexpr int kBlock = 128;
constexpr int kPidBase = 96;
constexpr float kBig = 3.4e38f;
constexpr float kEps = 1.1920928955078125e-07f;  // FLT_EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / direction (epsilon-clamped)
  float sx, sy, sz;  // -origin / direction
  unsigned oct;      // bit k set when direction k is negative
};

__device__ __forceinline__ float clamp_dir(float d) {
  return fabsf(d) < kEps ? copysignf(kEps, d) : d;
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = 1.0f / clamp_dir(dx);
  r.iy = 1.0f / clamp_dir(dy);
  r.iz = 1.0f / clamp_dir(dz);
  r.sx = -ox * r.ix;
  r.sy = -oy * r.iy;
  r.sz = -oz * r.iz;
  r.oct = (dx < 0.0f ? 1u : 0u) | (dy < 0.0f ? 2u : 0u) |
          (dz < 0.0f ? 4u : 0u);
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        const float* __restrict__ dx,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ dz, int i) {
  return make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
}

// Next child slot: the lowest set bit, or the highest when reversed.
__device__ __forceinline__ int pick(unsigned mask, unsigned rev) {
  return rev ? 31 - __clz(mask) : __ffs(mask) - 1;
}

// Slab entry and exit of one box (lo, hi), in the plain versions'
// operation order.
__device__ __forceinline__ void slab6(float lx, float ly, float lz, float hx,
                                      float hy, float hz, const Ray& r,
                                      float* entry, float* exit_) {
  float e0 = lx * r.ix + r.sx;
  float e1 = ly * r.iy + r.sy;
  float e2 = lz * r.iz + r.sz;
  float x0 = hx * r.ix + r.sx;
  float x1 = hy * r.iy + r.sy;
  float x2 = hz * r.iz + r.sz;
  *entry = fmaxf(fmaxf(fminf(e0, x0), fminf(e1, x1)), fminf(e2, x2));
  *exit_ = fminf(fminf(fmaxf(e0, x0), fmaxf(e1, x1)), fmaxf(e2, x2));
}

// rtjax's _slab accept rule: max(entry, 0) <= min(exit, tmax).
__device__ __forceinline__ bool slab_accept(float lx, float ly, float lz,
                                            float hx, float hy, float hz,
                                            const Ray& r, float tmax) {
  float entry, exit_;
  slab6(lx, ly, lz, hx, hy, hz, r, &entry, &exit_);
  return fmaxf(entry, 0.0f) <= fminf(exit_, tmax);
}

// Slab entry and exit of one box (lo at b[0..2], hi at b[3..5]).
__device__ __forceinline__ void slab(const float* __restrict__ b,
                                     const Ray& r, float* entry,
                                     float* exit_) {
  slab6(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4),
        __ldg(b + 5), r, entry, exit_);
}

// Slab test of every non-empty child; bit c set when child c is hit:
// max(entry, 0) <= min(exit, tmax), the accept rule of rtjax's _slab.
template <int W>
__device__ __forceinline__ unsigned slab_hits(const float* __restrict__ row,
                                              const int* __restrict__ meta,
                                              unsigned leaf_mask, const Ray& r,
                                              float tmax) {
  unsigned hits = 0u;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (((leaf_mask >> c) & 1u) && (__ldg(meta + c) & 15) == 0) continue;
    const float* b = row + 6 * c;
    if (slab_accept(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
                    __ldg(b + 4), __ldg(b + 5), r, tmax))
      hits |= 1u << c;
  }
  return hits;
}

// Moeller-Trumbore with the reference's exact accept rule, in the plain
// versions' operation order, on one triangle (p0, e1, e2, n = e1 x e2).
// Returns whether the triangle is accepted; t goes to ``t_out``.
__device__ __forceinline__ bool mt_test(float p0x, float p0y, float p0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float nx, float ny, float nz,
                                        const Ray& r, float tmax,
                                        float* t_out) {
  float cx = p0x - r.ox;
  float cy = p0y - r.oy;
  float cz = p0z - r.oz;
  float rx = r.dy * cz - r.dz * cy;
  float ry = r.dz * cx - r.dx * cz;
  float rz = r.dx * cy - r.dy * cx;
  float inv_det = 1.0f / (r.dx * nx + r.dy * ny + r.dz * nz);
  float u = inv_det * (e2x * rx + e2y * ry + e2z * rz);
  float v = inv_det * (e1x * rx + e1y * ry + e1z * rz);
  float t = inv_det * (cx * nx + cy * ny + cz * nz);
  *t_out = t;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= tmax);
}

// One leaf slot (12 floats at q), read with scalar loads.
__device__ __forceinline__ bool mt_slot(const float* __restrict__ q,
                                        const Ray& r, float tmax, float* t_out,
                                        float* nx, float* ny, float* nz) {
  *nx = __ldg(q + 9);
  *ny = __ldg(q + 10);
  *nz = __ldg(q + 11);
  return mt_test(__ldg(q + 0), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3),
                 __ldg(q + 4), __ldg(q + 5), __ldg(q + 6), __ldg(q + 7),
                 __ldg(q + 8), *nx, *ny, *nz, r, tmax, t_out);
}

struct Closest {
  float t = kBig;
  int prim = -1;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
};

// Closest hit in one leaf row: every slot against the row's entry tmax,
// the first strictly closest wins; tmax then shrinks to it.  Slots past
// the leaf's count are all-zero triangles, which reject every ray, so
// they are skipped.  Returns whether it recorded a hit in ``best``.
__device__ __forceinline__ bool leaf_closest(const float* __restrict__ row,
                                             int count, const Ray& r,
                                             float* tmax, Closest* best) {
  float rb_t = kBig, rnx = 0.0f, rny = 0.0f, rnz = 0.0f;
  int rb_s = -1;
  for (int s = 0; s < count; ++s) {
    float t, nx, ny, nz;
    if (mt_slot(row + 12 * s, r, *tmax, &t, &nx, &ny, &nz) && t < rb_t) {
      rb_t = t; rb_s = s; rnx = nx; rny = ny; rnz = nz;
    }
  }
  if (rb_s < 0) return false;
  *tmax = rb_t;
  best->t = rb_t;
  best->prim = __float2int_rn(__ldg(row + kPidBase + rb_s));
  best->nx = rnx; best->ny = rny; best->nz = rnz;
  return true;
}

__device__ __forceinline__ bool leaf_any(const float* __restrict__ row,
                                         int count, const Ray& r, float tmax,
                                         int exclude) {
  for (int s = 0; s < count; ++s) {
    float t, nx, ny, nz;
    if (mt_slot(row + 12 * s, r, tmax, &t, &nx, &ny, &nz) &&
        __float2int_rn(__ldg(row + kPidBase + s)) != exclude)
      return true;
  }
  return false;
}

// The same tests read with 16-byte loads (the fetch kernels of
// persist_traverse.cu and wide_inst_traverse.cu, through fetch_walk.cuh).
// A node row holds child c's box at floats 6c..6c+5, so children 2p and
// 2p+1 are the 16-byte-aligned floats 12p..12p+11: three float4.  A leaf
// slot is 12 floats at 48-byte offsets: three float4.  Rows are 512 bytes
// and the wrappers check that the tables are 16-byte aligned.

// Bit c set when non-empty child c of the node whose row is ``row`` and
// whose metas are ``meta`` (W ints, 16-byte aligned) passes the slab test.
template <int W>
__device__ __forceinline__ unsigned slab_hits_v(const float* __restrict__ row,
                                                const int* __restrict__ meta,
                                                unsigned leaf_mask,
                                                const Ray& r, float tmax) {
  const int4* m = reinterpret_cast<const int4*>(meta);
  unsigned empty = 0u;  // leaf children with count 0 (NaN boxes)
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const int4 v = __ldg(m + k);
    empty |= ((v.x & 15) == 0 ? 1u : 0u) << (4 * k);
    empty |= ((v.y & 15) == 0 ? 1u : 0u) << (4 * k + 1);
    empty |= ((v.z & 15) == 0 ? 1u : 0u) << (4 * k + 2);
    empty |= ((v.w & 15) == 0 ? 1u : 0u) << (4 * k + 3);
  }
  const float4* q = reinterpret_cast<const float4*>(row);
  unsigned hits = 0u;
#pragma unroll
  for (int p = 0; p < W / 2; ++p) {
    const float4 a = __ldg(q + 3 * p);
    const float4 b = __ldg(q + 3 * p + 1);
    const float4 c = __ldg(q + 3 * p + 2);
    if (slab_accept(a.x, a.y, a.z, a.w, b.x, b.y, r, tmax))
      hits |= 1u << (2 * p);
    if (slab_accept(b.z, b.w, c.x, c.y, c.z, c.w, r, tmax))
      hits |= 2u << (2 * p);
  }
  return hits & ~(empty & leaf_mask);
}

// leaf_closest / leaf_any over 16-byte loads, K slots at a time: the
// loads of K slots are issued together (K divides 8, so a chunk never
// leaves the row's 96 triangle floats), then the slots are tested in
// ascending order.
template <int K>
__device__ __forceinline__ void load_slots(const float* __restrict__ row,
                                           int s0, float4* v) {
  const float4* q = reinterpret_cast<const float4*>(row) + 3 * s0;
#pragma unroll
  for (int j = 0; j < 3 * K; ++j) v[j] = __ldg(q + j);
}

__device__ __forceinline__ bool mt_slot4(const float4* v, const Ray& r,
                                         float tmax, float* t_out) {
  return mt_test(v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z,
                 v[1].w, v[2].x, v[2].y, v[2].z, v[2].w, r, tmax, t_out);
}

template <int K>
__device__ __forceinline__ bool leaf_closest_v(const float* __restrict__ row,
                                               int count, const Ray& r,
                                               float* tmax, Closest* best) {
  float rb_t = kBig, rnx = 0.0f, rny = 0.0f, rnz = 0.0f;
  int rb_s = -1;
  for (int s0 = 0; s0 < count; s0 += K) {
    float4 v[3 * K];
    load_slots<K>(row, s0, v);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float t;
      if (s0 + j < count && mt_slot4(v + 3 * j, r, *tmax, &t) && t < rb_t) {
        rb_t = t; rb_s = s0 + j;
        rnx = v[3 * j + 2].y; rny = v[3 * j + 2].z; rnz = v[3 * j + 2].w;
      }
    }
  }
  if (rb_s < 0) return false;
  *tmax = rb_t;
  best->t = rb_t;
  best->prim = __float2int_rn(__ldg(row + kPidBase + rb_s));
  best->nx = rnx; best->ny = rny; best->nz = rnz;
  return true;
}

template <int K>
__device__ __forceinline__ bool leaf_any_v(const float* __restrict__ row,
                                           int count, const Ray& r,
                                           float tmax, int exclude) {
  for (int s0 = 0; s0 < count; s0 += K) {
    float4 v[3 * K];
    load_slots<K>(row, s0, v);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float t;
      if (s0 + j < count && mt_slot4(v + 3 * j, r, tmax, &t) &&
          __float2int_rn(__ldg(row + kPidBase + s0 + j)) != exclude)
        return true;
    }
  }
  return false;
}

// One ray's walk from node ``root``.  Closest hit (ANY false): a hit
// overwrites ``best``, whose t never exceeds the ``tmax`` passed in.  Any
// hit: stops at the first accepted hit whose prim is not ``exclude``
// (returns true).
template <int W, bool ANY>
__device__ __forceinline__ bool walk(const float* __restrict__ nb,
                                     const int* __restrict__ cm,
                                     const int* __restrict__ ni,
                                     const float* __restrict__ lt,
                                     const Ray& r, float tmax, int exclude,
                                     Closest* best, int root) {
  constexpr unsigned kAll = (1u << W) - 1u;
  int stack_node[kStack];
  unsigned stack_mask[kStack];  // (remaining mask << 1) | reversed
  int sp = 0;
  int cur = root;
  while (true) {
    if (cur < 0) {
      if (sp == 0) return false;
      int pnode = stack_node[sp - 1];
      unsigned pm = stack_mask[sp - 1];
      unsigned m = pm >> 1, rev = pm & 1u;
      int first = pick(m, rev);
      unsigned rest = m & ~(1u << first);
      if (rest == 0u) --sp; else stack_mask[sp - 1] = (rest << 1) | rev;
      cur = __ldg(cm + pnode * W + first) >> 4;
    }
    const float* row = nb + (size_t)cur * 128;
    const int* meta = cm + (size_t)cur * W;
    int info = __ldg(ni + cur);
    unsigned lm = (unsigned)info & kAll;
    int axis = (info >> W) & 3;
    unsigned hits = slab_hits<W>(row, meta, lm, r, tmax);
    unsigned leaves = hits & lm;
    while (leaves) {
      int c = __ffs(leaves) - 1;
      leaves &= leaves - 1u;
      int mc = __ldg(meta + c);
      const float* lrow = lt + (size_t)(mc >> 4) * 128;
      if constexpr (ANY) {
        if (leaf_any(lrow, mc & 15, r, tmax, exclude)) return true;
      } else {
        leaf_closest(lrow, mc & 15, r, &tmax, best);
      }
    }
    unsigned inner = hits & ~lm & kAll;
    if (inner) {
      unsigned rev = (r.oct >> axis) & 1u;
      int first = pick(inner, rev);
      unsigned rest = inner & ~(1u << first);
      if (rest) {
        stack_node[sp] = cur;
        stack_mask[sp] = (rest << 1) | rev;
        ++sp;
      }
      cur = __ldg(meta + first) >> 4;
    } else {
      cur = -1;
    }
  }
}

// Persistent grid: as many blocks as the card keeps resident, capped by
// the number of rays.
template <typename K>
int grid_for(K kernel, int n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  int resident = sms * (per_sm > 0 ? per_sm : 1);
  int needed = (n + kBlock - 1) / kBlock;
  return needed < resident ? needed : resident;
}

}  // namespace rtjax
