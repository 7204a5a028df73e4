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
// which walk the same order; results agree bit for bit.  Empty child slots
// are NaN boxes in the tables; fminf/fmaxf would drop the NaN and accept
// them, so empties are skipped by their meta (leaf bit set, count 0).

#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        const float* __restrict__ dx,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ dz, int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = 1.0f / clamp_dir(r.dx);
  r.iy = 1.0f / clamp_dir(r.dy);
  r.iz = 1.0f / clamp_dir(r.dz);
  r.sx = -r.ox * r.ix;
  r.sy = -r.oy * r.iy;
  r.sz = -r.oz * r.iz;
  r.oct = (r.dx < 0.0f ? 1u : 0u) | (r.dy < 0.0f ? 2u : 0u) |
          (r.dz < 0.0f ? 4u : 0u);
  return r;
}

// Next child slot: the lowest set bit, or the highest when reversed.
__device__ __forceinline__ int pick(unsigned mask, unsigned rev) {
  return rev ? 31 - __clz(mask) : __ffs(mask) - 1;
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
    float e0 = __ldg(b + 0) * r.ix + r.sx;
    float e1 = __ldg(b + 1) * r.iy + r.sy;
    float e2 = __ldg(b + 2) * r.iz + r.sz;
    float x0 = __ldg(b + 3) * r.ix + r.sx;
    float x1 = __ldg(b + 4) * r.iy + r.sy;
    float x2 = __ldg(b + 5) * r.iz + r.sz;
    float entry = fmaxf(fmaxf(fminf(e0, x0), fminf(e1, x1)), fminf(e2, x2));
    float exit_ = fminf(fminf(fmaxf(e0, x0), fmaxf(e1, x1)), fmaxf(e2, x2));
    if (fmaxf(entry, 0.0f) <= fminf(exit_, tmax)) hits |= 1u << c;
  }
  return hits;
}

// Moeller-Trumbore with the reference's exact accept rule, in the plain
// versions' operation order.  Returns t and whether the slot is accepted.
__device__ __forceinline__ bool mt_slot(const float* __restrict__ q,
                                        const Ray& r, float tmax, float* t_out,
                                        float* nx, float* ny, float* nz) {
  float p0x = __ldg(q + 0), p0y = __ldg(q + 1), p0z = __ldg(q + 2);
  float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
  float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
  *nx = __ldg(q + 9);
  *ny = __ldg(q + 10);
  *nz = __ldg(q + 11);
  float cx = p0x - r.ox;
  float cy = p0y - r.oy;
  float cz = p0z - r.oz;
  float rx = r.dy * cz - r.dz * cy;
  float ry = r.dz * cx - r.dx * cz;
  float rz = r.dx * cy - r.dy * cx;
  float inv_det = 1.0f / (r.dx * *nx + r.dy * *ny + r.dz * *nz);
  float u = inv_det * (e2x * rx + e2y * ry + e2z * rz);
  float v = inv_det * (e1x * rx + e1y * ry + e1z * rz);
  float t = inv_det * (cx * *nx + cy * *ny + cz * *nz);
  *t_out = t;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= tmax);
}

struct Closest {
  float t = kBig;
  int prim = -1;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
};

// Closest hit in one leaf row: every slot against the row's entry tmax,
// the first strictly closest wins; tmax then shrinks to it.  Slots past
// the leaf's count are all-zero triangles, which reject every ray, so
// they are skipped.
__device__ __forceinline__ void leaf_closest(const float* __restrict__ row,
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
  if (rb_s >= 0) {
    *tmax = rb_t;
    best->t = rb_t;
    best->prim = __float2int_rn(__ldg(row + kPidBase + rb_s));
    best->nx = rnx; best->ny = rny; best->nz = rnz;
  }
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

// One ray's walk.  ANY: stop at the first accepted hit (returns true).
template <int W, bool ANY>
__device__ __forceinline__ bool walk(const float* __restrict__ nb,
                                     const int* __restrict__ cm,
                                     const int* __restrict__ ni,
                                     const float* __restrict__ lt,
                                     const Ray& r, float tmax, int exclude,
                                     Closest* best) {
  constexpr unsigned kAll = (1u << W) - 1u;
  int stack_node[kStack];
  unsigned stack_mask[kStack];  // (remaining mask << 1) | reversed
  int sp = 0;
  int cur = 0;
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
      walk<W, false>(nb, cm, ni, lt, r, tmax_in[i], -1, &best);
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
      o = walk<W, true>(nb, cm, ni, lt, r, tmax_in[i], exclude[i], nullptr);
    }
    occ[i] = o ? 1 : 0;
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
