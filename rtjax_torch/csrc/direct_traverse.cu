// The tiny-scene direct path for Hopper (sm_90a): closest hit and any hit
// of every ray against every triangle of a small mesh, no BVH.
//
// Replaces: rtjax/render/trace.py, _direct_closest and _direct_anyhit --
// not Pallas kernels but an unrolled all-triangles Moeller-Trumbore loop
// that XLA fuses into the surrounding iteration.  rtjax takes it for every
// single-level launch over a mesh of at most ``direct_max_tris`` (default
// 64) triangles; so does the port (render/trace.py ``_backend``).
//
// What bounds it on this card.  Each ray's inputs read once and its
// results written once (closest hit 33 bytes in, 21 out; any hit 37 in, 1
// out) and 48 bytes a triangle once, over 3.35 TB/s; against one
// Moeller-Trumbore test (42 flops) per ray and triangle over 67 TFLOP/s.
// At config 2's 14 triangles the bytes bound it, at 64 the flops.
//
// What the design does about it: one thread a ray, the rays read as SoA
// columns so that loads coalesce; the block stages the triangles' p0, e1,
// e2 and n in shared memory, kTile (64) at a time -- a mesh of at most 64
// triangles is one 3-KB tile -- so a triangle is read from device memory
// once a block, and every thread reads the same triangle at the same step,
// a shared-memory broadcast.  A larger ``direct_max_tris`` (rtjax caps no
// value) loops over tiles.  An any-hit ray stops at its first occluder;
// the block stops staging tiles once none of its rays is still looking.
//
// Exactness: the build uses --fmad=false, and the test keeps
// core/geometry.py intersect_triangle_v3's operation order (c = p0 - o,
// r = d x c, 1 / (d . n), then u, v, t), so every lane agrees bit for bit
// with the plain versions (kernels/direct.py) and with rtjax's loop.  The
// triangles go in leaf order with a strict t < best, so the kept one is
// the first of least t.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 64;          // triangles staged a tile (3 KB)
constexpr float kBig = 3.4e38f;    // t of a miss / an inactive lane

struct Tris {
  const float* p0;  // [T, 3] each
  const float* e1;
  const float* e2;
  const float* n;
  int num;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* tmax;
  const unsigned char* active;
  const int* exclude;  // any hit only
};

// One tile of triangles in shared memory, [kTile, 3] a field.
struct Tile {
  float p0[3 * kTile], e1[3 * kTile], e2[3 * kTile], n[3 * kTile];
};

// Stage triangles base .. base + count - 1 (count <= kTile); the caller
// synchronises before and after.
__device__ __forceinline__ void stage(Tile& s, const Tris& tr, int base,
                                      int count) {
  const int off = 3 * base;
  for (int j = threadIdx.x; j < 3 * count; j += kBlock) {
    s.p0[j] = __ldg(tr.p0 + off + j);
    s.e1[j] = __ldg(tr.e1 + off + j);
    s.e2[j] = __ldg(tr.e2 + off + j);
    s.n[j] = __ldg(tr.n + off + j);
  }
}

// Moeller-Trumbore of one ray against staged triangle k, with the
// reference's accept rule, in intersect_triangle_v3's operation order.
__device__ __forceinline__ bool mt(const Tile& s, int k, float ox, float oy,
                                   float oz, float dx, float dy, float dz,
                                   float tmax, float* t_out) {
  const float* p0 = s.p0 + 3 * k;
  const float* e1 = s.e1 + 3 * k;
  const float* e2 = s.e2 + 3 * k;
  const float* n = s.n + 3 * k;
  const float cx = p0[0] - ox;
  const float cy = p0[1] - oy;
  const float cz = p0[2] - oz;
  const float rx = dy * cz - dz * cy;
  const float ry = dz * cx - dx * cz;
  const float rz = dx * cy - dy * cx;
  const float inv_det = 1.0f / (dx * n[0] + dy * n[1] + dz * n[2]);
  const float u = inv_det * (e2[0] * rx + e2[1] * ry + e2[2] * rz);
  const float v = inv_det * (e1[0] * rx + e1[1] * ry + e1[2] * rz);
  const float t = inv_det * (cx * n[0] + cy * n[1] + cz * n[2]);
  *t_out = t;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &
         (t <= tmax);
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(const Tris tr, const Rays rays, const int n,
               unsigned char* __restrict__ hit, float* __restrict__ t_out,
               int* __restrict__ prim_out, float* __restrict__ nx,
               float* __restrict__ ny, float* __restrict__ nz) {
  __shared__ Tile s;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n && rays.active[i] != 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tmax = 0.0f;
  if (live) {
    ox = rays.ox[i]; oy = rays.oy[i]; oz = rays.oz[i];
    dx = rays.dx[i]; dy = rays.dy[i]; dz = rays.dz[i];
    tmax = rays.tmax[i];
  }
  float best = kBig, bx = 0.0f, by = 0.0f, bz = 0.0f;
  int prim = -1;
  for (int base = 0; base < tr.num; base += kTile) {
    const int count = min(kTile, tr.num - base);
    __syncthreads();
    stage(s, tr, base, count);
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      float t;
      if (mt(s, k, ox, oy, oz, dx, dy, dz, tmax, &t) && t < best) {
        best = t;
        prim = base + k;
        bx = s.n[3 * k];
        by = s.n[3 * k + 1];
        bz = s.n[3 * k + 2];
      }
    }
  }
  if (i < n) {
    const bool h = prim >= 0;  // an inactive lane keeps prim -1
    hit[i] = h ? 1 : 0;
    t_out[i] = best;
    prim_out[i] = prim;
    nx[i] = bx;
    ny[i] = by;
    nz[i] = bz;
  }
}

__global__ void __launch_bounds__(kBlock)
anyhit_kernel(const Tris tr, const Rays rays, const int n,
              unsigned char* __restrict__ occ_out) {
  __shared__ Tile s;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n && rays.active[i] != 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tmax = 0.0f;
  int exclude = -1;
  if (live) {
    ox = rays.ox[i]; oy = rays.oy[i]; oz = rays.oz[i];
    dx = rays.dx[i]; dy = rays.dy[i]; dz = rays.dz[i];
    tmax = rays.tmax[i];
    exclude = rays.exclude[i];
  }
  bool occ = false;
  for (int base = 0; base < tr.num; base += kTile) {
    // also the barrier before staging: stop once no ray of the block is
    // still looking
    if (!__syncthreads_or(live && !occ)) break;
    const int count = min(kTile, tr.num - base);
    stage(s, tr, base, count);
    __syncthreads();
    if (!live || occ) continue;
    for (int k = 0; k < count; ++k) {
      float t;
      if (mt(s, k, ox, oy, oz, dx, dy, dz, tmax, &t) && base + k != exclude) {
        occ = true;
        break;
      }
    }
  }
  if (i < n) occ_out[i] = occ ? 1 : 0;
}

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// ``num_tris`` triangles (leaf order, [T, 3] float32 each), ``n`` rays as
// SoA columns; results as the plain versions give them (kernels/direct.py).
// Returns the launch's CUDA error code (0 when queued).
extern "C" int rtjax_direct_closest(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num_tris, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, int n, unsigned char* hit, float* t,
    int* prim, float* nx, float* ny, float* nz, void* stream) {
  if (n <= 0) return 0;
  if (num_tris < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tris tr{p0, e1, e2, nrm, num_tris};
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, nullptr};
  closest_kernel<<<grid_of(n), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(tr, rays, n, hit, t,
                                                        prim, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtjax_direct_anyhit(
    const float* p0, const float* e1, const float* e2, const float* nrm,
    int num_tris, const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz, const float* tmax,
    const unsigned char* active, const int* exclude, int n,
    unsigned char* occ, void* stream) {
  if (n <= 0) return 0;
  if (num_tris < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Tris tr{p0, e1, e2, nrm, num_tris};
  const Rays rays{ox, oy, oz, dx, dy, dz, tmax, active, exclude};
  anyhit_kernel<<<grid_of(n), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(tr, rays, n, occ);
  return static_cast<int>(cudaGetLastError());
}
