// The loop bodies of rtjax's TPU probes (benchmarks/micro_kernel.py), as
// the card's probe kernels run them (csrc/probes.cu).  The header compiles
// as host C++ too (tests/probes_host.cpp), so that the tests run the same
// bodies on CPU tensors.
//
// Each TPU probe is one core looping n times over a [16, 128] tile of
// 2,048 lanes and writing one int32 checksum.  Here a tile is a block of
// kTileThreads threads, kLanes lanes a thread (lane t + kTileThreads * j
// of the tile for thread t); a thread's part of the checksum is a uint32
// sum (int32 sums wrap modulo 2^32 in JAX, and a sum over lanes is exact
// in any order).  The scalar probes (the walk, clz) are one thread's
// chain, as on the TPU's scalar unit.
//
// Exactness: the library builds with --fmad=false and no fast math, so
// bb * inv + sc stays two rounded operations and 1 / det is the IEEE
// quotient, as in the plain versions (kernels/probes.py); jnp.maximum and
// jnp.minimum propagate NaN, and so do max_nan / min_nan.  Every value is
// formed in micro_kernel.py's operation order, sums left to right.

#pragma once

#include <climits>

// PROBE_POLICY goes before a template that calls its policy's members
// (the card's policies are __device__ only, the host stand-ins' host only)
#ifdef __CUDACC__
#define PROBE_FN __host__ __device__ __forceinline__
#define PROBE_POLICY _Pragma("nv_exec_check_disable")
#else
#define PROBE_FN inline
#define PROBE_POLICY
struct float4 {
  float x, y, z, w;
};
#endif

namespace rtjax_probes {

constexpr int kTileLanes = 2048;   // the TPU tile: [16, 128]
constexpr int kTileThreads = 256;
constexpr int kLanes = kTileLanes / kTileThreads;
constexpr int kRows = 1024;        // the table: [1024, 128] f32
constexpr int kRowLanes = 128;
constexpr int kStack = 64;         // the scalar walk's SMEM stack
constexpr int kPidBase = 96;       // a leaf row's prim ids at lanes 96..103
constexpr float kBig = 3.4e38f;

// The tile probes (kernels/probes.py TILE_VARIANTS; micro_kernel.py ALL).
enum Variant {
  kSlabPair,         // _make_slab_step, 2 children
  kSlabWide4,        // _make_slab_step, 4
  kSlabWide8,        // _make_slab_step, 8
  kSlabWide8Row1,    // _make_slab_step_row1, 8
  kSlabWide8Fused,   // _make_slab_step_fused, 8
  kSlabWide16Fused,  // _make_slab_step_fused, 16
  kLeafMt,           // make_leaf_mt_vpu
  kLeafMtNodiv,      // make_leaf_mt_vpu_nodiv
  kLeafMtRow1,       // make_leaf_mt_vpu(row1=True)
  kLeafMtPar,        // make_leaf_mt_vpu(serialize=False)
  kVariants
};

// jnp's % (floor modulo) by a power of two m: a's low bits, whatever its
// sign (C++'s % truncates: -1 % 1024 is -1, floor modulo 1023)
PROBE_FN int floor_mod(int a, int m) { return a & (m - 1); }
static_assert((kRows & (kRows - 1)) == 0 && (kStack & (kStack - 1)) == 0,
              "floor_mod takes powers of two");

PROBE_FN float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : a > b ? a : b;
#endif
}

PROBE_FN float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : a < b ? a : b;
#endif
}

// astype(int32) of a float: toward zero (saturating; NaN gives 0)
PROBE_FN int trunc_int(float x) {
#ifdef __CUDA_ARCH__
  return __float2int_rz(x);
#else
  return x != x ? 0 : x >= 2147483648.0f ? INT_MAX
       : x <= -2147483648.0f ? INT_MIN : static_cast<int>(x);
#endif
}

PROBE_FN int clz32(int x) {
#ifdef __CUDA_ARCH__
  return __clz(x);
#else
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
#endif
}

PROBE_FN int load_meta(const int* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// ------------------------------------------------------------ scalar walk
// make_scalar_walk (micro_kernel.py:87-113): one dependent chain over a
// [1024] int32 table.  The stack starts filled with INT32_MIN, as the
// reference interpreter fills uninitialised int32 scratch, and a pop at an
// index past the 64 entries reads entry 63, as the interpreter clamps the
// index (a chain of more than 64 leaf steps gets there).  ``Stack`` has
// ``get(k)`` and ``set(k, v)``.
PROBE_POLICY
template <class Stack>
PROBE_FN unsigned scalar_walk(const int* meta, Stack& stack, int n) {
#pragma unroll
  for (int k = 0; k < kStack; ++k) stack.set(k, INT_MIN);
  int cur = 0, sp = 1;
  unsigned acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int m = load_meta(meta + cur);
    const bool leaf = (m & 15) > 0;
    const int nxt = floor_mod(m >> 4, kRows);
    stack.set(floor_mod(sp, kStack), cur);
    sp = leaf ? sp + 1 : (sp - 1 > 0 ? sp - 1 : 0);
    const int at = sp - 1 > 0 ? sp - 1 : 0;
    const int popped = stack.get(at < kStack - 1 ? at : kStack - 1);
    cur = leaf ? nxt : floor_mod(popped, kRows);
    acc += static_cast<unsigned>(m);
  }
  return acc;
}

// -------------------------------------------------------------------- clz
// make_clz (micro_kernel.py:763-782): the bit operations a walk pops its
// child masks with.
PROBE_FN unsigned clz_chain(int n) {
  unsigned acc = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    int x = static_cast<int>((static_cast<unsigned>(i) * 40503u) & 255u);
    x = x > 1 ? x : 1;
    const int ctz = 31 - clz32(x & -x);
    const int hi = 31 - clz32(x);
    acc += static_cast<unsigned>(ctz + hi);
  }
  return acc;
}

// ------------------------------------------------------------- slab steps
// _slab (micro_kernel.py:68-79) and the fused accept of
// _make_slab_step_fused (:190-214)
template <bool kFused>
PROBE_FN bool slab(float b0, float b1, float b2, float b3, float b4,
                   float b5, const float* inv, const float* sc, float tmax) {
  const float e0 = b0 * inv[0] + sc[0];
  const float e1 = b1 * inv[1] + sc[1];
  const float e2 = b2 * inv[2] + sc[2];
  const float x0 = b3 * inv[0] + sc[0];
  const float x1 = b4 * inv[1] + sc[1];
  const float x2 = b5 * inv[2] + sc[2];
  const float ent = max_nan(max_nan(min_nan(e0, x0), min_nan(e1, x1)),
                            min_nan(e2, x2));
  const float ext = min_nan(min_nan(max_nan(e0, x0), max_nan(e1, x1)),
                            max_nan(e2, x2));
  if (kFused) return max_nan(ent, 0.0f) <= min_nan(ext, tmax);
  return (ent <= ext) & (ext >= 0.0f) & (ent <= tmax);
}

// What child c's hit adds to a lane's checksum: _make_slab_step packs two
// children as hits[0] * 16384 + hits[-1] (:132-134) and more as bytes,
// m0 the first four, m1 the rest (:135-140); _make_slab_step_fused packs
// pairs, hits[2j] * 32768 + hits[2j + 1] (:219-224).
template <int kChildren, bool kFused>
PROBE_FN unsigned child_weight(int c) {
  if (kFused) {
    const int pairs = (kChildren + 7) / 8 * 4;
    return c >= 2 * pairs ? 0u : (c & 1) ? 1u : 32768u;
  }
  if (kChildren <= 2)
    return (c == 0 ? 16384u : 0u) + (c == kChildren - 1 ? 1u : 0u);
  return 1u << (8 * (c < 4 ? c : c - 4));
}

// A slab probe: each lane's inv, sc and tmax (rays [7, 2048]); an
// iteration tests the row's kChildren boxes, lanes 6c..6c+5 of the row,
// broadcast to every lane.  ``Row`` has ``load4(q)``, the row's lanes
// 4q..4q+3.
template <int kChildren, bool kFused>
struct Slab {
  static constexpr int kRayRows = 7;
  static constexpr int kRowValues = 6 * kChildren;
  float inv[kLanes][3], sc[kLanes][3], tmax[kLanes];
  unsigned acc;

  PROBE_FN void init(const float* rays, int t) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = t + kTileThreads * j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        inv[j][k] = rays[k * kTileLanes + l];
        sc[j][k] = rays[(k + 3) * kTileLanes + l];
      }
      tmax[j] = rays[6 * kTileLanes + l];
    }
    acc = 0;
  }

  PROBE_POLICY
  template <class Row>
  PROBE_FN void step(const Row& row) {
    unsigned s = 0;
#pragma unroll
    for (int c = 0; c < kChildren; c += 2) {   // two boxes: three float4s
      const float4 f0 = row.load4(3 * c / 2);
      const float4 f1 = row.load4(3 * c / 2 + 1);
      const float4 f2 = row.load4(3 * c / 2 + 2);
      const unsigned w0 = child_weight<kChildren, kFused>(c);
      const unsigned w1 = child_weight<kChildren, kFused>(c + 1);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const bool h0 = slab<kFused>(f0.x, f0.y, f0.z, f0.w, f1.x, f1.y,
                                     inv[j], sc[j], tmax[j]);
        const bool h1 = slab<kFused>(f1.z, f1.w, f2.x, f2.y, f2.z, f2.w,
                                     inv[j], sc[j], tmax[j]);
        s += (h0 ? w0 : 0u) + (h1 ? w1 : 0u);
      }
    }
    acc += s;
  }

  PROBE_FN unsigned result() const { return acc; }
};

// -------------------------------------------------------- leaf MT steps
enum LeafMode { kSerial, kParallel, kNoDiv };

// A leaf probe: make_leaf_mt_vpu (:239-294; kSerial chains tmax through
// the 8 slots, kParallel tests them against the visit's entry tmax) and
// make_leaf_mt_vpu_nodiv (:298-356, the sign-flip accept, one division a
// visit).  Each lane's o and d (rays [6, 2048]); an iteration tests the
// row's 8 triangles (slot s: p0, e1, e2, n at lanes 12s..12s+11, the prim
// id at 96 + s), broadcast to every lane.  The checksum is the sum of the
// lanes' prims after the last iteration.
template <int kMode>
struct Leaf {
  static constexpr int kRayRows = 6;
  static constexpr int kRowValues = kPidBase + 8;
  float o[kLanes][3], d[kLanes][3], tmax[kLanes], t[kLanes];
  int prim[kLanes];

  PROBE_FN void init(const float* rays, int tid) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int l = tid + kTileThreads * j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[j][k] = rays[k * kTileLanes + l];
        d[j][k] = rays[(k + 3) * kTileLanes + l];
      }
      tmax[j] = kBig;
      t[j] = kBig;
      prim[j] = -1;
    }
  }

  PROBE_POLICY
  template <class Row>
  PROBE_FN void step(const Row& row) {
    const float4 pa = row.load4(kPidBase / 4);
    const float4 pb = row.load4(kPidBase / 4 + 1);
    const float pids[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    float ref_tmax[kLanes], bat[kLanes], badet[kLanes];
    int bprim[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      ref_tmax[j] = tmax[j];
      bat[j] = kBig;
      badet[j] = 1.0f;
      bprim[j] = -1;
    }
#pragma unroll
    for (int slot = 0; slot < 8; ++slot) {
      const float4 f0 = row.load4(3 * slot);
      const float4 f1 = row.load4(3 * slot + 1);
      const float4 f2 = row.load4(3 * slot + 2);
      const float p0x = f0.x, p0y = f0.y, p0z = f0.z;
      const float e1x = f0.w, e1y = f1.x, e1z = f1.y;
      const float e2x = f1.z, e2y = f1.w, e2z = f2.x;
      const float nx = f2.y, ny = f2.z, nz = f2.w;
      const int pid = trunc_int(pids[slot]);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const float* oo = o[j];
        const float* dd = d[j];
        const float cx = p0x - oo[0];
        const float cy = p0y - oo[1];
        const float cz = p0z - oo[2];
        const float rx = dd[1] * cz - dd[2] * cy;
        const float ry = dd[2] * cx - dd[0] * cz;
        const float rz = dd[0] * cy - dd[1] * cx;
        const float det = dd[0] * nx + dd[1] * ny + dd[2] * nz;
        if (kMode == kNoDiv) {
          const float sg = det < 0.0f ? -1.0f : 1.0f;
          const float adet = det * sg;
          const float au = (e2x * rx + e2y * ry + e2z * rz) * sg;
          const float av = (e1x * rx + e1y * ry + e1z * rz) * sg;
          const float at = (cx * nx + cy * ny + cz * nz) * sg;
          const bool h = (au >= 0.0f) & (av >= 0.0f) & (au + av <= adet) &
                         (at > 0.0f) & (at <= tmax[j] * adet);
          const bool closer = h & (at * badet[j] < bat[j] * adet);
          bat[j] = closer ? at : bat[j];
          badet[j] = closer ? adet : badet[j];
          bprim[j] = closer ? pid : bprim[j];
        } else {
          const float inv_det = 1.0f / det;
          const float u = inv_det * (e2x * rx + e2y * ry + e2z * rz);
          const float v = inv_det * (e1x * rx + e1y * ry + e1z * rz);
          const float tt = inv_det * (cx * nx + cy * ny + cz * nz);
          const float cmp = kMode == kSerial ? tmax[j] : ref_tmax[j];
          const bool h = (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
                         (tt > 0.0f) & (tt <= cmp);
          tmax[j] = h & (tt < tmax[j]) ? tt : tmax[j];
          t[j] = h & (tt <= t[j]) ? tt : t[j];
          prim[j] = h & (tt <= t[j]) ? pid : prim[j];   // the new t
        }
      }
    }
    if (kMode == kNoDiv) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const bool ok = bprim[j] >= 0;
        const float bt = bat[j] / badet[j];   // one division a visit
        tmax[j] = ok ? bt : tmax[j];
        t[j] = ok ? bt : t[j];
        prim[j] = ok ? bprim[j] : prim[j];
      }
    }
  }

  PROBE_FN unsigned result() const {
    unsigned s = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) s += static_cast<unsigned>(prim[j]);
    return s;
  }
};

// A variant's body, and whether it reads its row the TPU's row1 way (the
// card's other broadcast: csrc/probes.cu ShflRow).
template <int V> struct Probe;
template <> struct Probe<kSlabPair> {
  using Body = Slab<2, false>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kSlabWide4> {
  using Body = Slab<4, false>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kSlabWide8> {
  using Body = Slab<8, false>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kSlabWide8Row1> {
  using Body = Slab<8, false>;
  static constexpr bool kRow1 = true;
};
template <> struct Probe<kSlabWide8Fused> {
  using Body = Slab<8, true>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kSlabWide16Fused> {
  using Body = Slab<16, true>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kLeafMt> {
  using Body = Leaf<kSerial>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kLeafMtNodiv> {
  using Body = Leaf<kNoDiv>;
  static constexpr bool kRow1 = false;
};
template <> struct Probe<kLeafMtRow1> {
  using Body = Leaf<kSerial>;
  static constexpr bool kRow1 = true;
};
template <> struct Probe<kLeafMtPar> {
  using Body = Leaf<kParallel>;
  static constexpr bool kRow1 = false;
};

// One thread's part of a tile probe: its lanes' rays, n iterations over
// rows i % 1024 of the table (``Row(row pointer)`` reads a row), and its
// lanes' checksum.
PROBE_POLICY
template <class Body, class Row>
PROBE_FN unsigned tile_thread(const float* table, const float* rays, int t,
                              int n) {
  Body body;
  body.init(rays, t);
#pragma unroll 1
  for (int i = 0; i < n; ++i)
    body.step(Row(table + floor_mod(i, kRows) * kRowLanes));
  return body.result();
}

}  // namespace rtjax_probes
