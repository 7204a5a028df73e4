// The tensor-core leaf tests of rtjax's TPU probes (benchmarks/
// micro_kernel.py make_leaf_mt_mxu :359, make_leaf_mt_mxu_full :397,
// make_leaf_mt_mxu_pair :466, make_leaf_mt_mxu_group :538) on mma.sync, as
// the card's probe kernels run them (csrc/probes.cu mxu_kernel<V>).  The
// header compiles as host C++ too (tests/probes_host.cpp), where a warp's
// 32 lanes run in step at each warp-wide operation (the products and the
// shuffles), so that the tests run these bodies on CPU tensors.
//
// What a probe computes.  A tile is 2,048 rays, a leaf 8 triangles.  F
// [K, 2048] holds each ray's features (K = 16: d, o x d, o and 1 carry the
// Möller–Trumbore numerators; K = 96 for the split-K probes); the table
// holds one A block a leaf visit, rows field-major (every slot's det, then
// every slot's t numerator, ...).  An iteration i takes block i % 512 (i %
// 128 for the group probes), computes out = A_i · F (one row a slot and
// field, one column a ray), accepts each slot in FP32 and keeps each ray's
// best hit.  The tile writes its rays' best t (11h: t + f32(prim) · 1e-9);
// the other carried fields (u, v, prim, normal) go to ``fields`` when it is
// not null, so that none is dead code.
//
// Precision, decided here (the plain versions, kernels/probes.py, follow
// the same rounding steps):
// - f32 operands at rtjax's default precision (the TPU's cheap reduced
//   pass: leaf_mt_mxu_f32, _full, _pair, _pair_unpacked, _g8_f32): ONE TF32
//   pass, mma.m16n8k8.tf32, each operand rounded by cvt.rna.tf32.f32
//   (nearest, ties away; raw f32 bits fed to the instruction would be
//   truncated, which no plain version could follow);
// - precision "highest" (_full_hi, _pair_hi): 3xTF32, x_big = rna(x),
//   x_small = rna(x - x_big), each k-step as big·small, small·big, big·big
//   into one accumulator;
// - bf16 operands (_bf16, the split-K probes): one bf16 pass,
//   mma.m16n8k16.bf16, accumulated in f32 (products exact).
//
// The layout fits the accumulator.  The m16n8 C fragment gives lane l the
// rows l / 4 and l / 4 + 8 of each 16-row m-tile and the columns 2 (l % 4)
// and 2 (l % 4) + 1 of the n-tile's 8 rays.  With rtjax's field-major rows
// one lane holds every field of its slots (slot l / 4 for the 8-slot
// leaves, also slot l / 4 + 8 for 16 slots, l / 4 + 8k for the groups) for
// two rays, so the accept is thread-local.  The minimum over slots is
// three __shfl_xor_sync steps over the 8 group ids (4, 8, 16), lower slot
// on ties (jnp.argmin's first index, 11h's first row equal to the row
// minimum); 11f and 11g then take the winner's fields by __shfl_sync from
// the lane that holds it.  Fragment indices are the PTX ISA's (mma.m16n8k8
// .tf32, mma.m16n8k16 .bf16: groupID = lane / 4, threadID_in_group = lane
// % 4).
//
// The loop order.  A tile is one block of 8 warps, 256 rays a warp.  A
// ray's best hit depends only on its own column, so each warp takes its
// rays through all n iterations in chunks of kMxuChunk n-tiles (8 rays each):
// a chunk's B fragments (from F) and best hits stay in registers for the n
// iterations, and each iteration reads the leaf's A fragments (the shared
// operand, 1-48 KB a block, the whole table 0.5-6.3 MB: L2-resident, read
// through L1) once for the chunk's n-tiles.  F never needs shared memory
// (the split-K F is 384 KB, more than a block's 227 KB).  An iteration of
// the tile is 16 chunk passes of each warp, so the slope over n stays
// linear in n.
//
// The bound (rtjax_torch/probes, PERF.md row 11e-11h): the larger of the
// tensor cores' time, the tile iteration's multiply-adds over one SM's
// share of the dense peak (989 TFLOP/s bf16, 495 TF32; 3xTF32 three
// passes; mma.sync reaches less of it than wgmma, which only a later
// design uses), and the issue of the SASS loop body, 4 warp-instructions
// a clock on an SM.  The accept's division and compares, not the product,
// are most of the instructions.

#pragma once

#include <climits>
#include <cstdint>
#include <cstring>

#include "probes.cuh"

namespace rtjax_probes {

// micro_kernel.py ALL's tensor-core names (kernels/probes.py MXU_VARIANTS);
// _pair_unpacked's [112, 16] blocks are _pair's packed [14, 128] blocks,
// the same row-major bytes, so kMxuPair serves both names.
enum MxuVariant {
  kMxuF32,        // make_leaf_mt_mxu(dtype=float32): leaf_mt_mxu_f32
  kMxuBf16,       // make_leaf_mt_mxu(dtype=bfloat16): leaf_mt_mxu_bf16
  kMxuFull,       // make_leaf_mt_mxu_full: leaf_mt_mxu_full
  kMxuFullHi,     // make_leaf_mt_mxu_full(precision="highest"): _full_hi
  kMxuPair,       // make_leaf_mt_mxu_pair: _pair, _pair_unpacked
  kMxuPairHi,     // make_leaf_mt_mxu_pair(precision="highest"): _pair_hi
  kMxuG8Splitk,   // make_leaf_mt_mxu_group(group=8): _g8_splitk
  kMxuG4Splitk,   // make_leaf_mt_mxu_group(group=4): _g4_splitk
  kMxuG2Splitk,   // make_leaf_mt_mxu_group(group=2): _g2_splitk
  kMxuG8F32,      // make_leaf_mt_mxu_group(splitk=False): _g8_f32
  kMxuVariants
};

enum MxuPrec { kBf16, kTf32, kTf32x3 };
// the accept and what a probe keeps: kRecip 1 / det then products, the
// best t (11e); kWinner the sign-flip accept, the winner's u, v, prim and
// normal from its rows (11f); kPairWinner the same over two leaves' 16
// slots, the prim from the iteration (11g); kGroupSlot the sign-flip
// accept over G leaves, the winner's prim (11h)
enum MxuAccept { kRecip, kWinner, kPairWinner, kGroupSlot };

constexpr int kMxuWarps = kTileThreads / 32;      // 8 warps a tile
constexpr int kMxuWarpRays = kTileLanes / kMxuWarps;  // 256 rays a warp

// n-tiles (8 rays each) a warp takes through the n iterations at once,
// and the chunk passes a warp makes (kernels/probes.py MXU_PASSES)
constexpr int kMxuChunk = 2;
constexpr int kMxuPasses = kMxuWarpRays / (8 * kMxuChunk);

template <int kSlots_, int kFields_, int kK_, int kBlocks_, MxuPrec kPrec_,
          MxuAccept kAccept_>
struct MxuShape {
  static constexpr int kSlots = kSlots_;    // rows of a field
  static constexpr int kFields = kFields_;
  static constexpr int kRows = kSlots * kFields;   // an A block's rows
  static constexpr int kK = kK_;
  static constexpr int kBlocks = kBlocks_;  // A blocks in the table
  static constexpr MxuPrec kPrec = kPrec_;
  static constexpr MxuAccept kAccept = kAccept_;
  // the m-tiles of one product pass: every m-tile, or for the groups the
  // det, t, u and v m-tiles of 16 slots (the accumulators of all 2G
  // m-tiles would not fit in registers)
  static constexpr int kPassTiles = kAccept == kGroupSlot ? 4 : kRows / 16;
  static constexpr int kPassCount = kAccept == kGroupSlot ? kSlots / 16 : 1;
  // what ``fields`` holds a ray: t; t, u, v, prim, nx, ny, nz; t, prim
  static constexpr int kOut = kAccept == kRecip ? 1
                              : kAccept == kGroupSlot ? 2 : 7;
  static_assert(kRows % 16 == 0 && (kBlocks & (kBlocks - 1)) == 0, "");
};

template <int V> struct Mxu;
template <> struct Mxu<kMxuF32>
    : MxuShape<8, 4, 16, 512, kTf32, kRecip> {};
template <> struct Mxu<kMxuBf16>
    : MxuShape<8, 4, 16, 512, kBf16, kRecip> {};
template <> struct Mxu<kMxuFull>
    : MxuShape<8, 8, 16, 512, kTf32, kWinner> {};
template <> struct Mxu<kMxuFullHi>
    : MxuShape<8, 8, 16, 512, kTf32x3, kWinner> {};
template <> struct Mxu<kMxuPair>
    : MxuShape<16, 7, 16, 512, kTf32, kPairWinner> {};
template <> struct Mxu<kMxuPairHi>
    : MxuShape<16, 7, 16, 512, kTf32x3, kPairWinner> {};
template <> struct Mxu<kMxuG8Splitk>
    : MxuShape<64, 4, 96, 128, kBf16, kGroupSlot> {};
template <> struct Mxu<kMxuG4Splitk>
    : MxuShape<32, 4, 96, 128, kBf16, kGroupSlot> {};
template <> struct Mxu<kMxuG2Splitk>
    : MxuShape<16, 4, 96, 128, kBf16, kGroupSlot> {};
template <> struct Mxu<kMxuG8F32>
    : MxuShape<64, 4, 16, 128, kTf32, kGroupSlot> {};

// ------------------------------------------------------------ the operands
PROBE_FN uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return u;
#endif
}

PROBE_FN float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  std::memcpy(&x, &u, 4);
  return x;
#endif
}

// cvt.rna.tf32.f32: to 10 mantissa bits, nearest, ties away from zero;
// the low 13 bits cleared (kernels/probes.py _tf32 is the plain version)
PROBE_FN uint32_t tf32(float x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
#else
  if (x != x) return 0x7fc00000u;
  return (f32_bits(x) + 0x1000u) & 0xffffe000u;
#endif
}

PROBE_FN float load_f32(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// two neighbouring bf16 values (the lower one first in the register)
PROBE_FN uint32_t load_bf16x2(const uint16_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned*>(p));
#else
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 16;
#endif
}

PROBE_FN uint32_t load_bf16(const uint16_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const unsigned short*>(p));
#else
  return *p;
#endif
}

// A k-step: 16 deep in bf16 (m16n8k16), 8 in TF32 (m16n8k8)
template <MxuPrec kPrec>
constexpr int kStepK = kPrec == kBf16 ? 16 : 8;

// A fragments of one m-tile (every k-step), B fragments of one n-tile: the
// operand as the mma takes it (bf16 pairs, or TF32 bits), and for 3xTF32
// the small parts beside the big ones.
template <class P>
struct Frags {
  static constexpr int kSteps = P::kK / kStepK<P::kPrec>;
  static constexpr int kParts = P::kPrec == kTf32x3 ? 2 : 1;
  uint32_t a[kParts][kSteps][4];
};
template <class P>
struct BFrags {
  static constexpr int kSteps = P::kK / kStepK<P::kPrec>;
  static constexpr int kParts = P::kPrec == kTf32x3 ? 2 : 1;
  uint32_t b[kParts][kSteps][2];
};

// The TPU's two TF32 parts of one f32 operand: part 0 big = rna(x), part
// 1 (3xTF32 only) small = rna(x - big)
template <int kParts, int kSteps, int kRegs>
PROBE_FN void tf32_parts(float x, uint32_t (&out)[kParts][kSteps][kRegs],
                         int s, int j) {
  const uint32_t big = tf32(x);
  out[0][s][j] = big;
  if (kParts == 2) out[kParts - 1][s][j] = tf32(x - bits_f32(big));
}

// The A fragments of m-tile ``mt`` of a block (rows 16 mt..16 mt + 15):
// lane (g, q) = (lane / 4, lane % 4).  bf16: register j holds the pair at
// row g + 8 (j & 1), columns k0 + 2q + 8 (j >> 1) and + 1; TF32: register
// j the value at row g + 8 (j & 1), column k0 + q + 4 (j >> 1).
template <class P>
PROBE_FN void load_a(Frags<P>& f, const void* block, int mt, int g, int q) {
  constexpr int K = P::kK;
  const int r0 = 16 * mt + g;
#pragma unroll
  for (int s = 0; s < Frags<P>::kSteps; ++s) {
    if constexpr (P::kPrec == kBf16) {
      const uint16_t* a = static_cast<const uint16_t*>(block);
      const int k0 = 16 * s + 2 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f.a[0][s][j] = load_bf16x2(a + (r0 + 8 * (j & 1)) * K + k0 +
                                   8 * (j >> 1));
    } else {
      const float* a = static_cast<const float*>(block);
      const int k0 = 8 * s + q;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf32_parts(load_f32(a + (r0 + 8 * (j & 1)) * K + k0 + 4 * (j >> 1)),
                   f.a, s, j);
    }
  }
}

// The B fragments of the n-tile whose ray ``ray`` (its column g) this lane
// loads: bf16 register j the pair at rows k0 + 2q + 8j and + 1 (2,048
// apart in F, packed here), TF32 register j the value at row k0 + q + 4j.
template <class P>
PROBE_FN void load_b(BFrags<P>& f, const void* feats, int ray, int q) {
#pragma unroll
  for (int s = 0; s < BFrags<P>::kSteps; ++s) {
    if constexpr (P::kPrec == kBf16) {
      const uint16_t* x = static_cast<const uint16_t*>(feats) + ray;
      const int k0 = 16 * s + 2 * q;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        f.b[0][s][j] = load_bf16(x + (k0 + 8 * j) * kTileLanes) |
                       load_bf16(x + (k0 + 8 * j + 1) * kTileLanes) << 16;
    } else {
      const float* x = static_cast<const float*>(feats) + ray;
      const int k0 = 8 * s + q;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tf32_parts(load_f32(x + (k0 + 4 * j) * kTileLanes), f.b, s, j);
    }
  }
}

// acc += A · B over the m-tile's K: each k-step one mma (3xTF32: three,
// big·small, small·big, big·big).  ``W`` issues the warp's mma.
PROBE_POLICY
template <class P, class W>
PROBE_FN void mma_tile(float (&acc)[4], const Frags<P>& a, const BFrags<P>& b,
                       W& w) {
#pragma unroll
  for (int s = 0; s < Frags<P>::kSteps; ++s) {
    if constexpr (P::kPrec == kBf16) {
      w.mma_bf16(acc, a.a[0][s], b.b[0][s]);
    } else if constexpr (P::kPrec == kTf32) {
      w.mma_tf32(acc, a.a[0][s], b.b[0][s]);
    } else {
      w.mma_tf32(acc, a.a[0][s], b.b[1][s]);
      w.mma_tf32(acc, a.a[1][s], b.b[0][s]);
      w.mma_tf32(acc, a.a[0][s], b.b[0][s]);
    }
  }
}

// One product pass of a chunk: m-tiles base + f * stride (f < kPassTiles)
// against the chunk's n-tiles, from zero.
PROBE_POLICY
template <class P, class W>
PROBE_FN void product(float (&acc)[kMxuChunk][P::kPassTiles][4],
                      const void* block, int base, int stride,
                      const BFrags<P> (&b)[kMxuChunk], int g, int q, W& w) {
#pragma unroll
  for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
    for (int f = 0; f < P::kPassTiles; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][f][j] = 0.0f;
#pragma unroll
  for (int f = 0; f < P::kPassTiles; ++f) {
    Frags<P> a;
    load_a<P>(a, block, base + f * stride, g, q);
#pragma unroll
    for (int c = 0; c < kMxuChunk; ++c) mma_tile<P>(acc[c][f], a, b[c], w);
  }
}

// The value of field ``f`` of this lane's k-th slot for its ray e (0 or 1)
// in a pass's accumulators: 8-slot fields share an m-tile two to one (rows
// 16 m..16 m + 7 one field, the next 8 the next), 16-slot fields fill one
// (slot g in rows g, slot g + 8 in rows g + 8).
template <int kSlots, int kTiles>
PROBE_FN float at(const float (&acc)[kTiles][4], int f, int k, int e) {
  return kSlots == 8 ? acc[f >> 1][2 * (f & 1) + e] : acc[f][2 * k + e];
}

// The sign-flip accept (micro_kernel.py :422-432): the slot's t where it
// is hit, else BIG; one division a slot.
PROBE_FN float accept_signed(float det, float tn, float un, float vn,
                             float best) {
  const float s = det < 0.0f ? -1.0f : 1.0f;
  const float adet = det * s;
  const float at = tn * s;
  const float au = un * s;
  const float av = vn * s;
  const bool h = (au >= 0.0f) & (av >= 0.0f) & (au + av <= adet) &
                 (at > 0.0f) & (at <= best * adet);
  const float t = at / adet;
  return h ? t : kBig;
}

// (t, slot) at its minimum over the 8 lanes of a column (group ids 0-7),
// the lower slot on equal t: every one of them ends with it.
PROBE_POLICY
template <class W>
PROBE_FN void argmin_lanes(float& t, int& slot, W& w) {
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1) {
    const float ot = w.shfl_xor(t, m);
    const int os = w.shfl_xor(slot, m);
    if (ot < t || (ot == t && os < slot)) {
      t = ot;
      slot = os;
    }
  }
}

// A chunk's best hits: [n-tile][ray] t, and u, v, prim, nx, ny, nz (11f,
// 11g) or the int prim (11h).
struct MxuBest {
  float t[kMxuChunk][2];
  float x[kMxuChunk][2][6];
  int p[kMxuChunk][2];
};

// 11f: det, tn, un, vn, pid, nx, ny, nz, 8 rows each (:411-446); 11g:
// det, tn, un, vn, nx, ny, nz, 16 rows each (:484-516).  The first
// argmin's slot over the lanes, then its rows from the lane that holds it.
PROBE_POLICY
template <class P, class W>
PROBE_FN void winner(MxuBest& best,
                     const float (&acc)[kMxuChunk][P::kPassTiles][4], int i,
                     int g, int q, W& w) {
  constexpr bool kPair = P::kAccept == kPairWinner;
  constexpr int S = P::kSlots;
#pragma unroll
  for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float t = kBig;
      int slot = INT_MAX;
#pragma unroll
      for (int k = 0; k < S / 8; ++k) {
        const float tk = accept_signed(at<S>(acc[c], 0, k, e),
                                       at<S>(acc[c], 1, k, e),
                                       at<S>(acc[c], 2, k, e),
                                       at<S>(acc[c], 3, k, e), best.t[c][e]);
        if (tk < t || k == 0) {
          t = tk;
          slot = g + 8 * k;
        }
      }
      argmin_lanes(t, slot, w);
      // the winner's rows, from the lane that holds its slot
      const int kw = slot >> 3;
      const int src = 4 * (slot & 7) + q;
      float own[6];   // det, un, vn, nx, ny, nz
      constexpr int kNormal = kPair ? 4 : 5;
#pragma unroll
      for (int f = 0; f < 6; ++f) {
        const int field = f == 0 ? 0 : f < 3 ? f + 1 : f + kNormal - 3;
        own[f] = S == 16 && kw ? at<S>(acc[c], field, 1, e)
                               : at<S>(acc[c], field, 0, e);
      }
      const float wdet = w.shfl(own[0], src);
      const float wun = w.shfl(own[1], src);
      const float wvn = w.shfl(own[2], src);
      float wx[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) wx[f] = w.shfl(own[3 + f], src);
      float pid;
      if constexpr (kPair) {
        pid = static_cast<float>(floor_mod(i, P::kBlocks)) * 8.0f +
              static_cast<float>(slot);
      } else {
        const float own_pid = at<S>(acc[c], 4, 0, e);
        pid = w.shfl(own_pid, src);
      }
      const bool improved = t < best.t[c][e];
      const float u = wun / wdet;
      const float v = wvn / wdet;
      float* x = best.x[c][e];
      best.t[c][e] = improved ? t : best.t[c][e];
      x[0] = improved ? u : x[0];
      x[1] = improved ? v : x[1];
      x[2] = improved ? pid : x[2];
#pragma unroll
      for (int f = 0; f < 3; ++f) x[3 + f] = improved ? wx[f] : x[3 + f];
    }
}

// One leaf visit (iteration i) of a chunk, the accept after the product.
PROBE_POLICY
template <class P, class W>
PROBE_FN void visit(MxuBest& best, const void* block,
                    const BFrags<P> (&b)[kMxuChunk], int i, int g, int q,
                    W& w) {
  float acc[kMxuChunk][P::kPassTiles][4];
  if constexpr (P::kAccept == kRecip) {
    // det 0-7, un 8-15, vn 16-23, tn 24-31 (:371-383)
    product<P>(acc, block, 0, 1, b, g, q, w);
#pragma unroll
    for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float det = at<8>(acc[c], 0, 0, e);
        const float inv_det = 1.0f / det;
        const float u = at<8>(acc[c], 1, 0, e) * inv_det;
        const float v = at<8>(acc[c], 2, 0, e) * inv_det;
        const float t = at<8>(acc[c], 3, 0, e) * inv_det;
        const bool h = (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
                       (t > 0.0f) & (t < best.t[c][e]);
        float m = h ? t : kBig;
#pragma unroll
        for (int s = 4; s <= 16; s <<= 1) m = min_nan(m, w.shfl_xor(m, s));
        best.t[c][e] = min_nan(best.t[c][e], m);
      }
  } else if constexpr (P::kAccept == kGroupSlot) {
    // det, tn, un, vn: kSlots rows each (:566-576); 16 slots a pass
    float run_t[kMxuChunk][2];
    int run_s[kMxuChunk][2];
#pragma unroll
    for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        run_t[c][e] = kBig;
        run_s[c][e] = INT_MAX;
      }
#pragma unroll
    for (int j = 0; j < P::kPassCount; ++j) {
      product<P>(acc, block, j, P::kSlots / 16, b, g, q, w);
#pragma unroll
      for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float t = accept_signed(
                at<16>(acc[c], 0, k, e), at<16>(acc[c], 1, k, e),
                at<16>(acc[c], 2, k, e), at<16>(acc[c], 3, k, e),
                best.t[c][e]);
            if (t < run_t[c][e]) {   // this lane's slots rise: first wins
              run_t[c][e] = t;
              run_s[c][e] = 16 * j + 8 * k + g;
            }
          }
    }
#pragma unroll
    for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        argmin_lanes(run_t[c][e], run_s[c][e], w);
        const bool improved = run_t[c][e] < best.t[c][e];
        best.t[c][e] = improved ? run_t[c][e] : best.t[c][e];
        best.p[c][e] = improved ? floor_mod(i, P::kBlocks) * P::kSlots +
                                      run_s[c][e]
                                : best.p[c][e];
      }
  } else {
    product<P>(acc, block, 0, 1, b, g, q, w);
    winner<P>(best, acc, i, g, q, w);
  }
}

// Ray ``ray``'s out (11h: best_t + f32(best_p) * 1e-9, :601, two
// roundings) and, when ``fields`` is not null, its fields.
template <class P>
PROBE_FN void store(const MxuBest& best, int c, int e, int ray,
                    float* out,
                    float* fields) {
  const float t = best.t[c][e];
  out[ray] = P::kAccept == kGroupSlot
                 ? t + static_cast<float>(best.p[c][e]) * 1e-9f
                 : t;
  if (fields == nullptr) return;
  fields[ray] = t;
  if (P::kAccept == kGroupSlot)
    fields[kTileLanes + ray] = static_cast<float>(best.p[c][e]);
  if (P::kOut == 7) {
#pragma unroll
    for (int f = 0; f < 6; ++f)
      fields[(f + 1) * kTileLanes + ray] = best.x[c][e][f];
  }
}

// One warp's part of a tile: rays 256 warp..256 warp + 255 in chunks of
// kMxuChunk n-tiles, each through the n iterations over block i % kBlocks
// of ``table``; the chunk's best t into ``out`` (the tile's 2,048 rays)
// and its fields into ``fields`` ([P::kOut, 2048], when not null).
PROBE_POLICY
template <int V, class W>
PROBE_FN void mxu_warp(const void* table, const void* feats, float* out,
                       float* fields, int n, int warp, W& w) {
  using P = Mxu<V>;
  const int lane = w.lane(), g = lane >> 2, q = lane & 3;
  constexpr int kBlockElems = P::kRows * P::kK;
  constexpr int kElem = P::kPrec == kBf16 ? 2 : 4;
#pragma unroll 1
  for (int pass = 0; pass < kMxuPasses; ++pass) {
    const int n0 = warp * kMxuWarpRays + pass * 8 * kMxuChunk;
    BFrags<P> b[kMxuChunk];
    MxuBest best;
#pragma unroll
    for (int c = 0; c < kMxuChunk; ++c) {
      load_b<P>(b[c], feats, n0 + 8 * c + g, q);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        best.t[c][e] = kBig;
        best.p[c][e] = -1;
        best.x[c][e][0] = kBig;
        best.x[c][e][1] = kBig;
        best.x[c][e][2] = -1.0f;
        best.x[c][e][3] = best.x[c][e][4] = best.x[c][e][5] = 0.0f;
      }
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const char* block = static_cast<const char*>(table) +
                          static_cast<long long>(floor_mod(i, P::kBlocks)) *
                              kBlockElems * kElem;
      visit<P>(best, block, b, i, g, q, w);
    }
    if (g == 0) {   // every lane of a column holds its two rays
#pragma unroll
      for (int c = 0; c < kMxuChunk; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store<P>(best, c, e, n0 + 8 * c + 2 * q + e, out, fields);
    }
  }
}

}  // namespace rtjax_probes
