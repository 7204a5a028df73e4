// The stable key sort's arithmetic (csrc/key_sort.cu; kernels/sort.py):
// the keys' order-preserving map to unsigned words, the digits of each
// pass, a tile's geometry, the ranks within a warp, the look-back's status
// words, the sort_every cadence and the scratch's layout.  Every function
// is __host__ __device__, so that tests/key_sort_host.cpp compiles them as
// host C++ and runs the passes tile by tile.
#pragma once

// keys a thread ranks in a pass, and reads in the upsweep (a build may set
// these: tools/sort_designs.py --variants)
#ifndef RTJAX_SORT_ITEMS
#define RTJAX_SORT_ITEMS 8
#endif
#ifndef RTJAX_SORT_UP_ITEMS
#define RTJAX_SORT_UP_ITEMS 16
#endif
// status words a look-back step reads at once
#ifndef RTJAX_SORT_LOOK
#define RTJAX_SORT_LOOK 4
#endif
// 1: each pass launches as a programmatic dependent of the kernel before
// it (csrc/key_sort.cu), 0: in plain stream order
#ifndef RTJAX_SORT_PDL
#define RTJAX_SORT_PDL 1
#endif

namespace rtjax_sort {

constexpr int kBlock = 256;   // threads a block, every kernel
constexpr int kWarps = kBlock / 32;
constexpr int kBits = 8;      // a digit: four passes over the 32 bits
constexpr int kRadix = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kItems = RTJAX_SORT_ITEMS;
constexpr int kTile = kBlock * kItems;   // keys a pass's block ranks
constexpr int kUpItems = RTJAX_SORT_UP_ITEMS;
static_assert(kRadix == kBlock, "a pass's thread owns one digit");

__host__ __device__ inline int num_tiles(int n) {
  return (n + kTile - 1) / kTile;
}
__host__ __device__ inline int upsweep_blocks(int n) {
  return (n + kBlock * kUpItems - 1) / (kBlock * kUpItems);
}

// int32 keys in torch's order as unsigned words: the sign bit flipped
__host__ __device__ inline unsigned flip(int key) {
  return static_cast<unsigned>(key) ^ 0x80000000u;
}
// the digit of pass p
__host__ __device__ inline unsigned digit(unsigned u, int pass) {
  return (u >> (pass * kBits)) & static_cast<unsigned>(kRadix - 1);
}

// Item k of lane l of warp w of a tile: a warp owns kItems * 32
// consecutive keys and takes them 32 at a time, so that ranking the items
// in turn, the lanes of one item in order and the warps in order is the
// tile's order (stability).
__host__ __device__ inline int item_offset(int warp, int item, int lane) {
  return (warp * kItems + item) * 32 + lane;
}

__host__ __device__ inline int popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// A key's rank among its warp's keys of the same digit: the count the warp
// had before this item (``before``) and the peers of lower lanes in it
// (``peers``: the lanes holding the same digit)
__host__ __device__ inline int warp_rank(int before, unsigned peers,
                                         int lane) {
  return before +
         popc(peers & ((lane == 0) ? 0u : (0xFFFFFFFFu >> (32 - lane))));
}
// the lane that adds the item's peers to the warp's count: the highest
__host__ __device__ inline int leader(unsigned peers) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(peers);
#else
  return 31 - __builtin_clz(peers);
#endif
}

// The look-back's status words, one per (pass, tile, digit): 0 while the
// tile has published nothing, then its count of the digit (kAggregate),
// then the count of the digit over it and every earlier tile (kPrefix).
// The flag and the 30-bit value are one 32-bit word, so they cannot tear.
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kPrefix = 2u << 30;
constexpr unsigned kValue = kAggregate - 1;
constexpr long long kMaxKeys = kValue;   // the most keys a sort takes

__host__ __device__ inline unsigned status_word(unsigned flag,
                                                unsigned value) {
  return flag | value;
}

// One step of a digit's look-back over the status words ``w`` of kLook
// tiles, the nearest first (a tile before the first reads as a prefix of
// 0): adds their counts to ``before`` up to the first prefix and returns
// -1 when a prefix ended the walk, else how many tiles to step back
// (kLook past aggregates only; fewer to read again a word not yet
// published, where the walk waits)
constexpr int kLook = RTJAX_SORT_LOOK;
__host__ __device__ inline int lookback_step(const unsigned* w,
                                             unsigned& before) {
  int back = kLook;
  bool found = false;
#pragma unroll
  for (int q = 0; q < kLook; ++q) {
    if (back == kLook && !found) {
      if (w[q] == 0) {
        back = q;
      } else {
        before += w[q] & kValue;
        found = (w[q] & kPrefix) != 0;
      }
    }
  }
  return found ? -1 : back;
}

// Whether the iteration sorts (kernels/step.py cadence and step_math.cuh
// cadence): always without a cadence (``counts`` null or sort_every <= 1),
// else every k-th iteration, or when the continuing paths fall below 3/4
__host__ __device__ inline bool cadence(const long long* counts,
                                        const long long* it,
                                        long long it_value, int sort_every,
                                        long long n) {
  if (counts == nullptr || sort_every <= 1) return true;
  const long long i = it ? *it : it_value;
  const long long rem = i % sort_every;
  return counts[0] * 4 < n * 3 || (rem < 0 ? rem + sort_every : rem) == 0;
}

// The scratch (kernels/sort.py allocates it): each pass's digit
// histogram, one ticket a pass and the status words (passes x tiles x
// digits), which each launch zeroes first; then the two ping-pong arrays
// of (key, index) pairs, 8 bytes a key, 16-byte aligned.
struct Layout {
  long long hist, tickets, status, zeroed, pairs0, pairs1, total;
};
__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}
__host__ __device__ inline Layout layout(int n) {
  Layout l;
  l.hist = 0;
  l.tickets = l.hist + 4LL * kPasses * kRadix;
  l.status = l.tickets + 4LL * kPasses;
  l.zeroed = align16(l.status + 4LL * kPasses * num_tiles(n) * kRadix);
  l.pairs0 = l.zeroed;
  l.pairs1 = l.pairs0 + align16(8LL * n);
  l.total = l.pairs1 + align16(8LL * n);
  return l;
}

}  // namespace rtjax_sort
