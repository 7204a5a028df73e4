// The stable key sort's arithmetic (csrc/key_sort.cu; kernels/sort.py):
// the keys' order-preserving map to unsigned words, the digits of each
// pass, a tile's geometry, the ranks within a warp, the tickets and launch
// parity of the persistent scratch, the look-back's status words, the
// sort_every cadence and the scratch's layout; the first design's status
// words and layout in namespace v1.  Every function is
// __host__ __device__, so that tests/key_sort_host.cpp compiles them as
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

// The persistent scratch's tickets.  Every kernel of a sorting launch
// takes one ticket a block (the upsweep or a pass's tile) from its
// counter by atomicInc with the limit ticket_limit(count): the counter
// runs over [0, 2 * count), so that a launch takes [0, count) and the next
// [count, 2 * count), then it wraps to 0.  The launch's parity (0 or 1)
// and the block's or tile's index follow from the ticket; since every
// sorting launch on a scratch takes each counter's ``count`` tickets,
// every kernel of one launch reads the same parity, and two consecutive
// launches read different ones.
__host__ __device__ inline unsigned ticket_limit(int count) {
  return 2u * static_cast<unsigned>(count) - 1u;
}
__host__ __device__ inline unsigned launch_parity(unsigned ticket,
                                                  int count) {
  return ticket >= static_cast<unsigned>(count) ? 1u : 0u;
}
__host__ __device__ inline int ticket_index(unsigned ticket, int count) {
  return static_cast<int>(ticket) - (ticket >= static_cast<unsigned>(count)
                                         ? count : 0);
}

// The look-back's status words, one per (pass, tile, digit), never
// zeroed: bit 31 the tag of the launch that wrote it, bit 30 set on a
// prefix (the digit's count over the tile and every earlier one), else
// an aggregate (the tile's own count), bits 0-29 the count.  A launch of
// parity q writes the tag q ^ 1 (status_tag), so the zeroed words of a
// fresh scratch and every word of the launch before read as not
// published.  One 32-bit word: tag, flag and count cannot tear.
constexpr unsigned kTagBit = 1u << 31;
constexpr unsigned kPrefixBit = 1u << 30;
constexpr unsigned kValue = kPrefixBit - 1;
constexpr long long kMaxKeys = kValue;   // the most keys a sort takes

__host__ __device__ inline unsigned status_tag(unsigned parity) {
  return parity ? 0u : kTagBit;
}
__host__ __device__ inline unsigned status_word(unsigned parity,
                                                bool prefix,
                                                unsigned value) {
  return status_tag(parity) | (prefix ? kPrefixBit : 0u) | value;
}
__host__ __device__ inline bool published(unsigned w, unsigned parity) {
  return (w & kTagBit) == status_tag(parity);
}

// One step of a digit's look-back over the status words ``w`` of kLook
// tiles, the nearest first (a tile before the first reads as a published
// prefix of 0): adds their counts to ``before`` up to the first prefix
// and returns -1 when a prefix ended the walk, else how many tiles to
// step back (kLook past aggregates only; fewer to read again a word
// not yet published, where the walk waits)
constexpr int kLook = RTJAX_SORT_LOOK;
__host__ __device__ inline int lookback_step(const unsigned* w,
                                             unsigned parity,
                                             unsigned& before) {
  int back = kLook;
  bool found = false;
#pragma unroll
  for (int q = 0; q < kLook; ++q) {
    if (back == kLook && !found) {
      if (!published(w[q], parity)) {
        back = q;
      } else {
        before += w[q] & kValue;
        found = (w[q] & kPrefixBit) != 0;
      }
    }
  }
  return found ? -1 : back;
}

// Whether the iteration sorts (kernels/step.py cadence and step_math.cuh
// cadence): always without a cadence (``counts`` null or sort_every <= 1),
// else every k-th iteration, or when the continuing paths fall below 3/4.
// The condition of the if node a captured step puts the sort under.
__host__ __device__ inline bool cadence(const long long* counts,
                                        const long long* it,
                                        long long it_value, int sort_every,
                                        long long n) {
  if (counts == nullptr || sort_every <= 1) return true;
  const long long i = it ? *it : it_value;
  const long long rem = i % sort_every;
  return counts[0] * 4 < n * 3 || (rem < 0 ? rem + sort_every : rem) == 0;
}

// The persistent scratch (kernels/sort.py makes one a card and size,
// zeroed once): the counters (the upsweep's ticket, then each pass's),
// two planes of every pass's digit histogram (a launch of parity q adds
// to plane q and zeroes plane q ^ 1 for the next), the status words
// (passes x tiles x digits); then the two ping-pong arrays of (key,
// index) pairs, 8 bytes a key, 16-byte aligned.
constexpr int kUpTicket = 0;   // counters: the upsweep's, then pass p's
constexpr int kCounters = 8;   // at 1 + p
struct Layout {
  long long counters, hist, status, pairs0, pairs1, total;
};
__host__ __device__ inline long long align16(long long b) {
  return (b + 15) / 16 * 16;
}
__host__ __device__ inline long long plane_words() {
  return static_cast<long long>(kPasses) * kRadix;
}
__host__ __device__ inline Layout layout(int n) {
  Layout l;
  l.counters = 0;
  l.hist = l.counters + 4LL * kCounters;
  l.status = l.hist + 4LL * 2 * plane_words();
  l.pairs0 = align16(l.status + 4LL * kPasses * num_tiles(n) * kRadix);
  l.pairs1 = l.pairs0 + align16(8LL * n);
  l.total = l.pairs1 + align16(8LL * n);
  return l;
}

// the first design (rtjax_key_sort_v1, kept for timing in turns): a fresh
// scratch a launch whose counters a memset zeroes, 16 keys a thread in the
// upsweep, a look-back a tile, status words 0 until published.
namespace v1 {

constexpr int kItems = 8, kTile = kBlock * kItems, kUpItems = 16;
__host__ __device__ inline int num_tiles(int n) {
  return (n + kTile - 1) / kTile;
}
__host__ __device__ inline int upsweep_blocks(int n) {
  return (n + kBlock * kUpItems - 1) / (kBlock * kUpItems);
}
__host__ __device__ inline int item_offset(int warp, int item, int lane) {
  return (warp * kItems + item) * 32 + lane;
}

// 0 while the tile has published nothing, then its count of the digit
// (kAggregate), then the count over it and every earlier tile (kPrefix)
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kPrefix = 2u << 30;

__host__ __device__ inline unsigned status_word(unsigned flag,
                                                unsigned value) {
  return flag | value;
}

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

// each pass's histogram, one ticket a pass and the status words (passes x
// tiles x digits), which each launch zeroes first; then the pairs
struct Layout {
  long long hist, tickets, status, zeroed, pairs0, pairs1, total;
};
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

}  // namespace v1

}  // namespace rtjax_sort
