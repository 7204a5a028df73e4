// The stable key sort's launch logic on the host, over the arithmetic of
// rtjax_torch/csrc/key_sort.cuh compiled as C++ (tests/
// test_torch_key_sort.py builds it with g++ and binds it with
// kernels/sort.py ``bind``, so that the real ctypes wrapper runs it on CPU
// tensors).  It exports the library's entry points and runs what the
// kernels run, serially: the scratch's counters zeroed, the cadence, the
// upsweep thread by thread (a run of equal digits added once), then each
// pass tile by tile in ticket order with the kernels' tile and digit
// sizes: the warps' ballots of digit bits, the ranks within a warp, the
// warps' counters made exclusive, the status words published and read
// back by the look-back, the digits' offsets scanned from the histogram,
// the tile staged in sorted order and scattered.
#include <cstring>
#include <vector>
#define __host__
#define __device__
#include "key_sort.cuh"
using namespace rtjax_sort;

namespace {

constexpr int kNotOnCard = 1;   // kernel info: no card here
constexpr int kBadArgs = 2;
constexpr int kLookBack = 3;    // a status word read before it was written

// the ballots of peers_of (csrc/key_sort.cu): lane l's peers among ``d``
unsigned peers_of(const unsigned* d, const bool* valid, int lane) {
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= valid[l] ? 1u << l : 0u;
  for (int b = 0; b < kBits; ++b) {
    unsigned v = 0;
    for (int l = 0; l < 32; ++l) v |= ((d[l] >> b) & 1u) ? 1u << l : 0u;
    m &= ((d[lane] >> b) & 1u) ? v : ~v;
  }
  return m;
}

void upsweep(const int* keys, int n, unsigned* hist) {
  for (int blk = 0; blk < upsweep_blocks(n); ++blk)
    for (int t = 0; t < kBlock; ++t) {
      unsigned u[kUpItems];
      int valid = 0;
      for (int k = 0; k < kUpItems; ++k) {
        const long long i = static_cast<long long>(blk) * kBlock * kUpItems +
                            k * kBlock + t;
        u[k] = i < n ? flip(keys[i]) : 0u;
        valid += i < n;
      }
      for (int p = 0; p < kPasses; ++p) {
        unsigned cur = digit(u[0], p), run = 0;
        for (int k = 0; k < valid; ++k) {
          const unsigned d = digit(u[k], p);
          if (d != cur) {
            hist[p * kRadix + cur] += run;
            cur = d;
            run = 0;
          }
          ++run;
        }
        if (run != 0) hist[p * kRadix + cur] += run;
      }
    }
}

int pass(const int* keys, long long* order, unsigned char* s, int n, int p) {
  const Layout l = layout(n);
  const int r = kRadix, items = kItems, tile = kTile;
  const int tiles = num_tiles(n);
  const bool last = p == kPasses - 1;
  // (key, index) pairs, 8 bytes each
  const unsigned* in = reinterpret_cast<const unsigned*>(
      s + ((p & 1) ? l.pairs0 : l.pairs1));
  unsigned* out = reinterpret_cast<unsigned*>(s + ((p & 1) ? l.pairs1
                                                           : l.pairs0));
  const unsigned* hist = reinterpret_cast<const unsigned*>(s + l.hist) + p * r;
  unsigned* ticket = reinterpret_cast<unsigned*>(s + l.tickets) + p;
  unsigned* status = reinterpret_cast<unsigned*>(s + l.status) +
                     static_cast<long long>(p) * tiles * r;
  std::vector<unsigned> key(tile), skey(tile), count(r);
  std::vector<int> idx(tile), rank(tile), sidx(tile), tstart(r), base(r);
  std::vector<unsigned short> cnt(kWarps * r);
  for (int b = 0; b < tiles; ++b) {
    const int t = static_cast<int>((*ticket)++);
    const long long first = static_cast<long long>(t) * tile;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < items; ++k) {
        unsigned d[32];
        bool valid[32];
        int before[32];
        for (int ln = 0; ln < 32; ++ln) {
          const int o = item_offset(w, k, ln);
          const long long i = first + o;
          valid[ln] = i < n;
          key[o] = valid[ln] ? (p == 0 ? flip(keys[i]) : in[2 * i]) : 0u;
          idx[o] = valid[ln] ? (p == 0 ? static_cast<int>(i)
                                       : static_cast<int>(in[2 * i + 1]))
                             : 0;
          d[ln] = digit(key[o], p);
          before[ln] = valid[ln] ? cnt[w * r + d[ln]] : 0;
        }
        for (int ln = 0; ln < 32; ++ln) {
          const unsigned peers = peers_of(d, valid, ln);
          if (valid[ln] && ln == leader(peers))
            cnt[w * r + d[ln]] =
                static_cast<unsigned short>(before[ln] + popc(peers));
          rank[item_offset(w, k, ln)] = warp_rank(before[ln], peers, ln);
        }
      }
    for (int d = 0; d < r; ++d) {
      unsigned sum = 0;
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = cnt[w * r + d];
        cnt[w * r + d] = static_cast<unsigned short>(sum);
        sum += c;
      }
      count[d] = sum;
      status[static_cast<long long>(t) * r + d] =
          status_word(t == 0 ? kPrefix : kAggregate, sum);
    }
    unsigned in_tile = 0, global = 0;
    for (int d = 0; d < r; ++d) {
      unsigned before = 0;
      if (t > 0) {
        for (int j = t - 1;;) {
          unsigned w[kLook];
          for (int q = 0; q < kLook; ++q)
            w[q] = j - q >= 0 ? status[static_cast<long long>(j - q) * r + d]
                              : kPrefix;
          const int back = lookback_step(w, before);
          if (back < 0) break;
          if (back < kLook) return kLookBack;   // all are published here
          j -= back;
        }
        status[static_cast<long long>(t) * r + d] =
            status_word(kPrefix, before + count[d]);
      }
      tstart[d] = static_cast<int>(in_tile);
      base[d] = static_cast<int>(global + before) -
                static_cast<int>(in_tile);
      in_tile += count[d];
      global += hist[d];
    }
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < items; ++k)
        for (int ln = 0; ln < 32; ++ln) {
          const int o = item_offset(w, k, ln);
          if (first + o >= n) continue;
          const unsigned d = digit(key[o], p);
          const int at = tstart[d] + cnt[w * r + d] + rank[o];
          skey[at] = key[o];
          sidx[at] = idx[o];
        }
    const long long left = n - first;
    const int tile_n = left < tile ? static_cast<int>(left) : tile;
    for (int j = 0; j < tile_n; ++j) {
      const long long dst = base[digit(skey[j], p)] + j;
      if (last) {
        order[dst] = sidx[j];
      } else {
        out[2 * dst] = skey[j];
        out[2 * dst + 1] = static_cast<unsigned>(sidx[j]);
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" long long rtjax_key_sort_scratch_bytes(int n) {
  return layout(n).total;
}

extern "C" int rtjax_key_sort(const int* keys, long long* order,
                              void* scratch, int n, const long long* counts,
                              const long long* it, long long it_value,
                              int sort_every, unsigned long long* tally,
                              void*) {
  if (n <= 0) return 0;
  if (n > kMaxKeys) return kBadArgs;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  const Layout l = layout(n);
  std::memset(s, 0, l.zeroed);
  const bool full = cadence(counts, it, it_value, sort_every, n);
  if (tally != nullptr) tally[full ? 0 : 1] += 1;
  if (!full) return 0;
  upsweep(keys, n, reinterpret_cast<unsigned*>(s + l.hist));
  for (int p = 0; p < kPasses; ++p) {
    const int rc = pass(keys, order, s, n, p);
    if (rc != 0) return rc;
  }
  return 0;
}

extern "C" int rtjax_key_sort_kernel_info(int, int*, int*, int*, int*) {
  return kNotOnCard;
}
