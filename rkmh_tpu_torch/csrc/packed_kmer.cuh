// Device code shared by the kernels that hash k-mers of k <= 32 from a
// packed span of codes: K1's packed route (window_hash.cu) and K9's
// (call_scan.cu), so both choose the strand and hash the same bytes.
//
// A block packs a span of its codes with three ballots a warp
// (pack_span): the 2-bit codes, first base in the most significant bits
// (code 32i+j at bits 63-2j, 62-2j of word i), and a bitmask of the
// invalid positions (bit j of word i: code 32i+j >= 4).  A k-mer's
// forward key is then the 2k bits at bit 2p, left-aligned (packed_key),
// its validity "the k mask bits at p are all zero" (packed_bad), and its
// reverse complement comes from the key itself (reverse the 2-bit groups
// with a bit reversal and a pair swap, then complement).  A=0 < C=1 < G=2
// < T=3 is the order of the ASCII bytes, so `fwd <= rc` as integers is
// exactly the outside-in byte compare.  The ASCII words of the canonical
// key come from a 256-entry table in shared memory that maps 4 bases to
// 4 ASCII bytes (init_ascii4): ceil(k/4) lookups.

#pragma once

#include <cstdint>

#include "murmur3.cuh"

namespace rkmh {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// 32-bit x -> 64 bits with bit j of x at bit 2j.
__device__ __forceinline__ uint64_t spread_bits(uint32_t v) {
  uint64_t x = v;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2)) & 0x3333333333333333ULL;
  x = (x | (x << 1)) & 0x5555555555555555ULL;
  return x;
}

// The block of NT threads packs codes [0, span) of src into fwd and bad
// (span + 31) / 32 words each; past the span a code reads as invalid.
// Every thread of the block calls it (its loop bound is warp-uniform, so
// every lane takes part in the ballots); the caller synchronises after it.
// NT is a template parameter so that the loop's stride is a constant.
template <int NT>
__device__ __forceinline__ void pack_span(const uint8_t* __restrict__ src, int span,
                                          uint64_t* fwd, uint32_t* bad) {
  const int lane = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 32; base < span; base += NT) {
    const int j = base + lane;
    const uint32_t c = j < span ? src[j] : 255u;
    const uint32_t b0 = __ballot_sync(FULL_MASK, c & 1u);
    const uint32_t b1 = __ballot_sync(FULL_MASK, c & 2u);
    const uint32_t bd = __ballot_sync(FULL_MASK, c >= 4u);
    if (lane == 0) {
      // lane j's high bit to 2j, low bit to 2j + 1, then reverse: 63-2j, 62-2j
      fwd[base >> 5] = __brevll(spread_bits(b1) | (spread_bits(b0) << 1));
      bad[base >> 5] = bd;
    }
  }
}

// ascii4[i]: the 4 bases of i (first in bits 7-6) as 4 little-endian ASCII
// bytes, filled by a block of 256 threads, one entry each.
__device__ __forceinline__ void init_ascii4(uint32_t* ascii4) {
  const uint32_t t = threadIdx.x;
  uint32_t a = 0;
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = (t >> (6 - 2 * j)) & 3u;
    a |= (c == 0 ? 65u : c == 1 ? 67u : c == 2 ? 71u : 84u) << (8 * j);  // A C G T
  }
  ascii4[t] = a;
}

// The k mask bits of the k-mer at code p (bit i: code p + i is invalid).
template <int k>
__device__ __forceinline__ uint32_t packed_bad(const uint32_t* bad, int p) {
  const uint32_t kmask = k == 32 ? FULL_MASK : (1u << (k & 31)) - 1u;
  return __funnelshift_r(bad[p >> 5], bad[(p >> 5) + 1], p & 31) & kmask;
}

// The forward key of the k-mer at code p, left-aligned: the 2k bits at
// bit 2p, the rest cleared.
template <int k>
__device__ __forceinline__ uint64_t packed_key(const uint64_t* fwd, int p) {
  const int s = (2 * p) & 63, i = (2 * p) >> 6, drop = 64 - 2 * k;
  const uint64_t x = (fwd[i] << s) | ((fwd[i + 1] >> 1) >> (63 - s));
  return (x >> drop) << drop;
}

// h1 of the valid k-mer whose left-aligned forward key is x.
template <int k>
__device__ __forceinline__ uint64_t hash_packed_key(uint64_t x, const uint32_t* ascii4,
                                                    uint64_t seed) {
  constexpr int drop = 64 - 2 * k;
  // reverse complement, left-aligned: bit reversal puts base j at bits
  // 2j, 2j+1 with its two bits swapped; swap them back, complement the 2k
  // live bits, realign
  uint64_t rc = __brevll(x);
  rc = ((rc >> 1) & 0x5555555555555555ULL) | ((rc & 0x5555555555555555ULL) << 1);
  rc = (rc ^ (~0ULL >> drop)) << drop;
  const uint64_t canon = x <= rc ? x : rc;

  // little-endian ASCII words of the canonical k-mer, zero past byte k
  uint64_t wd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int nb = k - 4 * g;  // bases of group g
    if (nb > 0) {
      uint32_t a = ascii4[(canon >> (56 - 8 * g)) & 0xFF];
      if (nb < 4) a &= (1u << (8 * nb)) - 1u;
      wd[g >> 1] |= (uint64_t)a << (32 * (g & 1));
    }
  }
  uint64_t h1 = seed, h2 = seed;
  constexpr int nblocks = k >> 4;  // 0, 1 or 2
  if (nblocks >= 1) murmur_block(h1, h2, wd[0], wd[1]);
  if (nblocks >= 2) murmur_block(h1, h2, wd[2], wd[3]);
  return nblocks == 0 ? murmur_finish(h1, h2, k, wd[0], wd[1])
                      : murmur_finish(h1, h2, k, wd[2], wd[3]);
}

// h1 of the k-window at code p of a packed span; 0 if any code is invalid.
template <int k>
__device__ __forceinline__ uint64_t hash_packed_window(const uint64_t* fwd, const uint32_t* bad,
                                                       const uint32_t* ascii4, int p,
                                                       uint64_t seed) {
  if (packed_bad<k>(bad, p)) return 0;
  return hash_packed_key<k>(packed_key<k>(fwd, p), ascii4, seed);
}

}  // namespace rkmh
