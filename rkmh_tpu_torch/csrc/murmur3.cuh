// Device code shared by the kernels that hash k-mers: the body, tail and
// finaliser of MurmurHash3_x64_128 (h1, the 64 bits rkmh keeps), and the
// canonical k-mer of a window hashed byte by byte.
//
// K1 (window_hash.cu) hashes reference and read windows with it, and K9
// (call_scan.cu) the mutated k-mers of the variant scan, so both choose
// the strand and hash the same bytes.  A window's codes are read through
// `c[p]`, p in [0, k): a pointer into a staged tile (K1) or an accessor
// that builds a mutated k-mer on the fly (K9).

#pragma once

#include <cstdint>

namespace rkmh {

constexpr uint64_t C1 = 0x87C37B91114253D5ULL;
constexpr uint64_t C2 = 0x4CF5AD432745937FULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDULL;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ULL;
  k ^= k >> 33;
  return k;
}

// One 16-byte block of the murmur body.
__device__ __forceinline__ void murmur_block(uint64_t& h1, uint64_t& h2, uint64_t k1,
                                             uint64_t k2) {
  k1 *= C1; k1 = rotl64(k1, 31); k1 *= C2;
  h1 ^= k1;
  h1 = rotl64(h1, 27); h1 += h2;
  h1 = h1 * 5 + 0x52DCEFB5ULL;
  k2 *= C2; k2 = rotl64(k2, 33); k2 *= C1;
  h2 ^= k2;
  h2 = rotl64(h2, 31); h2 += h1;
  h2 = h2 * 5 + 0x38495AB5ULL;
}

// The tail (tl = k % 16 bytes in words t1, t2) and the finaliser -> h1.
__device__ __forceinline__ uint64_t murmur_finish(uint64_t h1, uint64_t h2, int k,
                                                  uint64_t t1, uint64_t t2) {
  const int tl = k & 15;
  if (tl >= 9) {
    t2 *= C2; t2 = rotl64(t2, 33); t2 *= C1;
    h2 ^= t2;
  }
  if (tl >= 1) {
    t1 *= C1; t1 = rotl64(t1, 31); t1 *= C2;
    h1 ^= t1;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// Byte p of the canonical k-mer of the window c.
template <class Codes>
__device__ __forceinline__ uint64_t canon_byte(const Codes& c, int k, bool fwd, int p) {
  const uint8_t code = fwd ? c[p] : (uint8_t)(3 - c[k - 1 - p]);
  return code == 0 ? 65 : code == 1 ? 67 : code == 2 ? 71 : 84;  // A C G T
}

// Little-endian word of canonical bytes [p0, min(p0 + 8, k)).
template <class Codes>
__device__ __forceinline__ uint64_t canon_word(const Codes& c, int k, bool fwd, int p0) {
  uint64_t w = 0;
  const int n = min(8, k - p0);
  for (int j = 0; j < n; ++j) w |= canon_byte(c, k, fwd, p0 + j) << (8 * j);
  return w;
}

// The hash of the window c of k codes, byte by byte: 0 if any code is
// >= 4, else h1 of the ASCII bytes of the lexicographically smaller of
// the k-mer and its reverse complement (a tie goes to the forward strand).
template <class Codes>
__device__ __forceinline__ uint64_t hash_window_bytewise(const Codes& c, int k,
                                                         uint64_t seed) {
  for (int p = 0; p < k; ++p) {
    if (c[p] >= 4) return 0;
  }
  // forward <= reverse complement, decided at the first position (from
  // the outside in) where the two strands differ
  bool fwd = true;
  for (int p = 0; p < k; ++p) {
    const uint8_t a = c[p];
    const uint8_t b = 3 - c[k - 1 - p];
    if (a != b) {
      fwd = a < b;
      break;
    }
  }
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int i = 0; i < nblocks; ++i)
    murmur_block(h1, h2, canon_word(c, k, fwd, 16 * i), canon_word(c, k, fwd, 16 * i + 8));
  const int tl = k - 16 * nblocks;
  return murmur_finish(h1, h2, k, tl >= 1 ? canon_word(c, k, fwd, 16 * nblocks) : 0,
                       tl >= 9 ? canon_word(c, k, fwd, 16 * nblocks + 8) : 0);
}

}  // namespace rkmh
