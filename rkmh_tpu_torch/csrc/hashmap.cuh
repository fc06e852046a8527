// The exact depth map's probe, shared by K8 (hashmap.cu) and K9
// (call_scan.cu).
//
// The map is ops/hashmap.py's SortedMap: the n keys sorted (unsigned)
// under a directory of their top B bits.  Bucket b's entries are
// [dir[b], dir[b+1]); entry i is one 64-bit word, key i's low 64 - B bits
// over a B-bit count (key << B | count), so a bucket's words are sorted
// as its keys are.  A count of 2^B - 1 means "the value is in the
// overflow": ov_keys [m] (sorted) and ov_values [m].  Key 0 is a real key
// (every invalid read k-mer counts under hash 0).
//
// What it costs: two dependent loads into a structure of ~10n bytes (21
// MB at call's 2.1M keys), which stays in the L2 that every SM reads at
// random up to ~24 MB (bench/l2_sweep.py): the directory pair (8 bytes,
// one sector but for 1 bucket in 8), then the bucket's words (2 to 4 on
// average, usually one sector).

#pragma once

#include <cstdint>

namespace rkmh {

struct MapView {
  const uint64_t* words;
  const int32_t* dir;
  const uint64_t* ov_keys;
  const int32_t* ov_values;
  int m;
  int bits;
};

// The value of key h, or 0 where the map does not hold it.
__device__ __forceinline__ int32_t map_get(const MapView& mp, uint64_t h) {
  const uint32_t b = (uint32_t)(h >> (64 - mp.bits));
  const int lo = __ldg(mp.dir + b), hi = __ldg(mp.dir + b + 1);
  const uint64_t cmask = (1ULL << mp.bits) - 1;
  const uint64_t want = h << mp.bits;
  for (int i = lo; i < hi; ++i) {
    const uint64_t w = __ldg(mp.words + i);
    const uint64_t key = w & ~cmask;
    if (key < want) continue;
    if (key != want) return 0;
    const uint32_t c = (uint32_t)(w & cmask);
    if (c != cmask) return (int32_t)c;
    // the overflow, sorted: binary search for h
    int a = 0, z = mp.m;
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (__ldg(mp.ov_keys + mid) < h) a = mid + 1;
      else z = mid;
    }
    return a < mp.m ? __ldg(mp.ov_values + a) : 0;
  }
  return 0;
}

}  // namespace rkmh
