// The exact cuckoo map's two-probe lookup, shared by K8 (hashmap.cu) and
// K9 (call_scan.cu).
//
// The map is rkmh_tpu/ops/hashmap.py's HashMap laid out as one int4 a slot
// (hi, lo, value, used) in a table of T slots, T a power of two, so that a
// probe is one 16-byte load.  A key's two slots are those of
// hashmap.py:167-170, in uint32 arithmetic: ((lo ^ M1) * M1) & (T - 1) and
// ((hi ^ M2) * M2) & (T - 1).  A slot holds the key when its used flag is
// set and both halves match: key 0 is a real key (every invalid read
// k-mer counts under hash 0), so emptiness is the flag alone.

#pragma once

#include <cstdint>

namespace rkmh {

constexpr uint32_t MAP_MUL1 = 0x9E3779B1u;
constexpr uint32_t MAP_MUL2 = 0x85EBCA77u;

// The value of key h, or 0 where the map does not hold it.  mask = T - 1.
__device__ __forceinline__ int32_t map_get(const int4* __restrict__ table, uint32_t mask,
                                           uint64_t h) {
  const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32);
  const uint32_t s1 = ((lo ^ MAP_MUL1) * MAP_MUL1) & mask;
  const uint32_t s2 = ((hi ^ MAP_MUL2) * MAP_MUL2) & mask;
  // both loads issued before either compare
  const int4 e1 = __ldg(table + s1);
  const int4 e2 = __ldg(table + s2);
  int32_t out = 0;
  if (e1.w && (uint32_t)e1.x == hi && (uint32_t)e1.y == lo) out = e1.z;
  if (e2.w && (uint32_t)e2.x == hi && (uint32_t)e2.y == lo) out = e2.z;
  return out;
}

}  // namespace rkmh
