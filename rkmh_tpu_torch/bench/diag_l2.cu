// A diagnostic for the depth map's layout (K8, K9: csrc/hashmap.cuh),
// built and launched only by bench/l2_sweep.py: random loads from a table
// of a given footprint, one query a thread, the addresses made in the
// kernel from a hash of the query's index, so that what is timed is the
// loads alone.  Swept over footprints around the card's 50 MB L2, it
// shows how large a table that every SM reads at random can be and still
// be served from the L2.
//
// Modes: 0, one 16-byte load a query; 1, two independent 16-byte loads a
// query (the cuckoo map's two probes); 2, two dependent 8-byte loads a
// query (a directory word, then a word whose address the first one's
// value gives: the sorted map's probe).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDULL;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ULL;
  x ^= x >> 33;
  return x;
}

__global__ void random_loads_kernel(const int4* __restrict__ table, uint64_t entries,
                                    int64_t n, int mode, uint64_t seed,
                                    uint32_t* __restrict__ sink) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t h = mix((uint64_t)i ^ seed);
  uint32_t acc;
  if (mode == 0) {
    const int4 e = __ldg(table + h % entries);
    acc = e.x ^ e.w;
  } else if (mode == 1) {
    const int4 e1 = __ldg(table + h % entries);
    const int4 e2 = __ldg(table + (h >> 32) % entries);
    acc = e1.x ^ e2.w;
  } else {
    const uint64_t* words = reinterpret_cast<const uint64_t*>(table);
    const uint64_t w1 = __ldg(words + h % (2 * entries));
    const uint64_t w2 = __ldg(words + mix(w1 ^ h) % (2 * entries));
    acc = (uint32_t)w2;
  }
  if (acc == 0x9E3779B1u) sink[0] = acc;  // keeps the loads; almost never stores
}

}  // namespace

// n queries against a table of `entries` 16-byte entries (mode above);
// sink [1] uint32 is written only when a loaded value happens to equal a
// fixed constant.  Requires n >= 1, entries >= 1.
extern "C" int rkmh_diag_random_loads(const int32_t* table, long long entries, long long n,
                                      int mode, unsigned long long seed, int32_t* sink,
                                      cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  random_loads_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const int4*>(table), (uint64_t)entries, (int64_t)n, mode,
      (uint64_t)seed, reinterpret_cast<uint32_t*>(sink));
  return (int)cudaGetLastError();
}
