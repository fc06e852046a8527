// K8: the exact cuckoo map's lookup, [N] uint64 keys -> [N] int32 values.
//
// Replaces rkmh_tpu/ops/hashmap.py::hashmap_get (an XLA chain of two
// gathers of hi, lo, used and value each, and selects).  `call` queries
// its read-depth map with it at every reference position (the positional
// depth); K9 probes the same map from inside its scan (hashmap.cuh).
//
// What bounds it on the card: bytes.  A query reads its 8-byte key, two
// 16-byte slots at random and writes 4 bytes; it does a few integer
// operations.  One thread a query, both slot loads in flight before
// either compare, keys and outputs coalesced.  The random slot loads are
// what remains: a map larger than the 50 MB L2 pays a DRAM sector (32
// bytes) for each.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hashmap.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

__global__ void __launch_bounds__(THREADS) hashmap_get_kernel(
    const uint64_t* __restrict__ keys, int64_t n, const int4* __restrict__ table,
    uint32_t mask, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = rkmh::map_get(table, mask, keys[i]);
}

}  // namespace

// keys [n] uint64, table [T, 4] int32 (hi, lo, value, used; 16-byte
// aligned, T a power of two <= 2^32) -> out [n] int32.  Requires n >= 1.
extern "C" int rkmh_hashmap_get(const int64_t* keys, long long n, const int32_t* table,
                                long long T, int32_t* out, cudaStream_t stream) {
  const int64_t blocks = std::min<int64_t>((n + THREADS - 1) / THREADS, MAX_BLOCKS);
  hashmap_get_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const uint64_t*>(keys), (int64_t)n,
      reinterpret_cast<const int4*>(table), (uint32_t)(T - 1), out);
  return (int)cudaGetLastError();
}
