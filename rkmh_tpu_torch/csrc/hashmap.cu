// K8: the exact depth map's lookup, [N] uint64 keys -> [N] int32 values.
//
// Replaces rkmh_tpu/ops/hashmap.py::hashmap_get (an XLA chain of two
// gathers of hi, lo, used and value each, and selects).  `call` queries
// its read-depth map with it at every reference position (the positional
// depth); K9 probes the same map from inside its scan (hashmap.cuh).
//
// What bounds it on the card: the map's random loads.  A query reads its
// 8-byte key and writes 4 bytes, coalesced, and between them makes two
// dependent random loads into the map (the directory pair, then its
// bucket's words; hashmap.cuh).  The map is laid out to stay in the L2 at
// call's size, so those loads run at the L2's random-access rate.  One
// thread a query.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hashmap.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

__global__ void __launch_bounds__(THREADS) hashmap_get_kernel(
    const uint64_t* __restrict__ keys, int64_t n, rkmh::MapView mp, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = rkmh::map_get(mp, __ldg(keys + i));
}

}  // namespace

// keys [n] uint64; the map: words [N] uint64, dir [2^bits + 1] int32,
// ov_keys [m] uint64, ov_values [m] int32 (hashmap.cuh) -> out [n] int32.
// Requires n >= 1 and 1 <= bits <= 31.
extern "C" int rkmh_hashmap_get(const int64_t* keys, long long n, const int64_t* words,
                                const int32_t* dir, const int64_t* ov_keys,
                                const int32_t* ov_values, int m, int bits, int32_t* out,
                                cudaStream_t stream) {
  const int64_t blocks = std::min<int64_t>((n + THREADS - 1) / THREADS, MAX_BLOCKS);
  const rkmh::MapView mp{reinterpret_cast<const uint64_t*>(words), dir,
                         reinterpret_cast<const uint64_t*>(ov_keys), ov_values, m, bits};
  hashmap_get_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const uint64_t*>(keys), (int64_t)n, mp, out);
  return (int)cudaGetLastError();
}
