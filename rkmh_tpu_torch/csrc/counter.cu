// K6 and K7: the lossy hash % size k-mer depth counter (rkmh's HASHTCounter).
//
// K6 counter_add replaces rkmh_tpu/ops/counter.py::counter_add (:37), the
// scatter-add table.at[h % size].add(mask).  K7 counter_mask replaces
// counter_get (:46) followed by ops/sketch.py::mask_by_frequency (:64) or
// mask_by_frequency_range (:73): it gathers table[h % size], keeps h when
// lo <= count <= hi and writes 0 otherwise, so the [B, W] counts never
// reach device memory.  -M calls it with (min_occ, INT_MAX), -I with
// (0, max_samples).
//
// The slot is the unsigned 64-bit remainder h % size, or h & (size - 1)
// when size is a power of two; hash 0 (an invalid k-mer) lands in slot 0
// and is counted like any other masked-in window, as rkmh counts it.
//
// What bounds them on the card: one random 4 B access per element into a
// table of 40 MB (filter's 1e7 slots, inside the 50 MB L2) to 3.2 GB
// (hpv16's 8e8 slots, HBM), plus a streaming read of the 8 B hashes (and
// an 8 B write for K7).  The design is one thread per element, a
// grid-stride loop, and a plain atomicAdd: integer adds commute, so the
// table is the same whatever the order of the launches and atomics.  Reads
// rich in N send many atomics to slot 0; warp aggregation for that hot
// slot is left until it is measured.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ uint32_t slot_of(uint64_t h, uint64_t size) {
  return (uint32_t)((size & (size - 1)) == 0 ? (h & (size - 1)) : (h % size));
}

__global__ void counter_add_kernel(const uint64_t* __restrict__ hashes,
                                   const uint8_t* __restrict__ mask, int64_t n,
                                   int32_t* __restrict__ table, uint64_t size) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (mask == nullptr || mask[i]) atomicAdd(&table[slot_of(hashes[i], size)], 1);
  }
}

__global__ void counter_mask_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                                    const int32_t* __restrict__ table, uint64_t size,
                                    int lo, int hi, uint64_t* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t h = hashes[i];
    const int c = __ldg(table + slot_of(h, size));
    out[i] = (lo <= c && c <= hi) ? h : 0ULL;
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// table[h % size] += 1 for every element of hashes [n] whose mask byte is
// non-zero (mask NULL: every element).  Requires n >= 1, 1 <= size < 2^31.
extern "C" int rkmh_counter_add(const int64_t* hashes, const uint8_t* mask, int64_t n,
                                int32_t* table, int64_t size, cudaStream_t stream) {
  counter_add_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      reinterpret_cast<const uint64_t*>(hashes), mask, n, table, (uint64_t)size);
  return (int)cudaGetLastError();
}

// out[i] = hashes[i] if lo <= table[hashes[i] % size] <= hi, else 0.
// Requires n >= 1, 1 <= size < 2^31.
extern "C" int rkmh_counter_mask(const int64_t* hashes, int64_t n, const int32_t* table,
                                 int64_t size, int lo, int hi, int64_t* out,
                                 cudaStream_t stream) {
  counter_mask_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, table, (uint64_t)size, lo, hi,
      reinterpret_cast<uint64_t*>(out));
  return (int)cudaGetLastError();
}
