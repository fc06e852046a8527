// A diagnostic for K6 (csrc/counter.cu), built and launched only by
// bench/kernel_ab.py: one atomicAdd per element into a counter table, the
// slots computed beforehand, so that what is timed is the atomics alone:
// no remainder, no mask, no 8-byte hashes.  Given the slots of a batch as
// they come, sorted, or drawn at random, it tells a floor per atomic from
// the cost of where they land.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void add_slots_kernel(const uint32_t* __restrict__ slots, int64_t n,
                                 int32_t* __restrict__ table) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    atomicAdd(&table[slots[i]], 1);
  }
}

}  // namespace

// table[slots[i]] += 1 for i < n.  Requires n >= 1 and every slot inside the table.
extern "C" int rkmh_diag_add_slots(const int32_t* slots, int64_t n, int32_t* table,
                                   cudaStream_t stream) {
  const int64_t blocks = (n + 255) / 256;
  add_slots_kernel<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), 256, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(slots), n, table);
  return (int)cudaGetLastError();
}
