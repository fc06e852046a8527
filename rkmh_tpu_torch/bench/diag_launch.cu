// A diagnostic for the kernels that move less than a launch costs (K4 and
// K5 at the gather sweep's small N), built and launched only by
// chip_smoke.py and bench/kernel_ab.py: a kernel that does nothing, on a
// grid of the caller's size.  Its time in CUDA-graph replay is the launch
// floor, the least time any kernel with that grid can take on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel(int32_t*) {}

}  // namespace

// Launches `blocks` blocks of `threads` threads that do nothing; `sink` is
// never written (a tensor names the device to the caller's wrapper).
extern "C" int rkmh_diag_empty(int32_t* sink, int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>(sink);
  return (int)cudaGetLastError();
}
