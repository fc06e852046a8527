// K4 / K5: the lookup-table gathers of the gather microbenchmark.
//
// They replace the two Pallas kernels of scripts/bench_gather.py:
//   K4 <- dg0_kernel (:109, called by g at :118): out[i, j] = lut[idx[i, j], j],
//         a tpu.dynamic_gather along sublanes from an [N, 128] int32 LUT
//         held in VMEM (the take_along_axis(axis=0) pattern), N in 8..16384;
//   K5 <- dg1_kernel (:140, called by g1 at :149): out[i, j] = lut[i, idx[i, j]],
//         a dynamic_gather along lanes, [512, 128] int32, idx in 0..127.
// On the TPU the whole LUT sat in VMEM and one vector instruction gathered
// 8 x 128 values (bench_gather.py:2-12 measured whether that beats XLA's
// row gather for the panel probe).
//
// K4: one thread per output element; neighbouring threads take
// neighbouring (i, j), so the idx loads and out stores coalesce.  Where the
// LUT fits a block's shared memory (N * C * 4 bytes within the limit the
// wrapper applies, so N in {8, 64} at C = 128) every block stages it there
// first, the Hopper analog of the VMEM LUT; column j then sits in bank
// j mod 32 (C a multiple of 32), so a warp's gather is free of bank
// conflicts whatever the indices.  Past that, the LUT is read through the
// read-only cache (__ldg); at N = 16384 it is 8 MB and stays in L2.
// What bounds it on the card: 8 bytes of idx + out traffic per element
// (plus the LUT once per block when staged); at N <= 512 the call moves
// under 1 MB and is launch latency, at N = 16384 it moves 24 MB.  There
// the cache route reads a 32 B L2 sector for each 4 B element, ~83 MB of
// sectors in all, at about the L2's own rate (4.5 TB/s).  A route that
// spread each 8-column tile of the LUT over the shared memory of a thread
// block cluster (so that every LUT byte left memory once) was bit-exact
// but 2-2.8x slower at N in {512, 4096, 16384} on an H100, whatever the
// layout, the load instruction (generic or ld.shared::cluster) or the
// loads in flight: 4-byte reads of a peer's shared memory at random run at
// about one per 4 cycles an SM.  So it was removed (PERF.md §5).
//
// K5: what bounds it is 12 bytes per element (idx, out, LUT row): at the
// sweep's [512, 128] the call moves 786 KB, far less than the launch costs,
// so the design cuts the round trips a block waits for.  Two routes
// (lanes_variant in ops/gather.py picks one from the shape and alignment):
// * reg (C = 128, M % 4 == 0, LUT, idx and out 16-byte aligned): one warp
//   per row, LANES_WARPS rows a block, no shared memory and no barrier.
//   Lane l loads row[4l .. 4l+3] into 4 registers (one 16-byte load) and,
//   in the same breath, 4 indices (one 16-byte load); row[j] then sits in
//   lane j >> 2, register j & 3, so each output is 4 __shfl_sync from lane
//   j >> 2 and a select on j & 3, and a lane stores 16 bytes.  One global
//   round trip in place of the staged route's two (the row, then the
//   index), and no bank conflicts.  A pass covers 128 indices of the row;
//   every lane runs every shuffle (the pass count is the warp's, not the
//   lane's); loads and stores are predicated.
// * smem (any other shape whose row fits a block): one block per row
//   stages row i in shared memory, waits at a barrier and gathers from it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_ITEMS = 8;  // elements per thread when the LUT is staged

__global__ void gather_rows_smem(const int32_t* __restrict__ lut,
                                 const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                                 int N, int C, int64_t total) {
  extern __shared__ int32_t s_lut[];  // [N, C]
  for (int t = threadIdx.x; t < N * C; t += blockDim.x) s_lut[t] = lut[t];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    out[e] = s_lut[idx[e] * C + (int)(e % C)];
  }
}

__global__ void gather_rows_ldg(const int32_t* __restrict__ lut,
                                const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                                int C, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) out[e] = __ldg(lut + (int64_t)idx[e] * C + e % C);
}

constexpr int LANES_WARPS = 4;    // rows (one warp each) per block of the reg route
constexpr int LANES_REG_C = 128;  // the reg route's row width: 4 ints a lane
constexpr unsigned FULL = 0xffffffffu;

// row[x] from the warp's registers: lane l holds row[4l .. 4l+3] in r
__device__ __forceinline__ int32_t from_row(const int4& r, int32_t x) {
  const int src = x >> 2;
  const int32_t a = __shfl_sync(FULL, r.x, src);
  const int32_t b = __shfl_sync(FULL, r.y, src);
  const int32_t c = __shfl_sync(FULL, r.z, src);
  const int32_t d = __shfl_sync(FULL, r.w, src);
  const int k = x & 3;
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

__global__ void gather_lanes_reg(const int32_t* __restrict__ lut,
                                 const int32_t* __restrict__ idx, int32_t* __restrict__ out,
                                 int N, int M) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * LANES_WARPS + (threadIdx.x >> 5);
  if (i >= N) return;  // a whole warp: the shuffles below see all 32 lanes
  const int4 r = __ldg(reinterpret_cast<const int4*>(lut + i * LANES_REG_C) + lane);
  const int32_t* irow = idx + i * M;
  int32_t* orow = out + i * M;
  for (int base = 0; base < M; base += 4 * 32) {
    const int j = base + 4 * lane;  // M % 4 == 0: a live vector is whole
    const int4 x = j < M ? __ldg(reinterpret_cast<const int4*>(irow + j)) : make_int4(0, 0, 0, 0);
    const int4 y = make_int4(from_row(r, x.x), from_row(r, x.y), from_row(r, x.z),
                             from_row(r, x.w));
    if (j < M) *reinterpret_cast<int4*>(orow + j) = y;
  }
}

__global__ void gather_lanes(const int32_t* __restrict__ lut, const int32_t* __restrict__ idx,
                             int32_t* __restrict__ out, int C, int M) {
  extern __shared__ int32_t s_row[];  // [C]
  const int64_t i = blockIdx.x;
  for (int t = threadIdx.x; t < C; t += blockDim.x) s_row[t] = lut[i * C + t];
  __syncthreads();
  for (int t = threadIdx.x; t < M; t += blockDim.x) out[i * M + t] = s_row[idx[i * M + t]];
}

}  // namespace

// lut [N, C] int32, idx [M, C] int32 with values in [0, N) -> out [M, C]
// int32.  smem != 0 stages the LUT in shared memory (N * C * 4 bytes, at
// most the per-block limit).  Requires M * C >= 1.
extern "C" int rkmh_lut_gather_rows(const int32_t* lut, const int32_t* idx, int32_t* out,
                                    int N, int C, int64_t M, int smem,
                                    cudaStream_t stream) {
  const int64_t total = M * C;
  if (smem) {
    const size_t bytes = (size_t)N * C * sizeof(int32_t);
    if (bytes > 48 * 1024) {
      cudaFuncSetAttribute(gather_rows_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
    }
    const int64_t blocks = (total + (int64_t)THREADS * SMEM_ITEMS - 1) / (THREADS * SMEM_ITEMS);
    gather_rows_smem<<<(unsigned)blocks, THREADS, bytes, stream>>>(lut, idx, out, N, C, total);
  } else {
    const int64_t blocks = (total + THREADS - 1) / THREADS;
    gather_rows_ldg<<<(unsigned)blocks, THREADS, 0, stream>>>(lut, idx, out, C, total);
  }
  return (int)cudaGetLastError();
}

// lut [N, C] int32, idx [N, M] int32 with values in [0, C) -> out [N, M]
// int32.  reg != 0 takes the register route (C = 128, M % 4 == 0 and all
// three pointers 16-byte aligned), else the staged route (C * 4 bytes
// within the per-block limit).  Requires N >= 1.
extern "C" int rkmh_lut_gather_lanes(const int32_t* lut, const int32_t* idx, int32_t* out,
                                     int N, int C, int M, int reg, cudaStream_t stream) {
  if (reg) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(lut) | reinterpret_cast<uintptr_t>(idx) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (C != LANES_REG_C || M % 4 != 0 || !aligned) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((N + LANES_WARPS - 1) / LANES_WARPS);
    gather_lanes_reg<<<blocks, 32 * LANES_WARPS, 0, stream>>>(lut, idx, out, N, M);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)C * sizeof(int32_t);
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(gather_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
  gather_lanes<<<N, 128, bytes, stream>>>(lut, idx, out, C, M);
  return (int)cudaGetLastError();
}
