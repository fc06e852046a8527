// K12: the sparse margins of the VW trainer, and their gradient.
//
// It replaces the XLA chain of rkmh_tpu/ml/wabbit.py: `_margins` (:171-174,
// jnp.sum(w[idx] * val, axis=-1)), vmapped over the classes (:219), and its
// jax.grad (:195, :228), a scatter-add of val * dm into the weights.
//   forward:  m[c, n] = sum_f W[c, idx[n, f]] * val[n, f]
//   backward: dW[c, idx[n, f]] += val[n, f] * dm[c, n]
// W and dW are [C, D] float32 (D = 2**bits, row c the weights of class c;
// C = 1 is the binary model), idx [N, F] int32 and val [N, F] float32 in
// wabbit's padded layout (a short row is padded with idx 0, val 0), m and dm
// [C, N] float32.  The wrapper (ops/sparse_margin.py) keeps idx in [0, D).
//
// What bounds it on the card: bytes.  Each pass reads idx and val once (8
// bytes an entry; ~33 MB at the per-read shape N = 4,096, F ~ 1,002) and
// C * 4 bytes of W (or dW) for each distinct index; the sums are a few
// operations a byte.  Both kernels give one warp to one example (row n):
// its lanes stride over the row, so the idx and val loads coalesce, and
// each entry is read once for all classes.
// * forward: a lane keeps the sums of TILE classes in registers (TILE = 1,
//   4 or 16, the smallest that holds C; wider C takes several passes over
//   the row), gathers W[c, idx] through the read-only cache, then the warp
//   adds its 32 partial sums by shuffles and lane 0 writes m[c, n].  The
//   order of the sums is fixed, so a run repeats its bits, but it is not
//   torch's order: the plain version agrees to round-off.
// * backward: one float atomicAdd into dW for each entry and class (a
//   reduction, RED, since the old value is not read).  Atomics from many
//   rows on one index serialise in the L2 and add in an order that changes
//   from run to run.  An entry whose val is 0 adds nothing and is skipped,
//   so the padding does not pile atomics onto index 0; the sum is the same
//   for any finite dm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // examples (warps) a block
constexpr unsigned FULL = 0xffffffffu;

template <int TILE>
__global__ void __launch_bounds__(WARPS * 32)
    sparse_margin_kernel(const float* __restrict__ W, const int32_t* __restrict__ idx,
                         const float* __restrict__ val, float* __restrict__ m, int N, int F,
                         int C, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform: the shuffles below see full warps
  const int32_t* row_idx = idx + n * F;
  const float* row_val = val + n * F;
  for (int c0 = 0; c0 < C; c0 += TILE) {
    float acc[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) acc[j] = 0.f;
    for (int f = lane; f < F; f += 32) {
      const int64_t i = row_idx[f];
      const float v = row_val[f];
#pragma unroll
      for (int j = 0; j < TILE; ++j)
        if (c0 + j < C) acc[j] += __ldg(W + (c0 + j) * D + i) * v;
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float s = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0 && c0 + j < C) m[(int64_t)(c0 + j) * N + n] = s;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    sparse_margin_grad_kernel(const float* __restrict__ dm, const int32_t* __restrict__ idx,
                              const float* __restrict__ val, float* __restrict__ dW, int N,
                              int F, int C, int64_t D) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int32_t* row_idx = idx + n * F;
  const float* row_val = val + n * F;
  for (int f = lane; f < F; f += 32) {
    const float v = row_val[f];
    if (v == 0.f) continue;
    const int64_t i = row_idx[f];
    for (int c = 0; c < C; ++c) atomicAdd(dW + c * D + i, v * __ldg(dm + (int64_t)c * N + n));
  }
}

unsigned blocks_for(int N) { return (unsigned)((N + WARPS - 1) / WARPS); }

}  // namespace

extern "C" int rkmh_sparse_margin(const float* W, const int32_t* idx, const float* val, float* m,
                                  int N, int F, int C, long long D, cudaStream_t stream) {
  const unsigned blocks = blocks_for(N);
  if (C == 1)
    sparse_margin_kernel<1><<<blocks, WARPS * 32, 0, stream>>>(W, idx, val, m, N, F, C, D);
  else if (C <= 4)
    sparse_margin_kernel<4><<<blocks, WARPS * 32, 0, stream>>>(W, idx, val, m, N, F, C, D);
  else
    sparse_margin_kernel<16><<<blocks, WARPS * 32, 0, stream>>>(W, idx, val, m, N, F, C, D);
  return (int)cudaGetLastError();
}

extern "C" int rkmh_sparse_margin_grad(const float* dm, const int32_t* idx, const float* val,
                                       float* dW, int N, int F, int C, long long D,
                                       cudaStream_t stream) {
  sparse_margin_grad_kernel<<<blocks_for(N), WARPS * 32, 0, stream>>>(dm, idx, val, dW, N, F,
                                                                       C, D);
  return (int)cudaGetLastError();
}
