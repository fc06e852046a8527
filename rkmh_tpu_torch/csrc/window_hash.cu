// K1: canonical k-mer window hashes (MurmurHash3_x64_128 h1, seed 42).
//
// Replaces rkmh_tpu/ops/pallas_hash.py::_hash_kernel (reached through
// kmer_window_hashes_pallas_pair / kmer_window_hashes_pallas) and computes
// what rkmh_tpu/ops/hashing.py::kmer_window_hashes computes: for window i
// of a [B, L] uint8 code row (A=0 C=1 G=2 T=3, >= 4 invalid or padding),
// 0 if any code in [i, i+k) is >= 4, else h1 of the ASCII bytes of the
// lexicographically smaller of the k-mer and its reverse complement (a
// tie goes to the forward strand).
//
// What bounds it on the card: integer ALU work.  Each window reads about
// one code byte and writes 8 bytes (the memory floor of a 16,384 x 160
// batch at k=12 is ~6.6 us at 3.35 TB/s), but its murmur body and
// finalisers are ~8 64-bit multiplies plus shifts and xors.  The design
// spends as little as it can around that arithmetic.
//
// k <= 32, the packed variant.  The B x W windows are flattened and each
// block of PT threads hashes BW = 4 * PT consecutive windows (4 a thread,
// PT apart), so no thread idles at the end of a row (rows of 149 windows
// left 107 of 256 threads idle in a (row, tile) grid).  Those windows read
// one contiguous span of the code array (rows are contiguous), at most BW
// * k bytes; rows and columns come from the flat index by a multiply-high
// division with host-made constants.  Each warp packs 32 codes of the span
// with three ballots into shared memory: the 2-bit codes, first base in
// the most significant bits, and a bitmask of the invalid positions.  A
// window then takes its forward key as the 2k bits at bit 2p (two word
// loads and a funnel shift), its validity as "the k mask bits at p are all
// zero", and its reverse complement from the key itself (reverse the
// 2-bit groups with a bit reversal and a pair swap, then complement), so
// no reverse-complement row is packed.  A=0 < C=1 < G=2 < T=3 is the order
// of the ASCII bytes, so `fwd <= rc` as integers is exactly the outside-in
// byte compare.  The ASCII words of the canonical key come from a
// 256-entry table in shared memory that maps 4 bases to 4 ASCII bytes:
// ceil(k/4) lookups (3 at k=12, 5 at k=18).  Stores stay coalesced:
// neighbouring threads write neighbouring windows.  Each k in 1..32 runs
// an instance compiled for it, its shifts, masks and murmur tail fixed
// (faster than one instance taking k at run time: PERF.md §5).
//
// k > 32, the byte-wise variant (any k).  A block stages the codes of its
// tile of TILE windows of one row (TILE + k - 1 bytes) in shared memory
// and each thread decides the strand by a byte-wise compare from the
// outside in (murmur3.cuh, shared with K9's mutated k-mers).  Multi-k
// runs one launch per k into its column block of one [B, sum W] output.

#include <algorithm>
#include <array>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

using rkmh::murmur_block;
using rkmh::murmur_finish;

constexpr int PT = 256;            // packed variant: threads per block
constexpr int WPT = 4;             // windows per thread
constexpr int BW = PT * WPT;       // windows per block
constexpr int MAX_PACKED_K = 32;
// a block's span is at most BW * k codes; one 64-bit word holds 32 codes,
// plus one word read past the last by the funnel shifts
constexpr int SPAN_WORDS = BW * MAX_PACKED_K / 32 + 1;
constexpr int TILE = 128;        // byte-wise variant: windows (= threads) per block
constexpr unsigned FULL = 0xFFFFFFFFu;

// 32-bit x -> 64 bits with bit j of x at bit 2j.
__device__ __forceinline__ uint64_t spread_bits(uint32_t v) {
  uint64_t x = v;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2)) & 0x3333333333333333ULL;
  x = (x | (x << 1)) & 0x5555555555555555ULL;
  return x;
}

// Division by a fixed d >= 1 of any 32-bit n as a multiply-high and two
// shifts (Granlund and Montgomery), the constants made on the host.
struct FastDiv {
  uint32_t m;
  int s1, s2;
};

FastDiv make_fast_div(uint32_t d) {
  int l = 0;
  while ((1ULL << l) < d) ++l;
  const uint64_t m = (((1ULL << 32) * ((1ULL << l) - d)) / d) + 1;
  return {(uint32_t)m, l ? 1 : 0, l ? l - 1 : 0};
}

__device__ __forceinline__ uint32_t fast_div(uint32_t n, FastDiv d) {
  const uint32_t t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

// h1 of the k-window whose first code is code p of a block's packed span.
template <int k>
__device__ __forceinline__ uint64_t hash_packed_window(const uint64_t* fwd, const uint32_t* bad,
                                                       const uint32_t* ascii4, int p,
                                                       uint64_t seed) {
  const uint32_t kmask = k == 32 ? FULL : (1u << (k & 31)) - 1u;
  if (__funnelshift_r(bad[p >> 5], bad[(p >> 5) + 1], p & 31) & kmask) return 0;
  // forward key, left-aligned: the 2k bits at bit 2p, the rest cleared
  const int s = (2 * p) & 63, i = (2 * p) >> 6, drop = 64 - 2 * k;
  uint64_t x = (fwd[i] << s) | ((fwd[i + 1] >> 1) >> (63 - s));
  x = (x >> drop) << drop;
  // reverse complement, left-aligned: bit reversal puts base j at bits
  // 2j, 2j+1 with its two bits swapped; swap them back, complement the 2k
  // live bits, realign
  uint64_t rc = __brevll(x);
  rc = ((rc >> 1) & 0x5555555555555555ULL) | ((rc & 0x5555555555555555ULL) << 1);
  rc = (rc ^ (~0ULL >> drop)) << drop;
  const uint64_t canon = x <= rc ? x : rc;

  // little-endian ASCII words of the canonical k-mer, zero past byte k
  uint64_t wd[4] = {0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int nb = k - 4 * g;  // bases of group g
    if (nb > 0) {
      uint32_t a = ascii4[(canon >> (56 - 8 * g)) & 0xFF];
      if (nb < 4) a &= (1u << (8 * nb)) - 1u;
      wd[g >> 1] |= (uint64_t)a << (32 * (g & 1));
    }
  }
  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k >> 4;  // 0, 1 or 2
  if (nblocks >= 1) murmur_block(h1, h2, wd[0], wd[1]);
  if (nblocks >= 2) murmur_block(h1, h2, wd[2], wd[3]);
  return nblocks == 0 ? murmur_finish(h1, h2, k, wd[0], wd[1])
                      : murmur_finish(h1, h2, k, wd[2], wd[3]);
}

// Windows [0, total) of rows of W k-windows; total < 2^32.
template <int k>
__global__ void __launch_bounds__(PT) window_hash_packed_kernel(
    const uint8_t* __restrict__ codes, int L, uint64_t seed, int W, FastDiv by_w,
    uint32_t total, uint64_t* __restrict__ out, int64_t out_cols, int64_t col0) {
  __shared__ uint64_t fwd[SPAN_WORDS];  // 2-bit codes; code 32i+j at bits 63-2j, 62-2j of word i
  __shared__ uint32_t bad[SPAN_WORDS];  // bit j of word i: code 32i+j >= 4
  __shared__ uint32_t ascii4[256];      // 4 bases (first in bits 7-6) -> 4 ASCII bytes, LE

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    uint32_t a = 0;
    for (int j = 0; j < 4; ++j) {
      const uint32_t c = (tid >> (6 - 2 * j)) & 3u;
      a |= (c == 0 ? 65u : c == 1 ? 67u : c == 2 ? 71u : 84u) << (8 * j);  // A C G T
    }
    ascii4[tid] = a;
  }

  // the block's windows [f0, f0 + BW) span the codes [g0, g0 + span): the
  // windows of rows r0..r1 and the k - 1 trailing codes of each row
  const uint32_t f0 = blockIdx.x * (uint32_t)BW;
  const uint32_t fl = min(f0 + BW, total) - 1;
  const uint32_t r0 = fast_div(f0, by_w), r1 = fast_div(fl, by_w);
  const uint32_t w0 = f0 - r0 * W;
  const int64_t g0 = (int64_t)r0 * L + w0;
  const int span = (int)(fl - f0 + 1 + (r1 - r0 + 1) * (k - 1));

  // warp-uniform loop bound: every lane takes part in the ballots
  for (int base = warp * 32; base < span; base += PT) {
    const int j = base + lane;
    const uint32_t c = j < span ? codes[g0 + j] : 255u;
    const uint32_t b0 = __ballot_sync(FULL, c & 1u);
    const uint32_t b1 = __ballot_sync(FULL, c & 2u);
    const uint32_t bd = __ballot_sync(FULL, c >= 4u);
    if (lane == 0) {
      // lane j's high bit to 2j, low bit to 2j + 1, then reverse: 63-2j, 62-2j
      fwd[base >> 5] = __brevll(spread_bits(b1) | (spread_bits(b0) << 1));
      bad[base >> 5] = bd;
    }
  }
  __syncthreads();

  // WPT windows per thread, PT apart: stores stay coalesced
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const uint32_t t = tid + j * PT;
    if (f0 + t >= total) break;
    const uint32_t dr = fast_div(w0 + t, by_w);  // rows past r0
    const uint32_t w = w0 + t - dr * W;
    const int p = (int)(t + dr * (k - 1));  // the window's first code in the span
    out[(int64_t)(r0 + dr) * out_cols + col0 + w] =
        hash_packed_window<k>(fwd, bad, ascii4, p, seed);
  }
}

// The packed kernel's instance for each k in 1..MAX_PACKED_K, by k - 1.
using PackedKernel = void (*)(const uint8_t*, int, uint64_t, int, FastDiv, uint32_t,
                              uint64_t*, int64_t, int64_t);

template <int... K>
std::array<PackedKernel, sizeof...(K)> packed_kernels(
    std::integer_sequence<int, K...>) {
  return {window_hash_packed_kernel<K + 1>...};
}

const std::array<PackedKernel, MAX_PACKED_K> PACKED_KERNELS =
    packed_kernels(std::make_integer_sequence<int, MAX_PACKED_K>());

__global__ void window_hash_bytewise_kernel(const uint8_t* __restrict__ codes, int L, int k,
                                            uint64_t seed, int W, uint64_t* __restrict__ out,
                                            int64_t out_cols, int64_t col0) {
  extern __shared__ uint8_t tile[];
  const int row = blockIdx.x;
  const int w0 = blockIdx.y * TILE;
  const int span = min(TILE + k - 1, L - w0);
  const uint8_t* src = codes + (int64_t)row * L + w0;
  for (int j = threadIdx.x; j < span; j += blockDim.x) tile[j] = src[j];
  __syncthreads();

  const int w = w0 + threadIdx.x;
  if (w >= W) return;
  out[(int64_t)row * out_cols + col0 + w] =
      rkmh::hash_window_bytewise(tile + threadIdx.x, k, seed);
}

}  // namespace

// codes [B, L] uint8 -> out[:, col0 : col0 + L-k+1] of a [B, out_cols]
// uint64 array.  Requires 1 <= k <= L and B >= 1.
extern "C" int rkmh_window_hash(const uint8_t* codes, int B, int L, int k,
                                unsigned long long seed, int64_t* out,
                                long long out_cols, long long col0,
                                cudaStream_t stream) {
  const int W = L - k + 1;
  if (k <= MAX_PACKED_K) {
    // launches of fewer than 2^31 windows, so the kernel's indices fit 32 bits
    const int64_t rows_per_launch = std::max<int64_t>(1, INT32_MAX / W);
    const FastDiv by_w = make_fast_div((uint32_t)W);
    for (int64_t r = 0; r < B; r += rows_per_launch) {
      const uint32_t total = (uint32_t)(std::min<int64_t>(rows_per_launch, B - r) * W);
      PACKED_KERNELS[k - 1]<<<(total + BW - 1) / BW, PT, 0, stream>>>(
          codes + (int64_t)r * L, L, (uint64_t)seed, W, by_w, total,
          reinterpret_cast<uint64_t*>(out) + (int64_t)r * out_cols, (int64_t)out_cols,
          (int64_t)col0);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  const dim3 grid(B, (W + TILE - 1) / TILE);
  const size_t smem = TILE + k - 1;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(window_hash_bytewise_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  window_hash_bytewise_kernel<<<grid, TILE, smem, stream>>>(
      codes, L, k, (uint64_t)seed, W, reinterpret_cast<uint64_t*>(out),
      (int64_t)out_cols, (int64_t)col0);
  return (int)cudaGetLastError();
}
