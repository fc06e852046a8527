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
// What bounds it on the card: integer ALU work.  Each window reads k
// bytes and writes 8, and spends ~10 64-bit multiply/rotate/xor steps
// per 16 input bytes plus the finaliser, so memory traffic is small next
// to the arithmetic.  The design keeps every load on chip: a block stages
// the codes of its tile of windows (TILE + k - 1 bytes) in shared memory
// once, and each thread then hashes one window with native uint64
// arithmetic (no u32-pair emulation, no VMEM tiling, no Mosaic shift
// workaround).  The canonical strand is chosen by a byte-wise compare
// from the outside in, so any k works; there is no 2-bit key capped at
// k = 32.  Multi-k runs one launch per k into its column block of one
// [B, sum W] output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;  // windows (= threads) per block

constexpr uint64_t C1 = 0x87C37B91114253D5ULL;
constexpr uint64_t C2 = 0x4CF5AD432745937FULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDULL;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ULL;
  k ^= k >> 33;
  return k;
}

// Byte p of the canonical k-mer of the window starting at c.
__device__ __forceinline__ uint64_t canon_byte(const uint8_t* c, int k, bool fwd, int p) {
  const uint8_t code = fwd ? c[p] : (uint8_t)(3 - c[k - 1 - p]);
  return code == 0 ? 65 : code == 1 ? 67 : code == 2 ? 71 : 84;  // A C G T
}

// Little-endian word of canonical bytes [p0, min(p0 + 8, k)).
__device__ __forceinline__ uint64_t canon_word(const uint8_t* c, int k, bool fwd, int p0) {
  uint64_t w = 0;
  const int n = min(8, k - p0);
  for (int j = 0; j < n; ++j) w |= canon_byte(c, k, fwd, p0 + j) << (8 * j);
  return w;
}

__global__ void window_hash_kernel(const uint8_t* __restrict__ codes, int L, int k,
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
  const uint8_t* c = tile + threadIdx.x;
  uint64_t* dst = out + (int64_t)row * out_cols + col0 + w;

  for (int p = 0; p < k; ++p) {
    if (c[p] >= 4) {
      *dst = 0;
      return;
    }
  }
  // forward <= reverse complement, decided at the first position (from
  // the outside in) where the two strands differ
  bool fwd = true;
  for (int p = 0; p < k; ++p) {
    const uint8_t a = c[p];
    const uint8_t b = 3 - c[k - 1 - p];
    if (a != b) {
      fwd = a < b;
      break;
    }
  }

  uint64_t h1 = seed, h2 = seed;
  const int nblocks = k / 16;
  for (int i = 0; i < nblocks; ++i) {
    uint64_t k1 = canon_word(c, k, fwd, 16 * i);
    uint64_t k2 = canon_word(c, k, fwd, 16 * i + 8);
    k1 *= C1; k1 = rotl64(k1, 31); k1 *= C2;
    h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2;
    h1 = h1 * 5 + 0x52DCEFB5ULL;
    k2 *= C2; k2 = rotl64(k2, 33); k2 *= C1;
    h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1;
    h2 = h2 * 5 + 0x38495AB5ULL;
  }
  const int tl = k - 16 * nblocks;
  if (tl >= 9) {
    uint64_t k2 = canon_word(c, k, fwd, 16 * nblocks + 8);
    k2 *= C2; k2 = rotl64(k2, 33); k2 *= C1;
    h2 ^= k2;
  }
  if (tl >= 1) {
    uint64_t k1 = canon_word(c, k, fwd, 16 * nblocks);
    k1 *= C1; k1 = rotl64(k1, 31); k1 *= C2;
    h1 ^= k1;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  *dst = h1 + h2;
}

}  // namespace

// codes [B, L] uint8 -> out[:, col0 : col0 + L-k+1] of a [B, out_cols]
// uint64 array.  Requires 1 <= k <= L and B >= 1.
extern "C" int rkmh_window_hash(const uint8_t* codes, int B, int L, int k,
                                unsigned long long seed, int64_t* out,
                                long long out_cols, long long col0,
                                cudaStream_t stream) {
  const int W = L - k + 1;
  const dim3 grid(B, (W + TILE - 1) / TILE);
  const size_t smem = TILE + k - 1;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(window_hash_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  window_hash_kernel<<<grid, TILE, smem, stream>>>(
      codes, L, k, (uint64_t)seed, W, reinterpret_cast<uint64_t*>(out),
      (int64_t)out_cols, (int64_t)col0);
  return (int)cudaGetLastError();
}
