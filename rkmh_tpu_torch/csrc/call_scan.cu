// K9: call's mutation scan, fused: mutate -> hash -> probe -> call.
//
// Replaces the XLA chain of rkmh_tpu/call_engine.py:79-123 (inside
// call_scan_ref, :54): for every reference position j of P, every 1-bp
// substitution of its k-window (k positions x 3 bases, rkmh.cpp's
// rotate_snps order) and every 1-bp deletion of its flanking (k+1)-window
// (alt_pos 1..k), hashed canonically and looked up in the read-depth map;
// then rkmh's calls, in double precision as rkmh.cpp compares them:
//
//   snp_call  = site[j] && snp_depth >= 0.1 * avg[j] && snp_depth > depth[j]
//               && the origin base is A, C, G or T          (rkmh.cpp:1814)
//   max_rescue[j] = site[j] ? max over (ap, b) of snp_depth : 0 (an N
//               origin's alternatives included)            (rkmh.cpp:1812)
//   del_call  = site[j] && del_depth > 0.9 * avg[j] && j > 0 (rkmh.cpp:1858)
//
// The JAX chain builds [P, k, 3, k] and [P, k, k] code tensors and hashes
// them as rows; here no mutated k-mer leaves the thread that makes it.
//
// What bounds it on the card: integer work, then the map's random loads.
// Per position it writes 4k int32 depths and 4k bool calls (20k bytes) and
// reads a code, three scalars and at most 4k random 16-byte map slots (two
// probes a variant); each variant is a whole MurmurHash3 of k bytes with
// its strand decision.  One byte-wise route (any k >= 1): a block takes a
// tile of TP positions (TP * 4k ~ 1,024 variants), stages their codes and
// the (k+1)-code halo in shared memory, and each thread makes one variant
// at a time: an accessor reads the window with the substituted or skipped
// code on the fly, and murmur3.cuh's byte-wise hash (the one K1 uses above
// k = 32) chooses the strand and hashes it, so both kernels hash the same
// bytes.  The map probe is K8's (hashmap.cuh).  Neighbouring threads write
// neighbouring outputs; max_rescue reduces in shared memory.  A packed
// route like K1's (2-bit keys, table lookups for the ASCII words) is
// left for a later design.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hashmap.cuh"
#include "murmur3.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VARIANTS_PER_BLOCK = 1024;
constexpr uint64_t SEED = 42;  // rkmh's murmur seed

// rotate_snps (rkmh.cpp:1634-1654) in 2-bit codes A=0 C=1 G=2 T=3:
// A->(C,T,G) C->(T,G,A) G->(A,C,T) T->(C,G,A); entry (c, b) at bits 2(3c+b).
constexpr uint32_t ROT_PACKED =
    (1u << 0) | (3u << 2) | (2u << 4) |     // A
    (3u << 6) | (2u << 8) | (0u << 10) |    // C
    (0u << 12) | (1u << 14) | (3u << 16) |  // G
    (1u << 18) | (2u << 20) | (0u << 22);   // T

__device__ __forceinline__ uint8_t rot(uint8_t code, int b) {
  const int c = code < 3 ? code : 3;  // an N origin rotates as T (ROT[min(code, 3)])
  return (uint8_t)((ROT_PACKED >> (2 * (3 * c + b))) & 3u);
}

// The k-window w with code ap replaced by alt.
struct SnpKmer {
  const uint8_t* w;
  int ap;
  uint8_t alt;
  __device__ __forceinline__ uint8_t operator[](int p) const { return p == ap ? alt : w[p]; }
};

// The (k+1)-window d with code ap (1..k) left out.
struct DelKmer {
  const uint8_t* d;
  int ap;
  __device__ __forceinline__ uint8_t operator[](int p) const { return d[p < ap ? p : p + 1]; }
};

__global__ void __launch_bounds__(THREADS) call_scan_kernel(
    const uint8_t* __restrict__ pref, int64_t P, int k, int TP,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ avg,
    const uint8_t* __restrict__ site, const int4* __restrict__ table, uint32_t mask,
    int32_t* __restrict__ snp_depth, uint8_t* __restrict__ snp_call,
    int32_t* __restrict__ max_rescue, int32_t* __restrict__ del_depth,
    uint8_t* __restrict__ del_call) {
  extern __shared__ int32_t smem[];
  int32_t* rescue = smem;                                   // [TP]
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + TP);    // pref[j0, j0 + np + k)
  const int64_t j0 = (int64_t)blockIdx.x * TP;
  const int np = P - j0 < TP ? (int)(P - j0) : TP;
  for (int i = threadIdx.x; i < np + k; i += THREADS) tile[i] = pref[j0 + i];
  for (int i = threadIdx.x; i < np; i += THREADS) rescue[i] = 0;
  __syncthreads();

  const int per = 4 * k;  // 3k substitutions, then k deletions
  for (int v = threadIdx.x; v < np * per; v += THREADS) {
    const int jl = v / per, r = v - jl * per;
    const int64_t j = j0 + jl;
    const bool is_site = site[j] != 0;
    const double a = (double)avg[j];
    if (r < 3 * k) {
      const int ap = r / 3, b = r - 3 * ap;
      const uint8_t* w = tile + jl + 1;  // ref[j .. j + k)
      const uint8_t orig = w[ap];
      const uint64_t h = rkmh::hash_window_bytewise(SnpKmer{w, ap, rot(orig, b)}, k, SEED);
      const int32_t d = rkmh::map_get(table, mask, h);
      snp_depth[j * 3 * k + r] = d;
      snp_call[j * 3 * k + r] =
          is_site && (double)d >= 0.1 * a && d > depth[j] && orig < 4;
      if (is_site && d > 0) atomicMax(rescue + jl, d);
    } else {
      const int api = r - 3 * k;  // alt_pos - 1
      const uint64_t h = rkmh::hash_window_bytewise(DelKmer{tile + jl, api + 1}, k, SEED);
      const int32_t d = rkmh::map_get(table, mask, h);
      del_depth[j * k + api] = d;
      del_call[j * k + api] = is_site && (double)d > 0.9 * a && j > 0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += THREADS) max_rescue[j0 + i] = rescue[i];
}

}  // namespace

// pref [P + k] uint8: one pad code (4), then the reference's codes;
// depth, avg [P] int32, site [P] bool; table [T, 4] int32 (hashmap.cuh);
// -> snp_depth [P, k, 3] int32, snp_call [P, k, 3] bool, max_rescue [P]
// int32, del_depth [P, k] int32, del_call [P, k] bool.  Requires P >= 1,
// k >= 1.
extern "C" int rkmh_call_scan(const uint8_t* pref, long long P, int k, const int32_t* depth,
                              const int32_t* avg, const uint8_t* site, const int32_t* table,
                              long long T, int32_t* snp_depth, uint8_t* snp_call,
                              int32_t* max_rescue, int32_t* del_depth, uint8_t* del_call,
                              cudaStream_t stream) {
  const int TP = std::max(1, VARIANTS_PER_BLOCK / (4 * k));
  const size_t smem = 4 * (size_t)TP + TP + k;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(call_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int64_t blocks = (P + TP - 1) / TP;
  call_scan_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      pref, (int64_t)P, k, TP, depth, avg, site, reinterpret_cast<const int4*>(table),
      (uint32_t)(T - 1), snp_depth, snp_call, max_rescue, del_depth, del_call);
  return (int)cudaGetLastError();
}
