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
// reads a code, three scalars and makes 4k probes of the map (two
// dependent loads each into a map laid out to stay in the L2,
// hashmap.cuh); each variant is a whole MurmurHash3 of k bytes with its
// strand decision.  A block takes a tile of TP positions (TP * 4k ~ 1,024
// variants) and the (k+1)-code halo; each thread makes one variant at a
// time; neighbouring threads write neighbouring outputs, with streaming
// stores (__stcs) so that the 20k bytes a position do not evict the map;
// max_rescue reduces in shared memory.
//
// k <= 32, the packed route: the block packs its codes as K1 does
// (packed_kmer.cuh: 2-bit codes, first base in the most significant bits,
// and a bitmask of the invalid positions).  A substitution is the
// window's forward key with one 2-bit group replaced, x ^ ((cur ^ alt) <<
// (62 - 2ap)) in the left-aligned key; a deletion splices the prefix
// [0, ap) of the (k+1)-window's first k codes with the suffix [ap, k) of
// its last k codes, two keys of the span (at k = 32 the (k+1)-window is 66
// bits, so it never goes through one word).  A variant is valid when the
// mask bits of the codes it keeps are zero.  The strand, the ASCII words
// and the hash are K1's (hash_packed_key).  One instance per k in 1..32.
//
// k > 32 (and on request at any k, to time it), the byte-wise route: the
// tile's codes are staged as bytes and an accessor reads the window with
// the substituted or skipped code on the fly; murmur3.cuh's byte-wise
// hash (K1's above k = 32) chooses the strand and hashes it.

#include <algorithm>
#include <array>
#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "hashmap.cuh"
#include "murmur3.cuh"
#include "packed_kmer.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VARIANTS_PER_BLOCK = 1024;
constexpr int MAX_PACKED_K = 32;
constexpr uint64_t SEED = 42;  // rkmh's murmur seed

// rotate_snps (rkmh.cpp:1634-1654) in 2-bit codes A=0 C=1 G=2 T=3:
// A->(C,T,G) C->(T,G,A) G->(A,C,T) T->(C,G,A); entry (c, b) at bits 2(3c+b).
constexpr uint32_t ROT_PACKED =
    (1u << 0) | (3u << 2) | (2u << 4) |     // A
    (3u << 6) | (2u << 8) | (0u << 10) |    // C
    (0u << 12) | (1u << 14) | (3u << 16) |  // G
    (1u << 18) | (2u << 20) | (0u << 22);   // T

__device__ __forceinline__ uint32_t rot(uint32_t code, int b) {
  const uint32_t c = code < 3 ? code : 3;  // an N origin rotates as T (ROT[min(code, 3)])
  return (ROT_PACKED >> (2 * (3 * c + b))) & 3u;
}

// The scan's inputs and outputs beside the codes.
struct Scan {
  const int32_t* depth;
  const int32_t* avg;
  const uint8_t* site;
  rkmh::MapView map;
  int32_t* snp_depth;
  uint8_t* snp_call;
  int32_t* max_rescue;
  int32_t* del_depth;
  uint8_t* del_call;
};

// Substitution r (= 3 ap + b) of position j, hash h: its depth, call and rescue.
__device__ __forceinline__ void emit_snp(const Scan& s, int64_t j, int k, int r, uint64_t h,
                                         bool orig_ok, int32_t* rescue) {
  const int32_t d = rkmh::map_get(s.map, h);
  const bool is_site = s.site[j] != 0;
  const int64_t o = j * 3 * k + r;
  __stcs(s.snp_depth + o, d);
  __stcs(s.snp_call + o, (uint8_t)(is_site && (double)d >= 0.1 * (double)s.avg[j] &&
                                   d > s.depth[j] && orig_ok));
  if (is_site && d > 0) atomicMax(rescue, d);
}

// Deletion api (= alt_pos - 1) of position j, hash h: its depth and call.
__device__ __forceinline__ void emit_del(const Scan& s, int64_t j, int k, int api, uint64_t h) {
  const int32_t d = rkmh::map_get(s.map, h);
  const int64_t o = j * k + api;
  __stcs(s.del_depth + o, d);
  __stcs(s.del_call + o, (uint8_t)(s.site[j] != 0 && (double)d > 0.9 * (double)s.avg[j] &&
                                   j > 0));
}

template <int k>
__global__ void __launch_bounds__(THREADS) call_scan_packed_kernel(
    const uint8_t* __restrict__ pref, int64_t P, Scan s) {
  constexpr int TP = VARIANTS_PER_BLOCK / (4 * k) > 0 ? VARIANTS_PER_BLOCK / (4 * k) : 1;
  // the span pref[j0, j0 + np + k), plus the word the funnel shifts read past it
  constexpr int WORDS = (TP + k) / 32 + 2;
  constexpr int per = 4 * k;  // 3k substitutions, then k deletions
  __shared__ uint64_t fwd[WORDS];
  __shared__ uint32_t bad[WORDS];
  __shared__ uint32_t ascii4[256];
  __shared__ int32_t rescue[TP];
  const int64_t j0 = (int64_t)blockIdx.x * TP;
  const int np = P - j0 < TP ? (int)(P - j0) : TP;
  static_assert(THREADS == 256, "init_ascii4 fills one entry a thread");
  rkmh::init_ascii4(ascii4);
  for (int i = threadIdx.x; i < np; i += THREADS) rescue[i] = 0;
  rkmh::pack_span<THREADS>(pref + j0, np + k, fwd, bad);
  __syncthreads();

  for (int v = threadIdx.x; v < np * per; v += THREADS) {
    const int jl = v / per, r = v - jl * per;
    const int64_t j = j0 + jl;
    // the k-window ref[j, j + k) is span code jl + 1 on
    const uint64_t x1 = rkmh::packed_key<k>(fwd, jl + 1);
    const uint32_t bad1 = rkmh::packed_bad<k>(bad, jl + 1);
    if (r < 3 * k) {
      const int ap = r / 3, b = r - 3 * ap;
      const int sh = 62 - 2 * ap;
      const uint32_t cur = (uint32_t)(x1 >> sh) & 3u;
      const bool orig_ok = !((bad1 >> ap) & 1u);
      const uint32_t alt = rot(orig_ok ? cur : 3u, b);
      const uint64_t h = (bad1 & ~(1u << ap))
                             ? 0
                             : rkmh::hash_packed_key<k>(x1 ^ ((uint64_t)(cur ^ alt) << sh),
                                                        ascii4, SEED);
      emit_snp(s, j, k, r, h, orig_ok, rescue + jl);
    } else {
      // the (k+1)-window pref[j, j + k] without its code ap: codes [0, ap)
      // of its first k codes (span code jl on), then codes [ap, k) of its
      // last k (the k-window)
      const int ap = r - 3 * k + 1;
      const uint64_t x0 = rkmh::packed_key<k>(fwd, jl);
      const uint32_t bad0 = rkmh::packed_bad<k>(bad, jl);
      const uint32_t low = ap == 32 ? 0xFFFFFFFFu : (1u << ap) - 1u;
      const uint64_t top = ~0ULL << (64 - 2 * ap);
      const uint64_t h = ((bad0 & low) | (bad1 & ~low))
                             ? 0
                             : rkmh::hash_packed_key<k>((x0 & top) | (x1 & ~top), ascii4, SEED);
      emit_del(s, j, k, ap - 1, h);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += THREADS) s.max_rescue[j0 + i] = rescue[i];
}

// The packed kernel's instance for each k in 1..MAX_PACKED_K, by k - 1.
using PackedKernel = void (*)(const uint8_t*, int64_t, Scan);

template <int... K>
std::array<PackedKernel, sizeof...(K)> packed_kernels(std::integer_sequence<int, K...>) {
  return {call_scan_packed_kernel<K + 1>...};
}

const std::array<PackedKernel, MAX_PACKED_K> PACKED_KERNELS =
    packed_kernels(std::make_integer_sequence<int, MAX_PACKED_K>());

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

__global__ void __launch_bounds__(THREADS) call_scan_bytewise_kernel(
    const uint8_t* __restrict__ pref, int64_t P, int k, int TP, Scan s) {
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
    if (r < 3 * k) {
      const int ap = r / 3, b = r - 3 * ap;
      const uint8_t* w = tile + jl + 1;  // ref[j .. j + k)
      const uint8_t orig = w[ap];
      const uint64_t h =
          rkmh::hash_window_bytewise(SnpKmer{w, ap, (uint8_t)rot(orig, b)}, k, SEED);
      emit_snp(s, j, k, r, h, orig < 4, rescue + jl);
    } else {
      const int api = r - 3 * k;  // alt_pos - 1
      emit_del(s, j, k, api, rkmh::hash_window_bytewise(DelKmer{tile + jl, api + 1}, k, SEED));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += THREADS) s.max_rescue[j0 + i] = rescue[i];
}

}  // namespace

// pref [P + k] uint8: one pad code (4), then the reference's codes;
// depth, avg [P] int32, site [P] bool; the map: words, dir, ov_keys,
// ov_values, m, bits (hashmap.cuh); -> snp_depth [P, k, 3] int32,
// snp_call [P, k, 3] bool, max_rescue [P] int32, del_depth [P, k] int32,
// del_call [P, k] bool.  route: 0 the packed route where k <= 32 and the
// byte-wise one above, 1 the byte-wise route.  Requires P >= 1, k >= 1.
extern "C" int rkmh_call_scan(const uint8_t* pref, long long P, int k, const int32_t* depth,
                              const int32_t* avg, const uint8_t* site, const int64_t* words,
                              const int32_t* dir, const int64_t* ov_keys,
                              const int32_t* ov_values, int m, int bits, int32_t* snp_depth,
                              uint8_t* snp_call, int32_t* max_rescue, int32_t* del_depth,
                              uint8_t* del_call, int route, cudaStream_t stream) {
  const Scan s{depth,
               avg,
               site,
               {reinterpret_cast<const uint64_t*>(words), dir,
                reinterpret_cast<const uint64_t*>(ov_keys), ov_values, m, bits},
               snp_depth,
               snp_call,
               max_rescue,
               del_depth,
               del_call};
  const int TP = std::max(1, VARIANTS_PER_BLOCK / (4 * k));
  const int64_t blocks = (P + TP - 1) / TP;
  if (route == 0 && k <= MAX_PACKED_K) {
    PACKED_KERNELS[k - 1]<<<(unsigned)blocks, THREADS, 0, stream>>>(pref, (int64_t)P, s);
    return (int)cudaGetLastError();
  }
  const size_t smem = 4 * (size_t)TP + TP + k;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(call_scan_bytewise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  call_scan_bytewise_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(pref, (int64_t)P, k,
                                                                          TP, s);
  return (int)cudaGetLastError();
}
