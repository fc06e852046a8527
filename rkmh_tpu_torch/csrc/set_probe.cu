// K3: fused hpv16 set-table probe — bucket probe, per-reference distinct
// counts and the type argmax, one block per read.
//
// There is no Pallas kernel for this in rkmh_tpu: XLA fuses it there.  It
// replaces the chain rkmh_tpu/classify/engine.py:751-758 (the occ ranks
// and bucket_indices of hpv16_comb_stage1) -> the bare row gather
// hpv16_split_gather (:635) -> hpv16_comb_finish (:772-791), i.e.
// ops/lookup.py::counts_from_rows (:341), the split of the counts into
// types [0, T) and unique-k-mer groups [T, T+U), and jnp.argmax / max over
// the types, so the [B, Wc, width] gathered rows and the [B, R] counts
// never reach device memory.  Output: int64 [B, 2+U] = first-max type,
// its count, then the U group counts (the JAX wire layout).
//
// Input rows are [B, n] uint64 sorted ascending (bottom_s_sketch over all
// windows, compacted to the first n columns) with lens [B]: valid = i <
// len and h != SENTINEL.  The table is a SET table: every entry has occ 0
// (ops/lookup.py::build_set_table), so only the first element of a run of
// equal hashes can hit; a later one carries occ > 0 and misses the (lo,
// occ) compare.  The kernel therefore probes only run starts, and finds a
// run start from row[i-1] alone: the previous lane's value by a shuffle,
// the previous iteration's last value from memory for lane 0.  The row is
// not staged in shared memory, so no read length is too long.
//
// What bounds it on the card: one random bucket-row access per distinct
// valid element into a table far larger than the 50 MB L2 (hpv16 at k=18:
// ~1.4M entries, S=12, Wm=7, rows of 480 B, 240-480 MB), so nearly every
// probe is an HBM miss.  The design loads only what it needs from that
// row: the S lo and the S occ lanes (2 * 48 B at S=12, all loads in flight
// before any compare), then, for a candidate slot, hi and the Wm mask
// words of that slot together (8 more 32 B sectors at Wm=7).  Per read of
// D distinct windows that is about D * (4 + 8 * hit rate) sectors of 32 B
// of HBM traffic.  Counting stays on chip: per warp, the OR of the 32
// lanes' mask words names the bits to count, one ballot per such bit
// gives the votes of 32 elements for one reference, and lane b adds the
// votes for bit b to a per-reference counter in shared memory.  One warp
// then takes the first-max argmax over the types.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MASK_CHUNK = 8;  // mask words loaded per batch of loads
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t SENTINEL = 0xFFFFFFFFFFFFFFFFULL;
constexpr uint32_t MIX = 0x85EBCA77u;
constexpr uint32_t MUL = 0x9E3779B1u;

__global__ void set_probe_kernel(const uint64_t* __restrict__ rows, int64_t row_stride,
                                 const int32_t* __restrict__ lens, int n,
                                 const uint32_t* __restrict__ table, int log2nb, int S,
                                 int Wm, int T, int U, int64_t* __restrict__ out) {
  extern __shared__ int cnt[];  // [32 * Wm] per-reference counters

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < 32 * Wm; r += blockDim.x) cnt[r] = 0;
  __syncthreads();

  const uint64_t* row = rows + (int64_t)b * row_stride;
  const int len = min(lens[b], n);
  const int width = S * (3 + Wm);

  // warp-uniform loop bound: every lane takes part in the shuffles and ballots
  for (int base = warp * 32; base < len; base += blockDim.x) {
    const int i = base + lane;
    const uint64_t h = i < len ? row[i] : SENTINEL;
    uint64_t prev = __shfl_up_sync(FULL, h, 1);
    if (lane == 0 && i > 0) prev = row[i - 1];
    const bool probe = i < len && h != SENTINEL && (i == 0 || prev != h);

    const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32);
    const uint32_t* trow = table;
    int slot = -1;
    if (probe) {
      const uint32_t x = (lo ^ (hi * MIX)) * MUL;  // bucket_indices at occ = 0
      trow = table + (size_t)(log2nb == 0 ? 0u : x >> (32 - log2nb)) * width;
      for (int s = 0; s < S; ++s) {
        const uint32_t l = __ldg(trow + S + s), o = __ldg(trow + 2 * S + s);
        if (slot < 0 && l == lo && o == 0u) slot = s;
      }
    }
    // hi is checked on the one candidate slot, loaded with its mask words
    const uint32_t slot_hi = slot >= 0 ? __ldg(trow + slot) : 0u;

    for (int w0 = 0; w0 < Wm; w0 += MASK_CHUNK) {
      uint32_t m[MASK_CHUNK];
#pragma unroll
      for (int j = 0; j < MASK_CHUNK; ++j)
        m[j] = slot >= 0 && w0 + j < Wm ? __ldg(trow + (3 + w0 + j) * S + slot) : 0u;
      const bool ok = slot >= 0 && slot_hi == hi;
#pragma unroll
      for (int j = 0; j < MASK_CHUNK; ++j) {
        if (w0 + j >= Wm) break;  // warp-uniform
        const uint32_t mj = ok ? m[j] : 0u;
        uint32_t bits = __reduce_or_sync(FULL, mj);
        int mine = 0;  // lane `bit` keeps the vote count of bit `bit`
        while (bits) {
          const int bit = __ffs(bits) - 1;
          bits &= bits - 1;
          const int votes = __popc(__ballot_sync(FULL, (mj >> bit) & 1u));
          if (lane == bit) mine = votes;
        }
        if (mine) atomicAdd(&cnt[32 * (w0 + j) + lane], mine);
      }
    }
  }
  __syncthreads();

  if (warp != 0) return;
  // jnp.argmax over the types: the first maximal index (0 when all are 0)
  int mx = -1, best = INT_MAX;
  for (int r = lane; r < T; r += 32) {
    if (cnt[r] > mx) {
      mx = cnt[r];
      best = r;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int omx = __shfl_down_sync(FULL, mx, off);
    const int obest = __shfl_down_sync(FULL, best, off);
    if (omx > mx || (omx == mx && obest < best)) {
      mx = omx;
      best = obest;
    }
  }
  int64_t* o = out + (int64_t)b * (2 + U);
  if (lane == 0) {
    o[0] = best;
    o[1] = mx;
  }
  for (int u = lane; u < U; u += 32) o[2 + u] = cnt[T + u];
}

}  // namespace

// rows [B, n] uint64 (row stride row_stride elements, sorted), lens [B]
// int32, table [2^log2nb, S*(3+Wm)] uint32 holding occ-0 entries only ->
// out [B, 2+U] int64.  Requires B >= 1, T >= 1 and T + U <= 32 * Wm.
extern "C" int rkmh_set_probe(const int64_t* rows, int64_t row_stride, const int32_t* lens,
                              int B, int n, const int32_t* table, int log2nb, int S, int Wm,
                              int T, int U, int64_t* out, cudaStream_t stream) {
  const size_t smem = (size_t)Wm * 32 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(set_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  set_probe_kernel<<<B, THREADS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), row_stride, lens, n,
      reinterpret_cast<const uint32_t*>(table), log2nb, S, Wm, T, U, out);
  return (int)cudaGetLastError();
}
