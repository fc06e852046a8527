// K2: fused panel probe — ranks, bucket probe, per-reference counts and
// the stream argmax, one block per read.
//
// There is no Pallas kernel for this in rkmh_tpu: XLA fuses it there.  It
// replaces the chain rkmh_tpu/classify/engine.py:306-311 (prefix-equality
// ranks) or ops/intersect.py::occ_ranks -> ops/lookup.py::bucket_indices
// -> the row gather (lookup.py:337) -> counts_from_rows -> ops/popcount.py
// ::vertical_popcounts -> classify/engine.py::argmax_stream, so that the
// [B, n, width] gathered rows and the [B, R] counts never reach device
// memory.  Output: int32 [3, B] = best ref, shared count, flag bits
// diff_ok | depth_fail << 1 | match_fail << 2.
//
// Input rows are [B, n] uint64, in one of two modes:
//   (a) lens == NULL: raw window hashes (used when W <= s); valid = h != 0,
//       occ = number of equal elements earlier in the row (O(n^2), so the
//       caller keeps n small);
//   (b) lens != NULL: sorted bottom-s sketches; valid = i < len and
//       h != SENTINEL, occ = i - start of the run of equal values.
// Both give the same (hash, occ) multiset, hence the same counts.
//
// What bounds it on the card: random row loads from the table (one bucket
// row of S*(3+Wm) u32 per valid element, 80 B at S=4, Wm=2; the zika table
// is ~40 MB, so most loads miss L1 and many miss L2).  The design loads
// only what it needs from that row: the S lo and S occ lanes for the
// compare, then hi and the Wm mask words of the one matching slot.  The
// read's row sits in shared memory; counting stays on chip: per warp, a
// ballot per mask bit gives 32 elements' votes for one reference, and
// lane b adds the count for bit b to a per-reference counter in shared
// memory (one atomic per lane per mask word, no cross-thread contention
// on one address).  One warp then runs the argmax with argmax_stream's
// exact semantics.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t SENTINEL = 0xFFFFFFFFFFFFFFFFULL;
constexpr uint32_t MIX = 0x85EBCA77u;
constexpr uint32_t MUL = 0x9E3779B1u;

__global__ void panel_probe_kernel(const uint64_t* __restrict__ rows,
                                   const int32_t* __restrict__ lens, int B, int n,
                                   const uint32_t* __restrict__ table, int log2nb,
                                   int S, int Wm, int R, int min_diff,
                                   int min_matches, int32_t* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  uint64_t* row = reinterpret_cast<uint64_t*>(smem);   // [n]
  int* cnt = reinterpret_cast<int*>(row + n);          // [32 * Wm]
  __shared__ int n_valid;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint64_t* src = rows + (int64_t)b * n;
  for (int j = tid; j < n; j += blockDim.x) row[j] = src[j];
  for (int r = tid; r < 32 * Wm; r += blockDim.x) cnt[r] = 0;
  if (tid == 0) n_valid = 0;
  __syncthreads();

  const bool sorted_mode = lens != nullptr;
  const int len = sorted_mode ? lens[b] : 0;
  const int width = S * (3 + Wm);
  int my_valid = 0;

  // warp-uniform loop bound: every lane takes part in the ballots
  for (int base = warp * 32; base < n; base += blockDim.x) {
    const int i = base + lane;
    bool valid = false;
    uint32_t occ = 0;
    uint64_t h = 0;
    if (i < n) {
      h = row[i];
      // ranks only for valid elements: padding runs would cost O(n^2)
      if (sorted_mode) {
        valid = i < len && h != SENTINEL;
        int j = i;
        while (valid && j > 0 && row[j - 1] == h) --j;
        occ = (uint32_t)(i - j);
      } else {
        valid = h != 0;
        for (int j = 0; valid && j < i; ++j) occ += row[j] == h;
      }
    }
    my_valid += valid;

    const uint32_t* trow = nullptr;
    int slot = -1;
    if (valid) {
      const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32);
      const uint32_t x = (lo ^ (hi * MIX) ^ (occ * MIX)) * MUL;
      const uint32_t bucket = log2nb == 0 ? 0u : x >> (32 - log2nb);
      trow = table + (size_t)bucket * width;
      for (int s = 0; s < S; ++s) {
        if (__ldg(trow + S + s) == lo && __ldg(trow + 2 * S + s) == occ) {
          slot = s;
          break;
        }
      }
      if (slot >= 0 && __ldg(trow + slot) != hi) slot = -1;
    }

    for (int w = 0; w < Wm; ++w) {
      const uint32_t m = slot >= 0 ? __ldg(trow + (3 + w) * S + slot) : 0u;
      if (__ballot_sync(FULL, m != 0) == 0) continue;  // warp-uniform
      int mine = 0;  // lane `bit` keeps the vote count of bit `bit`
      for (int bit = 0; bit < 32; ++bit) {
        const int votes = __popc(__ballot_sync(FULL, (m >> bit) & 1u));
        if (lane == bit) mine = votes;
      }
      if (mine) atomicAdd(&cnt[32 * w + lane], mine);
    }
  }

  for (int off = 16; off > 0; off >>= 1) my_valid += __shfl_down_sync(FULL, my_valid, off);
  if (lane == 0 && my_valid) atomicAdd(&n_valid, my_valid);
  __syncthreads();

  if (warp != 0) return;
  // argmax_stream: running max from -1, strict > (first ref wins ties)
  int mx = -1, best = INT_MAX;
  for (int r = lane; r < R; r += 32) {
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
  mx = __shfl_sync(FULL, mx, 0);
  best = __shfl_sync(FULL, best, 0);
  // previous best: max(-1, max(counts[:best]))
  int pm = -1;
  for (int r = lane; r < best; r += 32) pm = max(pm, cnt[r]);
  for (int off = 16; off > 0; off >>= 1) pm = max(pm, __shfl_down_sync(FULL, pm, off));
  if (lane == 0) {
    const int sk_len = sorted_mode ? len : n_valid;
    const int flags = ((mx - pm) > min_diff ? 1 : 0) | (sk_len <= min_matches ? 2 : 0) |
                      (mx < min_matches ? 4 : 0);
    out[b] = best;
    out[B + b] = mx;
    out[2 * B + b] = flags;
  }
}

}  // namespace

// rows [B, n] uint64, lens [B] int32 or NULL, table [2^log2nb, S*(3+Wm)]
// uint32 -> out [3, B] int32.  Requires B >= 1, 1 <= R <= 32 * Wm and the
// shared memory n * 8 + Wm * 128 bytes within the per-block limit.
extern "C" int rkmh_panel_probe(const int64_t* rows, const int32_t* lens, int B, int n,
                                const int32_t* table, int log2nb, int S, int Wm, int R,
                                int min_diff, int min_matches, int32_t* out,
                                cudaStream_t stream) {
  const size_t smem = (size_t)n * 8 + (size_t)Wm * 32 * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(panel_probe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  panel_probe_kernel<<<B, THREADS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), lens, B, n,
      reinterpret_cast<const uint32_t*>(table), log2nb, S, Wm, R, min_diff,
      min_matches, out);
  return (int)cudaGetLastError();
}
