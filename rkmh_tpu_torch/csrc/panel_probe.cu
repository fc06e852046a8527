// K2: fused panel probe — ranks, bucket probe, per-reference counts and
// the stream argmax, one warp per read.
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
// The filter mode (rkmh_panel_probe_filter) runs the same probe with the
// epilogue of classify/engine.py::argmax_filter (:56) and the packing of
// filter_sketches_table_packed (:886): the running max starts at 0 (best
// = -1, shared = 0 when every count is 0), total_union = min(sketch_len,
// ref_lens[best]) when some count is > 0, depth_fail = sketch_len <= 0.
// Output: int32 [5, B] = best, shared, total_union, keep, flag bits
// depth_fail | match_fail << 1 | diff_ok << 2.
//
// Input rows are [B, n] uint64, in one of two modes:
//   (a) lens == NULL: raw window hashes (used when W <= s); valid = h != 0,
//       occ = a rank among the equal elements of the row;
//   (b) lens != NULL: sorted bottom-s sketches; valid = i < len and
//       h != SENTINEL, occ = i - start of the run of equal values.
// The counts depend only on the multiset of (hash, occ) pairs, so in (a)
// equal hashes may take ranks 0..c-1 in any order: each warp keeps an
// open-addressing table in shared memory (3n slots where they fit, else n,
// which still holds every distinct value; 8 bytes a slot).  An element
// claims or finds its value's slot in rounds of plain loads and stores
// between __syncwarp barriers (insert_rank; an atomicCAS per element was
// the kernel's largest cost); the claimant takes rank 0 and a later equal
// element takes 1 + an atomicAdd on the slot's count.  A slot's key
// carries a fingerprint of its value beside the claimant's index, so
// meeting another value's slot costs no row read.  In (b) a run start is
// a change from the previous element (a shuffle, and the previous step's
// last element), found for 32 elements by one ballot.  Both are O(1) per
// element.
//
// What bounds it on the card: the random bucket-row loads (one row of
// S*(3+Wm) u32 per valid element, 80 B at S=4, Wm=2; the zika table is
// [131072, 20] int32 = 10.5 MB and stays in the 50 MB L2), the ranks
// table's shared-memory atomics and the instructions per element.  One
// warp handles one read, several reads per block, with no block barrier:
// the read's ranks table is the warp's own, and the next 32 elements load
// while this step runs.  The probe takes two dependent trips: the S lo and
// S occ lanes of the bucket row (as uint4s where S % 4 == 0), then hi and
// the mask words of the matching slot together.  For R <= 256 (Wm <= 8)
// lane r keeps the counts of references r, r+32, ... in registers (2 or 8,
// by Wm); a ballot names the lanes that hit, and for each hit the warp
// broadcasts its Wm mask words by shuffles and lane r adds bit r of each.
// A read hits ~12 of its ~137 valid hashes on the zika batch (PERF.md), so
// that is a few dozen shuffles per read.  For R > 256 the counters are the
// warp's own columns in shared memory and each hit's mask words come in by
// one load per lane and a shuffle each.  The argmax runs as warp shuffles
// over the counters.

// K11 (rkmh_panel_probe_wide) is the same kernel for any R, used past the
// 8,192 references whose counters fit a warp's share of shared memory.
// It replaces the same chain at R > 8192 (ops/lookup.py:341
// counts_from_rows -> classify/engine.py:45 argmax_stream or :56
// argmax_filter), in both row modes and both epilogues.  It holds no
// counter per reference: the ranks and the probe are K2's, and the warp
// appends each hit's bucket and slot to a list of at most n in its shared
// memory.  The epilogue then takes 32 mask words (1,024 references) a
// pass, lane l word w0 + l: its 32 counts, in registers, are the column
// sums of that word over the hits.  Each pass reduces to (max, first
// argmax, max before it) in reference order across the lanes, and joins
// the running state: a right part whose max is strictly greater wins, and
// the max before its argmax is then the larger of the left part's max and
// its own.  That is argmax_stream's first max and previous best exactly,
// for any R.  What bounds it: each hit's Wm mask words, one sector apiece
// at the table's slot-major stride (S words apart), so a read costs about
// hits x Wm random sectors.  A layout with a hit's mask words contiguous
// would cut that to hits x Wm / 8 sectors: later work.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 8;         // reads per block
constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory on sm_90
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t SENTINEL = 0xFFFFFFFFFFFFFFFFULL;
constexpr uint32_t MIX = 0x85EBCA77u;
constexpr uint32_t MUL = 0x9E3779B1u;

// A ranks-table slot: key = (index + 1 of the element that claimed it) <<
// FP_BITS | a fingerprint of its value, so a probe that meets another
// value's slot moves on without reading the row (indices < 2^15 - 1).
constexpr int FP_BITS = 17;
constexpr uint32_t FP_MASK = (1u << FP_BITS) - 1;

// One warp step's inserts into the ranks table, all lanes together.  A
// lane with `active` inserts element i of row, of value h (nslots >= the
// row's distinct valid values, so its probe ends).  Each round a lane
// reads its slot and, if it is empty, claims it with a plain store; after
// __syncwarp every lane reads its slot again, and only that second read
// decides: its own key (it won the slot), its value's key (fingerprint,
// then the row), or another value's (next slot).  No store lands between
// the two barriers, so a slot never changes owner.  -> the element's
// rank: 0 for the claimant; equal values, rare in a row, take 1 + an
// atomicAdd on the slot's count of ranks >= 1 handed out.
__device__ __forceinline__ int insert_rank(uint32_t* keys, int* cnt, int nslots,
                                           const uint64_t* row, uint64_t h, int i,
                                           bool active) {
  const uint64_t mix = h * 0x9E3779B97F4A7C15ULL;
  const uint32_t fp = (uint32_t)mix & FP_MASK;
  const uint32_t key = ((uint32_t)(i + 1) << FP_BITS) | fp;
  uint32_t s = (uint32_t)(((mix >> 32) * (uint32_t)nslots) >> 32);
  bool pending = active;
  int r = 0;
  while (__any_sync(FULL, pending)) {
    if (pending && keys[s] == 0) keys[s] = key;
    __syncwarp();
    if (pending) {
      const uint32_t now = keys[s];
      if (now == key) {
        pending = false;
      } else if ((now & FP_MASK) == fp && __ldg(row + (now >> FP_BITS) - 1) == h) {
        pending = false;
        r = atomicAdd(&cnt[s], 1) + 1;
      } else if (++s == (uint32_t)nslots) {
        s = 0;
      }
    }
    __syncwarp();
  }
  return r;
}

// MAXW > 0: the counters of references lane + 32 w, w < Wm <= MAXW, in
// registers; MAXW == 0: in the warp's shared memory; MAXW == WIDE (K11):
// none, the read's hits are listed in the warp's shared memory and counted
// word by word in the epilogue.
constexpr int WIDE = -1;

template <bool FILTER, int MAXW>
__global__ void __launch_bounds__(32 * MAX_WARPS)
panel_probe_kernel(const uint64_t* __restrict__ rows, const int32_t* __restrict__ lens, int B,
                   int n, const uint32_t* __restrict__ table, int log2nb, int S, int Wm, int R,
                   const int32_t* __restrict__ ref_lens, int min_diff, int min_matches,
                   int nslots, int32_t* __restrict__ out) {
  constexpr bool REGS = MAXW > 0;
  constexpr bool LIST = MAXW == WIDE;
  constexpr int NW = REGS ? MAXW : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: nothing below waits for the block

  const size_t per_warp =
      (size_t)nslots * 8 + (REGS ? 0 : LIST ? (size_t)n * 8 : (size_t)Wm * 128);
  unsigned char* mine = smem + warp * per_warp;
  uint32_t* keys = reinterpret_cast<uint32_t*>(mine);                 // [nslots] ranks table
  int* cnt = reinterpret_cast<int*>(mine + (size_t)nslots * 4);       // [nslots]
  int* scnt = reinterpret_cast<int*>(mine + (size_t)nslots * 8);      // [Wm][32] counters
  uint32_t* hit_bucket = reinterpret_cast<uint32_t*>(scnt);           // LIST: [n] hits
  int* hit_slot = scnt + n;                                           // LIST: [n]
  int nhits = 0;                                                      // LIST, warp-uniform
  for (int j = lane; j < nslots; j += 32) {
    keys[j] = 0;
    cnt[j] = 0;
  }
  if (!REGS && !LIST)
    for (int j = lane; j < 32 * Wm; j += 32) scnt[j] = 0;
  __syncwarp();

  int rc[NW];  // REGS: the lane's counters
#pragma unroll
  for (int w = 0; w < NW; ++w) rc[w] = 0;

  const uint64_t* row = rows + (int64_t)b * n;
  const bool sorted_mode = lens != nullptr;
  const int len = sorted_mode ? lens[b] : 0;
  const int width = S * (3 + Wm);
  const uint64_t pad = sorted_mode ? SENTINEL : 0;  // what lanes past n hold
  int my_valid = 0;
  uint64_t carry_h = 0;  // sorted mode: the previous step's last element
  int carry_start = 0;   // and the start of its run

  uint64_t h_next = lane < n ? row[lane] : pad;  // loaded one step ahead
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const uint64_t h = h_next;
    h_next = i + 32 < n ? row[i + 32] : pad;

    bool valid;
    int occ = 0;
    if (sorted_mode) {
      uint64_t prev = __shfl_up_sync(FULL, h, 1);
      if (lane == 0) prev = carry_h;
      const unsigned starts = __ballot_sync(FULL, i == 0 || prev != h);
      const unsigned le = starts & (FULL >> (31 - lane));
      const int run_start = le ? base + 31 - __clz(le) : carry_start;
      occ = i - run_start;
      valid = i < len && h != SENTINEL;
      carry_h = __shfl_sync(FULL, h, 31);
      carry_start = __shfl_sync(FULL, run_start, 31);
    } else {
      valid = h != 0;  // padding lanes carry 0
      occ = insert_rank(keys, cnt, nslots, row, h, i, valid);
    }
    my_valid += valid;

    // first trip: the S lo and S occ lanes of the bucket row; second: hi
    // and (register counters) the Wm mask words of the matching slot
    const uint32_t* trow = table;
    uint32_t bucket = 0;
    int slot = -1;
    uint32_t m[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) m[w] = 0;
    if (valid) {
      const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32), o = (uint32_t)occ;
      const uint32_t x = (lo ^ (hi * MIX) ^ (o * MIX)) * MUL;
      bucket = log2nb == 0 ? 0u : x >> (32 - log2nb);
      trow = table + (size_t)bucket * width;
      if ((S & 3) == 0) {  // 16-byte aligned lane groups: S/4 uint4 loads each
        for (int s4 = 0; s4 < S && slot < 0; s4 += 4) {
          const uint4 l = __ldg(reinterpret_cast<const uint4*>(trow + S + s4));
          const uint4 c = __ldg(reinterpret_cast<const uint4*>(trow + 2 * S + s4));
          slot = l.x == lo && c.x == o   ? s4
                 : l.y == lo && c.y == o ? s4 + 1
                 : l.z == lo && c.z == o ? s4 + 2
                 : l.w == lo && c.w == o ? s4 + 3
                                         : -1;
        }
      } else {
        for (int s = 0; s < S; ++s) {
          if (__ldg(trow + S + s) == lo && __ldg(trow + 2 * S + s) == o) {
            slot = s;
            break;
          }
        }
      }
      if (slot >= 0) {
        const uint32_t slot_hi = __ldg(trow + slot);
        if constexpr (REGS) {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (w < Wm) m[w] = __ldg(trow + (3 + w) * S + slot);
        }
        if (slot_hi != hi) slot = -1;
      }
    }

    // count the hits: lane r adds bit r of each hit's mask words
    unsigned hits = __ballot_sync(FULL, slot >= 0);
    if constexpr (LIST) {
      if (slot >= 0) {
        const int at = nhits + __popc(hits & ((1u << lane) - 1u));
        hit_bucket[at] = bucket;
        hit_slot[at] = slot;
      }
      nhits += __popc(hits);
    } else if constexpr (REGS) {
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (w < Wm) rc[w] += (__shfl_sync(FULL, m[w], src) >> lane) & 1u;
      }
    } else {
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const uint32_t* srow = reinterpret_cast<const uint32_t*>(
            __shfl_sync(FULL, reinterpret_cast<unsigned long long>(trow), src));
        const int sslot = __shfl_sync(FULL, slot, src);
        for (int w0 = 0; w0 < Wm; w0 += 32) {
          const uint32_t mw = w0 + lane < Wm ? __ldg(srow + (3 + w0 + lane) * S + sslot) : 0u;
          for (int j = 0; j < 32 && w0 + j < Wm; ++j)
            scnt[32 * (w0 + j) + lane] += (__shfl_sync(FULL, mw, j) >> lane) & 1u;
        }
      }
    }
  }
  const int n_valid = __reduce_add_sync(FULL, my_valid);

  // running max from -1 (stream) or 0 (filter), strict > (first ref wins
  // ties); best stays INT_MAX in filter mode when every count is 0; pm,
  // the previous best: max(init, max(counts[:best]))
  const int init = FILTER ? 0 : -1;
  int mx = init, best = INT_MAX, pm = init;
  if constexpr (LIST) {
    __syncwarp();  // the hit list is the whole warp's
    // 32 words (1,024 references) a pass, lane w0 + lane's 32 counts in
    // registers, each a column sum over the hits' word; a pass's (max,
    // first argmax, max before it) joins the running one in reference
    // order: a right part whose max is strictly greater wins, and the max
    // before it is then the larger of the left max and its own
    for (int w0 = 0; w0 < Wm; w0 += 32) {
      const int w = w0 + lane;
      int c[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) c[j] = 0;
      if (w < Wm) {
        for (int h = 0; h < nhits; ++h) {
          const uint32_t m =
              __ldg(table + (size_t)hit_bucket[h] * width + (3 + w) * S + hit_slot[h]);
#pragma unroll
          for (int j = 0; j < 32; ++j) c[j] += (m >> j) & 1u;
        }
      }
      int smx = init, sbest = INT_MAX, sbefore = init;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (32 * w + j < R && c[j] > smx) {
          sbefore = smx;
          smx = c[j];
          sbest = 32 * w + j;
        }
      }
      for (int off = 1; off < 32; off <<= 1) {  // lane 0 ends with the pass's state
        const int omx = __shfl_down_sync(FULL, smx, off);
        const int obest = __shfl_down_sync(FULL, sbest, off);
        const int obefore = __shfl_down_sync(FULL, sbefore, off);
        if (lane + off < 32 && omx > smx) {
          sbefore = max(smx, obefore);
          smx = omx;
          sbest = obest;
        }
      }
      smx = __shfl_sync(FULL, smx, 0);
      sbest = __shfl_sync(FULL, sbest, 0);
      sbefore = __shfl_sync(FULL, sbefore, 0);
      if (smx > mx) {
        pm = max(mx, sbefore);
        mx = smx;
        best = sbest;
      }
    }
  } else {
    // f(reference, count) over the lane's references in ascending order
    auto each_count = [&](auto&& f) {
      if constexpr (REGS) {
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (w < Wm) f(32 * w + lane, rc[w]);
      } else {
        for (int w = 0; w < Wm; ++w) f(32 * w + lane, scnt[32 * w + lane]);
      }
    };
    each_count([&](int r, int c) {
      if (r < R && c > mx) {
        mx = c;
        best = r;
      }
    });
    for (int off = 16; off > 0; off >>= 1) {
      const int omx = __shfl_xor_sync(FULL, mx, off);
      const int obest = __shfl_xor_sync(FULL, best, off);
      if (omx > mx || (omx == mx && obest < best)) {
        mx = omx;
        best = obest;
      }
    }
    each_count([&](int r, int c) {
      if (r < R && r < best) pm = max(pm, c);
    });
    pm = __reduce_max_sync(FULL, pm);
  }
  if (lane != 0) return;
  const int sk_len = sorted_mode ? len : n_valid;
  if (FILTER) {
    const bool updated = mx > 0;
    const int shared = updated ? mx : 0;
    const bool diff_ok = shared - (updated ? pm : 0) > min_diff;
    const bool depth_fail = sk_len <= 0;
    const bool match_fail = shared < min_matches;
    out[b] = updated ? best : -1;
    out[B + b] = shared;
    out[2 * B + b] = updated ? min(sk_len, ref_lens[best]) : 0;
    out[3 * B + b] = !depth_fail && !match_fail && diff_ok;
    out[4 * B + b] = (depth_fail ? 1 : 0) | (match_fail ? 2 : 0) | (diff_ok ? 4 : 0);
  } else {
    out[b] = best;
    out[B + b] = mx;
    out[2 * B + b] = ((mx - pm) > min_diff ? 1 : 0) | (sk_len <= min_matches ? 2 : 0) |
                     (mx < min_matches ? 4 : 0);
  }
}

template <bool FILTER, int MAXW>
int launch_variant(int warps, size_t smem, const int64_t* rows, const int32_t* lens, int B,
                   int n, const int32_t* table, int log2nb, int S, int Wm, int R,
                   const int32_t* ref_lens, int min_diff, int min_matches, int nslots,
                   int32_t* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(panel_probe_kernel<FILTER, MAXW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  panel_probe_kernel<FILTER, MAXW><<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), lens, B, n,
      reinterpret_cast<const uint32_t*>(table), log2nb, S, Wm, R, ref_lens, min_diff,
      min_matches, nslots, out);
  return (int)cudaGetLastError();
}

// The layout from the shapes: the counters in 2 registers (R <= 64), in 8
// (R <= 256) or in shared memory; K11 (wide) none, a list of n hits; in
// raw mode 3n ranks slots per warp (2n and 4n were slower on the zika
// batch), or n where 3n do not fit one warp's share; as many warps per
// block (<= MAX_WARPS) as fit.
template <bool FILTER>
int launch(const int64_t* rows, const int32_t* lens, int B, int n, const int32_t* table,
           int log2nb, int S, int Wm, int R, const int32_t* ref_lens, int min_diff,
           int min_matches, int32_t* out, cudaStream_t stream, bool wide = false) {
  if (lens == nullptr && n >= (1 << (32 - FP_BITS)) - 1) return (int)cudaErrorInvalidValue;
  const size_t cnt_bytes = wide ? (size_t)n * 8 : Wm <= 8 ? 0 : (size_t)Wm * 128;
  int nslots = lens == nullptr ? 3 * n : 0;
  if ((size_t)nslots * 8 + cnt_bytes > SMEM_MAX) nslots = n;
  const size_t per_warp = (size_t)nslots * 8 + cnt_bytes;
  if (per_warp > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int warps =
      per_warp == 0 ? MAX_WARPS : (int)std::min<size_t>(MAX_WARPS, SMEM_MAX / per_warp);
  const size_t smem = per_warp * warps;
  auto go = [&](auto maxw) {
    return launch_variant<FILTER, decltype(maxw)::value>(
        warps, smem, rows, lens, B, n, table, log2nb, S, Wm, R, ref_lens, min_diff,
        min_matches, nslots, out, stream);
  };
  return wide      ? go(std::integral_constant<int, WIDE>())
         : Wm <= 2 ? go(std::integral_constant<int, 2>())
         : Wm <= 8 ? go(std::integral_constant<int, 8>())
                   : go(std::integral_constant<int, 0>());
}

}  // namespace

// rows [B, n] uint64, lens [B] int32 or NULL, table [2^log2nb, S*(3+Wm)]
// uint32 -> out [3, B] int32.  Requires B >= 1, 1 <= R <= 32 * Wm and, in
// raw mode, n * 8 (+ Wm * 128 when Wm > 8) bytes within the block limit.
extern "C" int rkmh_panel_probe(const int64_t* rows, const int32_t* lens, int B, int n,
                                const int32_t* table, int log2nb, int S, int Wm, int R,
                                int min_diff, int min_matches, int32_t* out,
                                cudaStream_t stream) {
  return launch<false>(rows, lens, B, n, table, log2nb, S, Wm, R, nullptr, min_diff,
                       min_matches, out, stream);
}

// The filter mode: as rkmh_panel_probe, plus ref_lens [R] int32 (the
// references' sketch lengths) -> out [5, B] int32.
extern "C" int rkmh_panel_probe_filter(const int64_t* rows, const int32_t* lens, int B,
                                       int n, const int32_t* table, int log2nb, int S,
                                       int Wm, int R, const int32_t* ref_lens,
                                       int min_diff, int min_matches, int32_t* out,
                                       cudaStream_t stream) {
  return launch<true>(rows, lens, B, n, table, log2nb, S, Wm, R, ref_lens, min_diff,
                      min_matches, out, stream);
}

// K11, the wide route for any R (past the 8,192 references whose counters
// fit shared memory): the arguments of rkmh_panel_probe_filter, with
// ref_lens NULL for the stream epilogue (out [3, B]) and given for the
// filter one (out [5, B]).  Requires B >= 1, 1 <= R <= 32 * Wm and n * 8
// bytes (+ n * 8 in raw mode) within the block limit.
extern "C" int rkmh_panel_probe_wide(const int64_t* rows, const int32_t* lens, int B, int n,
                                     const int32_t* table, int log2nb, int S, int Wm, int R,
                                     const int32_t* ref_lens, int min_diff, int min_matches,
                                     int32_t* out, cudaStream_t stream) {
  if (ref_lens == nullptr) {
    return launch<false>(rows, lens, B, n, table, log2nb, S, Wm, R, nullptr, min_diff,
                         min_matches, out, stream, true);
  }
  return launch<true>(rows, lens, B, n, table, log2nb, S, Wm, R, ref_lens, min_diff,
                      min_matches, out, stream, true);
}
