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
// The partial mode (rkmh_panel_probe_partial) is the epilogue of one tp
// shard of a sharded panel (rkmh_tpu/parallel/mesh.py:120-169, where the
// shards' counts are all_gather'd before argmax_stream / argmax_filter):
// the same probe over the shard's R references, then the running max from
// `init` (-1 for stream, 0 for filter) without the flags.  Output: int32
// [4, B] = local best (INT_MAX where no count is above init), max count,
// max(init, max(counts[:best])) and the sketch length;
// parallel/mesh.merge_tp_partials joins the shards' rows exactly.  It
// serves every route of K2 and K11 (rkmh_panel_probe_partial's mask_rows).
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
// [131072, 20] int32 = 10.5 MB and stays inside the ~24 MB of L2 that every
// SM reads at random at the cache's rate, bench/l2_sweep.py), the ranks
// table's shared-memory atomics and the instructions per element.  One
// warp handles one read, several reads per block, with no block barrier:
// the read's ranks table is the warp's own, and the next 32 elements load
// while this step runs.  The probe takes two dependent trips: the S lo and
// S occ lanes of the bucket row (as uint4s where S % 4 == 0), then hi and
// the mask words of the matching slot together.  At S = 2, the narrow slot
// policy's first choice and the geometry of a tp shard of few references
// (30 a shard of the zika panel at tp = 2), the row is [hi0 hi1 | lo0 lo1 |
// occ0 occ1 | mask words in pairs] with every pair 8-byte aligned: the lo
// and occ pairs come as two uint2s issued together, both slots compared at
// once, and hi and the mask words of a match as pairs in the second trip;
// at S = 2 and Wm = 1 the row is 32 bytes, one sector, and comes whole as
// two uint4s in the first trip, so a probe is one L2 trip, hit or miss.
// Other S, which only RKMH_TPU_SLOTS gives a K2 table, compare lane by
// lane.  The partial epilogue costs what
// the stream one does (the same running max over the lane's counters and
// warp shuffles) and one more word out a read.  For R <= 256 (Wm <= 8)
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
// counter per reference: the ranks are K2's, and the warp appends each
// hit's entry id to a list of at most n in its shared memory.  It reads
// the table in a layout of its own (ops/probe.pack_wide_table, made once
// per run on the host, and the only form copied to the card): per slot
// one 16-byte record (lo, occ, hi, entry id), so the probe's first trip
// loads the bucket's records together (S <= 8: one trip) and finds the
// slot whose lo and occ match and checks its hi; and the mask words of
// the E occupied slots as contiguous rows [E, P], P = 32 * ceil(Wm / 32),
// 128-byte aligned (at 12,288 references: 42 MB in place of the logical
// table's 406 MB).  In the logical table a hit's Wm words lie S words
// apart, one sector each (Wm sectors a hit: the first K11's cost).  The
// epilogue takes 128 mask words (4,096 references) a pass: lane l loads
// words w0 + 4l .. + 3 of each hit's row in one 16-byte load, so the warp
// reads 512 contiguous bytes a hit and pass, and keeps the 32 counts of
// each of its words as bit planes (bit j of plane p is bit p of a
// reference's count; a hit's word is added by a ripple carry, two
// operations a plane, with 4 or 8 planes as the read's hit count needs,
// 16 with one word a lane).  A lane finds the max, first argmax and max
// before it of its 128 references from the planes, from the top plane
// down; the pass joins the lanes by two warp reductions (a key max << 12
// | (4095 - index), then the max before the winner), and the running
// state: a pass whose max is strictly greater wins, and the max before
// its argmax is then the larger of the running max and its own.  That is
// argmax_stream's first max and previous best exactly, for any R.  One
// word a lane and a five-level shuffle join a pass (1,024 references)
// took 1.6x as long on the 12,288-reference stream batch (PERF.md).

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
// registers; MAXW == 0: in the warp's shared memory; MAXW == WIDE or
// WIDE16 (K11): none, the read's hits are listed in the warp's shared
// memory and counted in the epilogue in bit planes, at most 8 (rows of
// fewer than 256 elements: counts < 2^8) or 16 of them.
constexpr int WIDE = -1;
constexpr int WIDE16 = -2;
constexpr int WPL = 4;          // K11: mask words a lane counts a pass (one 16-byte load a hit)
constexpr int SLOT_LOADS = 8;   // K11: slot records loaded together (a bucket of S <= 8 at once)

// K11: W consecutive mask words in one load (p aligned to 4 * W bytes).
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&m)[W]) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    m[0] = v.x;
    m[1] = v.y;
    m[2] = v.z;
    m[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    m[0] = v.x;
    m[1] = v.y;
  } else {
    m[0] = __ldg(p);
  }
}

// K11: the largest count among the references in cand (bits of one word
// whose counts are the bit planes c[0..P), bit j of plane p being bit p
// of reference j's count), and -> the references that hold it.
template <int P>
__device__ __forceinline__ uint32_t planes_top(const uint32_t (&c)[P], uint32_t cand,
                                               int& value) {
  value = 0;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const uint32_t x = c[p] & cand;
    if (x) {
      cand = x;
      value |= 1 << p;
    }
  }
  return cand;
}

// K11's pass over the lane's W mask words w .. w + W - 1 of the read's
// nhits entries: their counts as bit planes (a hit's word added by a
// ripple carry), then the lane's (max, first argmax, max before it) over
// its 32 * W references in order, those < R only, as a scan from a
// running max of init takes them (a reference wins on a strictly greater
// count): lbest -1 when none is above init; lbest is the reference's
// index among the lane's.
template <int P, int W>
__device__ __forceinline__ void wide_pass(const uint32_t* __restrict__ mask_rows,
                                          int row_words, const int* hit_entry, int nhits,
                                          int w, int R, int init, int& lmx, int& lbest,
                                          int& lbefore) {
  uint32_t c[W][P];
#pragma unroll
  for (int q = 0; q < W; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p) c[q][p] = 0u;
  for (int h0 = 0; h0 < nhits; h0 += 4) {  // four rows' loads in flight
    uint32_t m[4][W];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (h0 + u < nhits && w < row_words) {
        load_words<W>(mask_rows + (size_t)hit_entry[h0 + u] * row_words + w, m[u]);
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) m[u][q] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        uint32_t carry = m[u][q];
#pragma unroll
        for (int p = 0; p < P; ++p) {  // counts < 2^P: no carry out of the top plane
          const uint32_t t = c[q][p] & carry;
          c[q][p] ^= carry;
          carry = t;
        }
      }
    }
  }
  // the running max over the words in order; pre: the max before word qb
  lmx = init;
  lbest = -1;
  int pre = init, qb = 0;
  uint32_t at = 0u, vb = 0u;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int first = 32 * (w + q);
    const uint32_t valid = first >= R ? 0u : R - first >= 32 ? FULL : (1u << (R - first)) - 1u;
    int v;
    const uint32_t here = planes_top<P>(c[q], valid, v);
    if (valid && v > lmx) {
      pre = lmx;
      lmx = v;
      qb = q;
      at = here;
      vb = valid;
    }
  }
  lbefore = init;
  if (at) {
    const int j = __ffs(at) - 1;
    const uint32_t below = vb & ((1u << j) - 1u);
    int bmx = init;
#pragma unroll
    for (int q = 0; q < W; ++q) {  // c[qb] without indexing the planes at run time
      if (q == qb && below) planes_top<P>(c[q], below, bmx);
    }
    lbest = 32 * qb + j;
    lbefore = max(pre, bmx);
  }
}

// K11's epilogue: 32 * W mask words a pass, lane l words w0 + W l .. + W
// - 1 of each hit's row (the warp reads 128 * W contiguous bytes a hit;
// W = WPL, or 1 with 16 planes, whose registers would cut the warps an
// SM holds); a pass's (max, first argmax, max before it) is the lanes'
// joined in reference order by two warp reductions (the first of a key
// max << 12 | (4095 - index), so the smallest index wins a tie, then the
// max before it), and it joins the running state: a pass whose max is
// strictly greater wins, and the max before its argmax is then the larger
// of the running max and its own.  That is argmax_stream's first max and
// previous best exactly, for any R.
template <int P>
__device__ __forceinline__ void wide_epilogue(const uint32_t* __restrict__ mask_rows,
                                              int row_words, const int* hit_entry, int nhits,
                                              int Wm, int R, int init, int lane, int& mx,
                                              int& best, int& pm) {
  constexpr int W = P > 8 ? 1 : WPL;
  for (int w0 = 0; w0 < Wm; w0 += 32 * W) {
    int lmx, lbest, lbefore;
    wide_pass<P, W>(mask_rows, row_words, hit_entry, nhits, w0 + W * lane, R, init, lmx, lbest,
                    lbefore);
    const int local = 32 * W * lane + lbest;  // < 4096
    const unsigned key = lbest < 0 ? 0u : ((unsigned)(lmx + 1) << 12) | (4095u - local);
    const unsigned top = __reduce_max_sync(FULL, key);
    if (top == 0u) continue;  // warp-uniform: no count above init in this pass
    const int at = 4095 - (int)(top & 4095u), bl = at / (32 * W);
    const int smx = (int)(top >> 12) - 1;
    const int sbefore = __reduce_max_sync(FULL, lane < bl ? lmx : lane == bl ? lbefore : init);
    if (smx > mx) {
      pm = max(mx, sbefore);
      mx = smx;
      best = 32 * w0 + at;
    }
  }
}

// The epilogues: the stream flags, the filter's record, a shard's partial.
constexpr int STREAM = 0;
constexpr int FILTER = 1;
constexpr int PARTIAL = 2;

// PAIRS: the launch's table may have S = 2 (K2's S = 2 route).  Without it
// the S = 2 branches are compiled out and the kernel is the other widths'
// code as it was; with it every route stays and S picks one at run time (a
// variant holding the S = 2 routes alone ran 1.95x slower on zika shard 0
// of 2, with the same loads in its SASS: PERF.md §5).
template <int MODE, int MAXW, bool PAIRS>
__global__ void __launch_bounds__(32 * MAX_WARPS)
panel_probe_kernel(const uint64_t* __restrict__ rows, const int32_t* __restrict__ lens, int B,
                   int n, const uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ mask_rows, int row_words, int log2nb, int S,
                   int Wm, int R, const int32_t* __restrict__ ref_lens, int min_diff,
                   int min_matches, int init_partial, int nslots, int32_t* __restrict__ out) {
  constexpr bool REGS = MAXW > 0;
  constexpr bool LIST = MAXW < 0;
  constexpr int NW = REGS ? MAXW : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: nothing below waits for the block

  const size_t per_warp =
      (size_t)nslots * 8 + (REGS ? 0 : LIST ? (size_t)n * 4 : (size_t)Wm * 128);
  unsigned char* mine = smem + warp * per_warp;
  uint32_t* keys = reinterpret_cast<uint32_t*>(mine);                 // [nslots] ranks table
  int* cnt = reinterpret_cast<int*>(mine + (size_t)nslots * 4);       // [nslots]
  int* scnt = reinterpret_cast<int*>(mine + (size_t)nslots * 8);      // [Wm][32] counters
  int* hit_entry = scnt;                                              // LIST: [n] hits
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
    // and (register counters) the Wm mask words of the matching slot.  At
    // S = 2 and Wm = 1 the first trip is the whole row, and there is no
    // second
    const uint32_t* trow = table;
    uint32_t bucket = 0;
    int slot = -1;
    uint32_t m[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) m[w] = 0;
    int entry = -1;  // LIST: the hit's entry id
    uint32_t row_hi = 0, row_m0 = 0;  // PAIRS, Wm = 1: the slot's hi and mask word
    if (valid) {
      const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32), o = (uint32_t)occ;
      const uint32_t x = (lo ^ (hi * MIX) ^ (o * MIX)) * MUL;
      bucket = log2nb == 0 ? 0u : x >> (32 - log2nb);
      trow = table + (size_t)bucket * width;
      if constexpr (LIST) {
        // the bucket's slot records (lo, occ, hi, entry), SLOT_LOADS loads in flight
        const uint4* rec = reinterpret_cast<const uint4*>(table) + (size_t)bucket * S;
        uint32_t slot_hi = 0;
        for (int s0 = 0; s0 < S && slot < 0; s0 += SLOT_LOADS) {
          uint4 r[SLOT_LOADS];
#pragma unroll
          for (int j = 0; j < SLOT_LOADS; ++j) {
            r[j] = s0 + j < S ? __ldg(rec + s0 + j) : make_uint4(0u, FULL, 0u, FULL);
          }
#pragma unroll
          for (int j = 0; j < SLOT_LOADS; ++j) {
            if (slot < 0 && r[j].x == lo && r[j].y == o) {
              slot = s0 + j;
              slot_hi = r[j].z;
              entry = (int)r[j].w;
            }
          }
        }
        if (slot >= 0 && slot_hi != hi) slot = -1;
      } else if ((S & 3) == 0) {  // 16-byte aligned lane groups: S/4 uint4 loads each
        for (int s4 = 0; s4 < S && slot < 0; s4 += 4) {
          const uint4 l = __ldg(reinterpret_cast<const uint4*>(trow + S + s4));
          const uint4 c = __ldg(reinterpret_cast<const uint4*>(trow + 2 * S + s4));
          slot = l.x == lo && c.x == o   ? s4
                 : l.y == lo && c.y == o ? s4 + 1
                 : l.z == lo && c.z == o ? s4 + 2
                 : l.w == lo && c.w == o ? s4 + 3
                                         : -1;
        }
      } else if (PAIRS && S == 2 && Wm == 1) {  // the 32-byte row: two 16-byte loads
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(trow));      // hi0 hi1 lo0 lo1
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(trow) + 1);  // occ0 occ1 m0 m1
        slot = a.z == lo && c.x == o ? 0 : a.w == lo && c.y == o ? 1 : -1;
        row_hi = slot == 1 ? a.y : a.x;
        row_m0 = slot == 1 ? c.w : c.z;
      } else if (PAIRS && S == 2) {  // width 2 (3 + Wm) is even: 8-byte aligned lane pairs
        const uint2* pair = reinterpret_cast<const uint2*>(trow);
        const uint2 l = __ldg(pair + 1), c = __ldg(pair + 2);
        slot = l.x == lo && c.x == o ? 0 : l.y == lo && c.y == o ? 1 : -1;
      } else {  // other S (RKMH_TPU_SLOTS): lane by lane
        for (int s = 0; s < S; ++s) {
          if (__ldg(trow + S + s) == lo && __ldg(trow + 2 * S + s) == o) {
            slot = s;
            break;
          }
        }
      }
      if (!LIST && slot >= 0) {
        uint32_t slot_hi;
        if (PAIRS && S == 2 && Wm == 1) {  // already in registers
          slot_hi = row_hi;
          m[0] = row_m0;
        } else if (PAIRS && S == 2) {  // hi and the mask words as pairs, this slot's half
          const uint2* pair = reinterpret_cast<const uint2*>(trow);
          const uint2 hv = __ldg(pair);
          slot_hi = slot ? hv.y : hv.x;
          if constexpr (REGS) {
#pragma unroll
            for (int w = 0; w < NW; ++w) {
              if (w < Wm) {
                const uint2 mv = __ldg(pair + 3 + w);
                m[w] = slot ? mv.y : mv.x;
              }
            }
          }
        } else {
          slot_hi = __ldg(trow + slot);
          if constexpr (REGS) {
#pragma unroll
            for (int w = 0; w < NW; ++w)
              if (w < Wm) m[w] = __ldg(trow + (3 + w) * S + slot);
          }
        }
        if (slot_hi != hi) slot = -1;
      }
    }

    // count the hits: lane r adds bit r of each hit's mask words
    unsigned hits = __ballot_sync(FULL, slot >= 0);
    if constexpr (LIST) {
      if (slot >= 0) hit_entry[nhits + __popc(hits & ((1u << lane) - 1u))] = entry;
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

  // running max from -1 (stream), 0 (filter) or init_partial, strict >
  // (first ref wins ties); best stays INT_MAX when no count is above init
  // (filter: every count 0); pm, the previous best: max(init,
  // max(counts[:best]))
  const int init = MODE == FILTER ? 0 : MODE == STREAM ? -1 : init_partial;
  int mx = init, best = INT_MAX, pm = init;
  if constexpr (LIST) {
    __syncwarp();  // the hit list is the whole warp's
    if (nhits < 16) {  // warp-uniform: counts <= nhits < 2^planes
      wide_epilogue<4>(mask_rows, row_words, hit_entry, nhits, Wm, R, init, lane, mx, best, pm);
    } else if (MAXW == WIDE || nhits < 256) {
      wide_epilogue<8>(mask_rows, row_words, hit_entry, nhits, Wm, R, init, lane, mx, best, pm);
    } else {
      wide_epilogue<MAXW == WIDE ? 8 : 16>(mask_rows, row_words, hit_entry, nhits, Wm, R, init,
                                            lane, mx, best, pm);
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
  if (MODE == PARTIAL) {
    out[b] = best;
    out[B + b] = mx;
    out[2 * B + b] = pm;
    out[3 * B + b] = sk_len;
  } else if (MODE == FILTER) {
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

template <int MODE, int MAXW, bool PAIRS>
int launch_variant(int warps, size_t smem, const int64_t* rows, const int32_t* lens, int B,
                   int n, const int32_t* table, const int32_t* mask_rows, int row_words,
                   int log2nb, int S, int Wm, int R, const int32_t* ref_lens, int min_diff,
                   int min_matches, int init, int nslots, int32_t* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(panel_probe_kernel<MODE, MAXW, PAIRS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  panel_probe_kernel<MODE, MAXW, PAIRS><<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), lens, B, n,
      reinterpret_cast<const uint32_t*>(table), reinterpret_cast<const uint32_t*>(mask_rows),
      row_words, log2nb, S, Wm, R, ref_lens, min_diff, min_matches, init, nslots, out);
  return (int)cudaGetLastError();
}

// The layout from the shapes: the counters in 2 registers (R <= 64), in 8
// (R <= 256) or in shared memory; K11 (mask_rows given) none, a list of n
// hits (entry ids, fewer than 2^16: the epilogue's 16 planes); in
// raw mode 3n ranks slots per warp (2n and 4n were slower on the zika
// batch), or n where 3n do not fit one warp's share; as many warps per
// block (<= MAX_WARPS) as fit.
template <int MODE>
int launch(const int64_t* rows, const int32_t* lens, int B, int n, const int32_t* table,
           int log2nb, int S, int Wm, int R, const int32_t* ref_lens, int min_diff,
           int min_matches, int32_t* out, cudaStream_t stream,
           const int32_t* mask_rows = nullptr, int row_words = 0, int init = 0) {
  const bool wide = mask_rows != nullptr || row_words > 0;
  if (lens == nullptr && n >= (1 << (32 - FP_BITS)) - 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) & 15) return (int)cudaErrorInvalidValue;  // 16-byte loads
  if (wide && (n >= (1 << 16) || row_words < Wm || row_words % WPL))
    return (int)cudaErrorInvalidValue;
  const size_t cnt_bytes = wide ? (size_t)n * 4 : Wm <= 8 ? 0 : (size_t)Wm * 128;
  int nslots = lens == nullptr ? 3 * n : 0;
  if ((size_t)nslots * 8 + cnt_bytes > SMEM_MAX) nslots = n;
  const size_t per_warp = (size_t)nslots * 8 + cnt_bytes;
  if (per_warp > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int warps =
      per_warp == 0 ? MAX_WARPS : (int)std::min<size_t>(MAX_WARPS, SMEM_MAX / per_warp);
  const size_t smem = per_warp * warps;
  auto go = [&](auto maxw, auto pairs) {
    return launch_variant<MODE, decltype(maxw)::value, decltype(pairs)::value>(
        warps, smem, rows, lens, B, n, table, mask_rows, row_words, log2nb, S, Wm, R, ref_lens,
        min_diff, min_matches, init, nslots, out, stream);
  };
  auto logical = [&](auto maxw) {  // K2: the S = 2 route or the others
    return S == 2 ? go(maxw, std::true_type()) : go(maxw, std::false_type());
  };
  return wide      ? (n < 256 ? go(std::integral_constant<int, WIDE>(), std::false_type())
                              : go(std::integral_constant<int, WIDE16>(), std::false_type()))
         : Wm <= 2 ? logical(std::integral_constant<int, 2>())
         : Wm <= 8 ? logical(std::integral_constant<int, 8>())
                   : logical(std::integral_constant<int, 0>());
}

}  // namespace

// rows [B, n] uint64, lens [B] int32 or NULL, table [2^log2nb, S*(3+Wm)]
// uint32, 16-byte aligned -> out [3, B] int32.  Requires B >= 1, 1 <= R <=
// 32 * Wm and, in raw mode, n * 8 (+ Wm * 128 when Wm > 8) bytes within the
// block limit.
extern "C" int rkmh_panel_probe(const int64_t* rows, const int32_t* lens, int B, int n,
                                const int32_t* table, int log2nb, int S, int Wm, int R,
                                int min_diff, int min_matches, int32_t* out,
                                cudaStream_t stream) {
  return launch<STREAM>(rows, lens, B, n, table, log2nb, S, Wm, R, nullptr, min_diff,
                        min_matches, out, stream);
}

// The filter mode: as rkmh_panel_probe, plus ref_lens [R] int32 (the
// references' sketch lengths) -> out [5, B] int32.
extern "C" int rkmh_panel_probe_filter(const int64_t* rows, const int32_t* lens, int B,
                                       int n, const int32_t* table, int log2nb, int S,
                                       int Wm, int R, const int32_t* ref_lens,
                                       int min_diff, int min_matches, int32_t* out,
                                       cudaStream_t stream) {
  return launch<FILTER>(rows, lens, B, n, table, log2nb, S, Wm, R, ref_lens, min_diff,
                        min_matches, out, stream);
}

// K11, the wide route for any R (past the 8,192 references whose counters
// fit shared memory): rows, lens, B, n, R, min_diff and min_matches as
// rkmh_panel_probe; slots [2^log2nb * S] 16-byte records (lo, occ, hi,
// entry id; occ 0xFFFFFFFF and id -1 where empty); mask_rows [E,
// row_words] uint32, entry e's Wm mask words first (row_words >= Wm, a
// multiple of 4 for the 16-byte loads; 32 keeps the rows on 128-byte
// lines); slots and mask_rows 16-byte aligned; ref_lens NULL for the
// stream epilogue (out [3, B]) and given for the filter one (out [5, B]).
// Requires B >= 1, 1 <= R <= 32 * Wm, n < 2^16 and n * 4 bytes (+ n * 8
// in raw mode) within the block limit.
extern "C" int rkmh_panel_probe_wide(const int64_t* rows, const int32_t* lens, int B, int n,
                                     const int32_t* slots, const int32_t* mask_rows,
                                     int log2nb, int S, int Wm, int row_words, int R,
                                     const int32_t* ref_lens, int min_diff, int min_matches,
                                     int32_t* out, cudaStream_t stream) {
  if (row_words < 1) return (int)cudaErrorInvalidValue;
  if (ref_lens == nullptr) {
    return launch<STREAM>(rows, lens, B, n, slots, log2nb, S, Wm, R, nullptr, min_diff,
                          min_matches, out, stream, mask_rows, row_words);
  }
  return launch<FILTER>(rows, lens, B, n, slots, log2nb, S, Wm, R, ref_lens, min_diff,
                        min_matches, out, stream, mask_rows, row_words);
}

// A tp shard's partial epilogue, by every route a shard can take: with
// mask_rows NULL, K2 on the logical table (`table` [2^log2nb, S*(3+Wm)],
// row_words ignored), as rkmh_panel_probe requires it; with mask_rows, K11
// on the packed table (`table` the slot records), as rkmh_panel_probe_wide
// requires it.  init: the running max's start (-1 stream, 0 filter).  ->
// out [4, B] int32: local best (INT_MAX where no count is above init), max
// count, max(init, max(counts[:best])), sketch length.
extern "C" int rkmh_panel_probe_partial(const int64_t* rows, const int32_t* lens, int B, int n,
                                        const int32_t* table, const int32_t* mask_rows,
                                        int log2nb, int S, int Wm, int row_words, int R,
                                        int init, int32_t* out, cudaStream_t stream) {
  if (mask_rows != nullptr && row_words < 1) return (int)cudaErrorInvalidValue;
  return launch<PARTIAL>(rows, lens, B, n, table, log2nb, S, Wm, R, nullptr, 0, 0, out, stream,
                         mask_rows, mask_rows != nullptr ? row_words : 0, init);
}
