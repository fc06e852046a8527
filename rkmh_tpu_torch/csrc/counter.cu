// K6 and K7: the lossy hash % size k-mer depth counter (rkmh's HASHTCounter).
//
// K6 counter_add replaces rkmh_tpu/ops/counter.py::counter_add (:37), the
// scatter-add table.at[h % size].add(mask).  K7 counter_mask replaces
// counter_get (:46) followed by ops/sketch.py::mask_by_frequency (:64) or
// mask_by_frequency_range (:73): it gathers table[h % size], keeps h when
// lo <= count <= hi and writes 0 otherwise, so the [B, W] counts never
// reach device memory.  -M calls it with (min_occ, INT_MAX), -I with
// (0, max_samples).
//
// The slot is the unsigned 64-bit remainder h % size: h & (size - 1) when
// size is a power of two, else h - (h / size) * size with the quotient
// from one 64-bit multiply-high by a constant made on the host (Granlund
// and Montgomery), in place of the software division routine a run-time
// divisor compiles to.  Hash 0 (an invalid k-mer) lands in slot 0 and is
// counted like any other masked-in window, as rkmh counts it.
//
// Which elements K6 counts: all of them, those whose byte in a mask tensor
// is non-zero, or (the -M counter pass) those that are windows of the
// unpadded reads, derived here from the reads' lengths, the padded length
// and the k values, so that no [B, W] mask is built or read.
//
// A slot range: both kernels take (base, n_slots), the part [base, base +
// n_slots) of the logical hash % size table that `table` holds (a dp
// shard of the sharded counter, rkmh_tpu/parallel/ep.py:35-141).  K6 adds
// only the elements whose slot lies in the range, at slot - base; K7 masks
// only those and passes every other hash through, so a hash visiting each
// owner of a partition in turn comes out as the whole table's K7 gives it.
// (0, size) is the whole table: the kernels are then exactly the
// single-table kernels, and the single-table callers pass it.
//
// What bounds K6 on the card: one read-modify-write of a random 4 B slot
// per element in a table of 40 MB (filter's 1e7 slots, inside the 50 MB
// L2) to 3.2 GB (hpv16's 8e8 slots), plus a streaming read of the 8 B
// hashes.  One atomic per element leaves the SMs at 13 to 27 G atomics/s
// (distinct slots past the L2; a table inside it), sorted or not, several
// times under the rate of random loads (K7).  So K6 sends fewer of them,
// in two kernels:
//
// 1. bin_scatter: a block takes a tile of 4,096 elements, computes their
//    slots, sorts them in shared memory by bin (the slot's high bits: at
//    most 512 bins, each a contiguous range of the table), reserves room
//    in every bin's list with one atomic per bin and block, and writes the
//    32-bit slots there in runs.  Zero hashes are counted per block and
//    added to slot 0 once.  A bin's list holds `cap` slots (twice the mean
//    and some); what does not fit goes to the table by a plain atomicAdd,
//    so a hot bin (a low-complexity input) is exact and only slower.
// 2. bin_merge: one block per bin streams the bin's list through a hash
//    set in shared memory that merges equal slots, then adds each distinct
//    slot's count to the table (a stream batch's 2.28M adds fall into
//    ~415k distinct slots).  The set is flushed early when it fills up, so
//    no input is refused.  It can report how many elements it merged into
//    how many adds.
//
// The bins pay only where a batch repeats its k-mers: on distinct slots
// the merge sends as many atomics as before and the scatter comes on top.
// So small inputs, tables given no scratch, and counter passes whose first
// batch merged little (ops/counter.py decides) take counter_add_direct,
// one atomicAdd per element.  Integer adds commute, so the table is the same
// whatever the order of blocks, flushes and atomics.
//
// What bounds K7 on the card: the 8 B hashes read and written once each (a
// stream batch's 19.5 MB each way), plus one random 4 B load per non-zero
// hash, of which only the distinct 32 B sectors must come from memory (~13
// MB at the stream batch, reused 5.4 times; ~49 MB at the hpv16 -M batch,
// past the L2).  K7 (counter_mask_kernel) gives a thread one 16-byte vector
// of two hashes with both table loads in flight, loads nothing for hash 0
// (the padding of the hpv16 -M batch, ~79% of it), and takes an odd head
// element and an odd last element one by one, so that a view at any 8-byte
// offset works and nothing past n is touched.  Measured on an H100 against
// one thread per element (PERF.md §5): within 1.5%, no faster; 4 or 8
// hashes a thread, a grid capped at the blocks the card holds and
// evict-first hints on the hashes and out were each slower, so none of them
// is here.  What the time follows is the order of the table loads: the
// same hashes sorted by slot run 35-41% faster on the same sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 1 << 20;
constexpr unsigned FULL = 0xFFFFFFFFu;

// h % size for a fixed size in [1, 2^31).
struct Modulus {
  uint64_t size, magic;
  int s1, s2;
};

// magic = floor(2^64 * (2^l - size) / size) + 1 with l = ceil(log2(size)),
// made by the caller in exact integers.
Modulus make_modulus(int64_t size, uint64_t magic, int l) {
  return {(uint64_t)size, magic, l ? 1 : 0, l ? l - 1 : 0};
}

__device__ __forceinline__ uint32_t slot_of(uint64_t h, Modulus m) {
  if ((m.size & (m.size - 1)) == 0) return (uint32_t)(h & (m.size - 1));
  const uint64_t t = __umul64hi(m.magic, h);
  const uint64_t q = (t + ((h - t) >> m.s1)) >> m.s2;
  return (uint32_t)(h - q * m.size);
}

// The slots [base, base + n) of the table that a call reads or adds to.
struct Range {
  uint32_t base, n;
};

// h's slot less base; >= r.n (unsigned) where the range does not hold it.
__device__ __forceinline__ uint32_t local_slot(uint64_t h, Modulus m, Range r) {
  return slot_of(h, m) - r.base;
}

// Division by a fixed d >= 1 of any 32-bit n (as in window_hash.cu).
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

// Which elements of the flattened [B, wt] hashes count.
constexpr int MAX_KS = 8;
struct Counted {
  const uint8_t* mask;   // a byte per element, or nullptr
  const int32_t* lens;   // [B] unpadded read lengths, or nullptr
  uint32_t wt;           // columns per row: the per-k window counts, summed
  FastDiv by_wt;
  int nk;                // k values that have windows at the padded length
  int k[MAX_KS];
  int col0[MAX_KS];      // first column of each k's block
};

// ops/hashing.window_mask at element i: column c of k's block exists in
// the unpadded read iff c < len - (k - 1).
__device__ __forceinline__ bool counted(const Counted& w, int64_t i) {
  if (w.mask != nullptr) return w.mask[i] != 0;
  if (w.lens == nullptr) return true;
  const uint32_t row = fast_div((uint32_t)i, w.by_wt);
  const uint32_t col = (uint32_t)i - row * w.wt;
  const int len = w.lens[row];
  if (w.nk == 1) return (int)col < len - (w.k[0] - 1);
  bool ok = false;
#pragma unroll
  for (int j = 0; j < MAX_KS; ++j) {
    const int c = (int)col - w.col0[j];
    const bool mine = j < w.nk && c >= 0 && (j + 1 >= w.nk || (int)col < w.col0[j + 1]);
    if (mine) ok = c < len - (w.k[j] - 1);
  }
  return ok;
}

__global__ void counter_add_direct_kernel(const uint64_t* __restrict__ hashes, Counted w,
                                          int64_t n, int32_t* __restrict__ table, Modulus m,
                                          Range r) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (counted(w, i)) {
      const uint32_t s = local_slot(hashes[i], m, r);
      if (s < r.n) atomicAdd(&table[s], 1);
    }
  }
}

// ---------------------------------------------------------------- binned K6

constexpr int MAX_BINS = 512;
constexpr int SCATTER_THREADS = 512;
constexpr int PER_THREAD = 8;
constexpr int TILE = SCATTER_THREADS * PER_THREAD;  // 4,096 elements per block
static_assert(MAX_BINS <= 2 * SCATTER_THREADS, "the scan takes two bins a thread");

__global__ void __launch_bounds__(SCATTER_THREADS, 3)
bin_scatter_kernel(const uint64_t* __restrict__ hashes, Counted w, int64_t n, Modulus m,
                   Range r, int shift, int nbins, int cap, int32_t* __restrict__ cursor,
                   uint32_t* __restrict__ bins, int32_t* __restrict__ table) {
  __shared__ uint32_t sorted[TILE];  // the tile's slots in bin order
  __shared__ int hist[MAX_BINS];     // elements of the tile per bin
  __shared__ int start[MAX_BINS];    // first position of each bin in `sorted`
  __shared__ int gpos[MAX_BINS];     // the room reserved in each bin's list
  __shared__ int warp_sum[SCATTER_THREADS / 32];
  __shared__ int zeros;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  for (int b = tid; b < nbins; b += SCATTER_THREADS) hist[b] = 0;
  if (tid == 0) zeros = 0;
  __syncthreads();

  // every load in flight before the first remainder
  uint64_t h[PER_THREAD];
  int my_zeros = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int64_t i = base + j * SCATTER_THREADS + tid;
    const bool on = i < n && counted(w, i);
    h[j] = on ? hashes[i] : 0;
    if (on && h[j] == 0) ++my_zeros;  // hash 0 is slot 0: added once per block
  }
  uint32_t slot[PER_THREAD];  // local: slot - base
  int rank[PER_THREAD];  // the element's place among its bin's in this tile; -1: none
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    rank[j] = -1;
    if (h[j] != 0) {
      slot[j] = local_slot(h[j], m, r);
      if (slot[j] < r.n) rank[j] = atomicAdd(&hist[slot[j] >> shift], 1);
    }
  }
  my_zeros = __reduce_add_sync(FULL, my_zeros);
  if (lane == 0 && my_zeros) atomicAdd(&zeros, my_zeros);
  __syncthreads();

  // exclusive scan of hist: two bins a thread, a shuffle scan per warp
  const int b0 = 2 * tid, b1 = 2 * tid + 1;
  const int c0 = b0 < nbins ? hist[b0] : 0, c1 = b1 < nbins ? hist[b1] : 0;
  int incl = c0 + c1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int x = 0; x < warp; ++x) before += warp_sum[x];
  const int excl = before + incl - (c0 + c1);
  // reserve room in the bins' lists; the answers are needed only for the
  // write-out, so their latency hides behind the barrier and the scatter
  int g0 = 0, g1 = 0;
  if (b0 < nbins) {
    start[b0] = excl;
    if (c0) g0 = atomicAdd(&cursor[b0], c0);
  }
  if (b1 < nbins) {
    start[b1] = excl + c0;
    if (c1) g1 = atomicAdd(&cursor[b1], c1);
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (rank[j] >= 0) sorted[start[slot[j] >> shift] + rank[j]] = slot[j];
  }
  if (b0 < nbins) gpos[b0] = g0;
  if (b1 < nbins) gpos[b1] = g1;
  __syncthreads();

  int total = 0;
  for (int x = 0; x < SCATTER_THREADS / 32; ++x) total += warp_sum[x];
  for (int p = tid; p < total; p += SCATTER_THREADS) {
    const uint32_t s = sorted[p];
    const int b = (int)(s >> shift);
    const int at = gpos[b] + (p - start[b]);
    if (at < cap) {
      bins[(int64_t)b * cap + at] = s;
    } else {
      atomicAdd(&table[s], 1);  // the bin's list is full
    }
  }
  if (tid == 0 && zeros && r.base == 0) atomicAdd(&table[0], zeros);
}

constexpr int MERGE_THREADS = 512;
constexpr int SET_BITS = 12;
constexpr int SET_SIZE = 1 << SET_BITS;  // entries of the shared hash set
constexpr int MERGE_CHUNK = 1024;        // elements inserted between two barriers
constexpr int SET_LIMIT = SET_SIZE - MERGE_CHUNK - SET_SIZE / 4;  // flush above this
constexpr uint32_t EMPTY = 0xFFFFFFFFu;  // no slot: slots are below 2^31

// table[key] += count for every entry of the set, and the set cleared;
// stats[0] (if given) += the entries added.
__device__ __forceinline__ void flush_set(uint32_t* keys, int* cnts, int* used,
                                          int32_t* __restrict__ table, int32_t* stats) {
  for (int e = threadIdx.x; e < SET_SIZE; e += MERGE_THREADS) {
    const uint32_t key = keys[e];
    if (key != EMPTY) {
      atomicAdd(&table[key], cnts[e]);
      keys[e] = EMPTY;
      cnts[e] = 0;
    }
  }
  if (threadIdx.x == 0) {
    if (stats != nullptr && *used) atomicAdd(&stats[0], *used);
    *used = 0;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
bin_merge_kernel(const uint32_t* __restrict__ bins, const int32_t* __restrict__ cursor,
                 int cap, int32_t* __restrict__ table, int32_t* __restrict__ stats) {
  __shared__ uint32_t keys[SET_SIZE];
  __shared__ int cnts[SET_SIZE];
  __shared__ int used;  // entries claimed since the last flush

  const int count = min(cursor[blockIdx.x], cap);
  if (count == 0) return;
  const uint32_t* mine = bins + (int64_t)blockIdx.x * cap;
  for (int e = threadIdx.x; e < SET_SIZE; e += MERGE_THREADS) {
    keys[e] = EMPTY;
    cnts[e] = 0;
  }
  if (threadIdx.x == 0) {
    used = 0;
    if (stats != nullptr) atomicAdd(&stats[1], count);
  }
  __syncthreads();

  for (int c0 = 0; c0 < count; c0 += MERGE_CHUNK) {
    const bool full = used > SET_LIMIT;
    __syncthreads();  // every thread has read `used` before any insert moves it
    if (full) {
      flush_set(keys, cnts, &used, table, stats);
      __syncthreads();
    }
    const int c1 = min(c0 + MERGE_CHUNK, count);
    int claimed = 0;
    for (int p = c0 + threadIdx.x; p < c1; p += MERGE_THREADS) {
      const uint32_t key = mine[p];
      uint32_t e = (key * 0x9E3779B1u) >> (32 - SET_BITS);
      while (true) {
        const uint32_t seen = atomicCAS(&keys[e], EMPTY, key);
        if (seen == EMPTY) ++claimed;
        if (seen == EMPTY || seen == key) break;
        e = (e + 1) & (SET_SIZE - 1);
      }
      atomicAdd(&cnts[e], 1);
    }
    // one add a warp: every claim adding to `used` itself would serialise
    claimed = __reduce_add_sync(FULL, claimed);
    if ((threadIdx.x & 31) == 0 && claimed) atomicAdd(&used, claimed);
    __syncthreads();
  }
  flush_set(keys, cnts, &used, table, stats);
}

// ---------------------------------------------------------------------- K7

constexpr int MASK_THREADS = 256;
using u64 = unsigned long long;

// h if the range does not hold its slot (mine false) or lo <= count <= hi,
// else 0.
__device__ __forceinline__ u64 kept(u64 h, int c, bool mine, int lo, int hi) {
  return (!mine || (lo <= c && c <= hi)) ? h : 0ULL;
}

// The count of h where the range holds its slot (mine); no load for hash 0
// (mine false: its output is 0 whatever its count) nor outside the range.
__device__ __forceinline__ int count_of(u64 h, const int32_t* __restrict__ table,
                                        Modulus m, Range r, bool& mine) {
  const uint32_t s = local_slot(h, m, r);
  mine = h != 0 && s < r.n;
  return mine ? __ldg(table + s) : 0;
}

// hashes + head is 16-byte aligned (head is 0 or 1); the n - head elements
// after it are nvec vectors of two and, if odd, one last element.  Block 0
// takes the head and the last element one by one; a thread takes a vector,
// its two table loads in flight together.  VEC_OUT: out + head is 16-byte
// aligned too, so out is written in vectors; else (a misaligned view of the
// hashes) one element at a time.
template <bool VEC_OUT>
__global__ void __launch_bounds__(MASK_THREADS)
counter_mask_kernel(const u64* __restrict__ hashes, int64_t n, int64_t head,
                    const int32_t* __restrict__ table, Modulus m, Range r, int lo, int hi,
                    u64* __restrict__ out) {
  const int64_t nvec = (n - head) >> 1;
  if (blockIdx.x == 0 && threadIdx.x < 2) {
    const int64_t i = threadIdx.x == 0 ? (head ? 0 : n) : (((n - head) & 1) ? n - 1 : n);
    if (i < n) {
      bool mine;
      const int c = count_of(hashes[i], table, m, r, mine);
      out[i] = kept(hashes[i], c, mine, lo, hi);
    }
  }
  const ulonglong2* hv = reinterpret_cast<const ulonglong2*>(hashes + head);
  u64* o = out + head;
  for (int64_t v = (int64_t)blockIdx.x * MASK_THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * MASK_THREADS) {
    const ulonglong2 x = hv[v];
    bool m0, m1;
    const int c0 = count_of(x.x, table, m, r, m0), c1 = count_of(x.y, table, m, r, m1);
    const u64 y0 = kept(x.x, c0, m0, lo, hi), y1 = kept(x.y, c1, m1, lo, hi);
    if (VEC_OUT) {
      reinterpret_cast<ulonglong2*>(o)[v] = make_ulonglong2(y0, y1);
    } else {
      o[2 * v] = y0;
      o[2 * v + 1] = y1;
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// table[h % size - base] += 1 for every counted element of hashes [n] whose
// slot h % size lies in [base, base + n_slots) (table [n_slots]; (0, size):
// the whole table).  Counted: those whose mask byte is non-zero (mask
// given), those that are windows of the unpadded reads (lens [B] given:
// hashes is [B, sum over ks of max(L - k + 1, 0)], and n < 2^32), or all
// (both NULL).  magic and log2_ceil describe size (see make_modulus).  With
// scratch (cursor [nbins] and bins [nbins * cap]) the adds go through the
// bins: bin = (slot - base) >> shift, nbins <= 512; with bins NULL every
// element is one atomicAdd.  stats (int32 [2], or NULL) += what the merge
// did: [0] the adds it sent to the table, [1] the elements it merged into
// them.  Requires n >= 1, 1 <= size < 2^31, nk <= 8, 1 <= n_slots and
// base + n_slots <= size.
extern "C" int rkmh_counter_add(const int64_t* hashes, const uint8_t* mask,
                                const int32_t* lens, int L, const int* ks, int nk, int64_t n,
                                int32_t* table, int64_t size, uint64_t magic, int log2_ceil,
                                int64_t base, int64_t n_slots, int32_t* cursor, uint32_t* bins,
                                int shift, int nbins, int cap, int32_t* stats,
                                cudaStream_t stream) {
  if (base < 0 || n_slots < 1 || base + n_slots > size) return (int)cudaErrorInvalidValue;
  const Range r = {(uint32_t)base, (uint32_t)n_slots};
  Counted w = {};
  w.mask = mask;
  w.lens = mask == nullptr ? lens : nullptr;
  if (w.lens != nullptr) {
    if (nk > MAX_KS || n >= (1LL << 32)) return (int)cudaErrorInvalidValue;
    int col = 0;
    for (int j = 0; j < nk; ++j) {
      if (L - ks[j] + 1 <= 0) continue;  // this k has no window at the padded length
      w.k[w.nk] = ks[j];
      w.col0[w.nk++] = col;
      col += L - ks[j] + 1;
    }
    if (col == 0) return (int)cudaErrorInvalidValue;
    w.wt = (uint32_t)col;
    w.by_wt = make_fast_div(w.wt);
  }
  const Modulus m = make_modulus(size, magic, log2_ceil);
  const uint64_t* h = reinterpret_cast<const uint64_t*>(hashes);
  if (bins == nullptr) {
    counter_add_direct_kernel<<<blocks_for(n), THREADS, 0, stream>>>(h, w, n, table, m, r);
    return (int)cudaGetLastError();
  }
  if (nbins < 1 || nbins > MAX_BINS || cap < 1 || shift < 0 || shift > 31 ||
      ((n_slots - 1) >> shift) >= nbins) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(cursor, 0, (size_t)nbins * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + TILE - 1) / TILE;
  bin_scatter_kernel<<<(unsigned)tiles, SCATTER_THREADS, 0, stream>>>(
      h, w, n, m, r, shift, nbins, cap, cursor, bins, table);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_merge_kernel<<<nbins, MERGE_THREADS, 0, stream>>>(bins, cursor, cap, table, stats);
  return (int)cudaGetLastError();
}

// out[i] = hashes[i] if its slot s = hashes[i] % size lies outside [base,
// base + n_slots) or lo <= table[s - base] <= hi, else 0 (hash 0: 0).
// hashes and out may lie anywhere 8-byte aligned (a view of the hashes at an
// odd element offset included); nothing past n is read or written.
// Requires n >= 1, 1 <= size < 2^31, base + n_slots <= size; magic and
// log2_ceil as above.
extern "C" int rkmh_counter_mask(const int64_t* hashes, int64_t n, const int32_t* table,
                                 int64_t size, uint64_t magic, int log2_ceil, int64_t base,
                                 int64_t n_slots, int lo, int hi, int64_t* out,
                                 cudaStream_t stream) {
  if (base < 0 || n_slots < 1 || base + n_slots > size) return (int)cudaErrorInvalidValue;
  const Range r = {(uint32_t)base, (uint32_t)n_slots};
  const u64* h = reinterpret_cast<const u64*>(hashes);
  u64* o = reinterpret_cast<u64*>(out);
  const int64_t head = ((uintptr_t)h & 15) ? 1 : 0;
  const int64_t nvec = (n - head) >> 1;
  int64_t blocks = (nvec + MASK_THREADS - 1) / MASK_THREADS;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  const Modulus m = make_modulus(size, magic, log2_ceil);
  if (((uintptr_t)(o + head) & 15) == 0) {
    counter_mask_kernel<true><<<(unsigned)blocks, MASK_THREADS, 0, stream>>>(
        h, n, head, table, m, r, lo, hi, o);
  } else {
    counter_mask_kernel<false><<<(unsigned)blocks, MASK_THREADS, 0, stream>>>(
        h, n, head, table, m, r, lo, hi, o);
  }
  return (int)cudaGetLastError();
}
