// K3: fused hpv16 set-table probe — bucket probe, per-reference distinct
// counts and the type argmax.
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
// equal hashes can hit; a later one carries occ > 0 and misses.  The
// kernel therefore probes only run starts, and finds a run start from
// row[i-1] alone: the previous lane's value by a shuffle, and for lane 0
// the element before it from memory, also where that element belongs to
// another block's segment.  The row is not staged in shared memory, so no
// read length is too long.
//
// What bounds it on the card: one random access per distinct valid element
// into a table far larger than the ~24 MB of L2 that every SM reads at
// random at the cache's rate (bench/l2_sweep.py; the card's L2 is 50 MB;
// hpv16 at k=18: ~1.4M entries, 2^20 buckets of S=12 slots, Wm=7 mask
// words), so a probe is a trip to HBM and the kernel lasts as long as its
// slowest block.  The design:
//
// * The table is read in a layout made for this card, once per run, by
//   ops/set_probe.pack_set_table: per bucket one key record (the S lo
//   words and, in its last word, a bitmap of the occupied slots, padded to
//   a power of two of at least 16 bytes: 64 bytes at S=12) and per slot one
//   record (hi, then the Wm mask words, padded to 16 bytes: 32 bytes, one
//   sector, at Wm=7).  A probe loads one key record with 16-byte
//   ld.global.nc vectors; only a lo match on an occupied slot loads that
//   slot's record, where hi is checked.  That is 2 sectors per probe and 1
//   per hit, against 4 and 8 in the logical [hi*S | lo*S | occ*S | mask]
//   lanes, and the key records (64 MiB at 2^20 buckets) are few enough
//   that many stay in L2 from one probe to the next.
// * Work is split by elements: block (b, j) takes elements [j * seg, (j +
//   1) * seg) of read b and leaves at once when the read is shorter, so a
//   batch of 512 reads of unequal lengths fills the card and no block
//   lasts longer than one segment.
// * A lane holds the key record of one probe at a time: the loads in
//   flight come from the many warps an SM then holds.  Two probes a lane
//   before the first compare took 19% longer on the card and four 54%
//   (their registers cut the warps).
// * Counting stays on chip: per warp, the OR of the 32 lanes' mask words
//   names the bits to count, one ballot per such bit gives the votes of 32
//   elements for one reference, and lane b adds the votes for bit b to a
//   per-reference counter in shared memory.  A read of one segment takes
//   its argmax from there.  A longer read's blocks add their non-zero
//   counters to a [B, 32 * Wm] buffer, and the last of them to finish (a
//   ticket counter after a __threadfence) takes the first-max argmax.

// K10 (sorted_probe_kernel, rkmh_sorted_probe) is the same kernel for
// hpv16's fallback past the set-table cap.  It replaces the chain
// rkmh_tpu/classify/engine.py:829-862 (_hpv16_sorted_core after the
// sort: occ ranks, the set-semantics query mask, then
// ops/lookup.py:658 sorted_panel_counts_masked's searchsorted, key
// compare, mask gather and vertical popcounts, and the type argmax).  The
// panel is np.unique's sorted distinct keys (sign bit flipped, so a
// signed compare is the unsigned order), a [U, Wm] mask row a key, and a
// directory over the keys' unsigned top D bits (D = max(8, bit_length(U)
// - 2), 2 to 4 keys a bucket; ops/sorted_probe.build_directory), as
// ops/hashmap.SortedMap has one.  A run start takes three dependent
// trips: the directory pair (one 8-byte load where the pair is aligned;
// 8 MB at the 640-type panel's 5M keys, inside the L2's ~24 MB), the
// bucket's keys in 16-byte vectors, two keys a load, up to the first key
// >= the element (a bucket of more than SCAN keys, e.g. every key sharing
// its top bits, is first halved by a binary search inside it), and on
// equality the key's mask row, every word of it loaded before any is
// counted (the counting itself is ~2% of the time on the 640-type batch,
// PERF.md).  A binary search over all U keys took log2(U) + 1 dependent
// loads (24 at 5M keys, 40 MB of keys, its last levels from HBM), and a
// mask row loaded word by word between the votes one more trip a word.
// It keeps K3's split by segments, run-start test, on-chip counting and
// epilogue (finish_read), and skips the counting of a warp step in which
// no lane found its key.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint64_t SENTINEL = 0xFFFFFFFFFFFFFFFFULL;
constexpr uint32_t MIX = 0x85EBCA77u;
constexpr uint32_t MUL = 0x9E3779B1u;
constexpr int SCAN = 8;   // K10: bucket keys scanned in vectors; a longer bucket is halved first
constexpr int MW = 32;    // K10: mask words loaded together

__device__ __forceinline__ uint32_t word_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The warp's 32 mask words for reference word `word`: lane b adds the
// number of lanes whose bit b is set to cnt[32 * word + b].
__device__ __forceinline__ void count_votes(uint32_t mine, int word, int lane, int* cnt) {
  uint32_t bits = __reduce_or_sync(FULL, mine);
  int votes_here = 0;
  while (bits) {
    const int bit = __ffs(bits) - 1;
    bits &= bits - 1;
    const int votes = __popc(__ballot_sync(FULL, (mine >> bit) & 1u));
    if (lane == bit) votes_here = votes;
  }
  if (votes_here) atomicAdd(&cnt[32 * word + lane], votes_here);
}

// The end of a read's block, shared by K3 and K10, after the block's
// counts are in cnt[32 * Wm] (and a __syncthreads): a read of several
// segments adds its counters to its row of counts in device memory, and
// the last of its blocks to get here reads them back; then warp 0 writes
// the first-max type, its count and the U group counts.
__device__ __forceinline__ void finish_read(int* cnt, bool* last, int* __restrict__ counts,
                                            int* __restrict__ done, int64_t* __restrict__ out,
                                            int b, int nseg, int Wm, int T, int U) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (nseg > 1) {
    // a read of several segments: add to its counters in device memory;
    // the last block to get here reads them back and takes the argmax
    int* total = counts + (int64_t)b * 32 * Wm;
    for (int r = tid; r < 32 * Wm; r += THREADS) {
      if (cnt[r]) atomicAdd(&total[r], cnt[r]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(&done[b], 1) == nseg - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int r = tid; r < 32 * Wm; r += THREADS) cnt[r] = __ldcg(&total[r]);
    __syncthreads();
  }

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

// KV: 16-byte vectors per key record (S < 4 * KV).
template <int KV>
__global__ void __launch_bounds__(THREADS)
set_probe_kernel(const uint64_t* __restrict__ rows, int64_t row_stride,
                 const int32_t* __restrict__ lens, int n, const uint4* __restrict__ keys,
                 const uint4* __restrict__ slots, int log2nb, int S, int Wm, int seg, int T,
                 int U, int* __restrict__ counts, int* __restrict__ done,
                 int64_t* __restrict__ out) {
  extern __shared__ int cnt[];  // [32 * Wm] per-reference counters
  __shared__ bool last;

  const int b = blockIdx.x;
  const int len = min(lens[b], n);
  const int first = blockIdx.y * seg;
  if (blockIdx.y > 0 && first >= len) return;  // the read ends before this segment
  const int end = min(first + seg, len);
  const int nseg = max(1, (len + seg - 1) / seg);  // blocks that stay for read b
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < 32 * Wm; r += THREADS) cnt[r] = 0;
  __syncthreads();

  const uint64_t* row = rows + (int64_t)b * row_stride;
  const int SV = (Wm + 4) / 4;  // 16-byte vectors per slot record: hi + Wm words

  // warp-uniform loop bound: every lane takes part in the shuffles and ballots
  for (int base = first + warp * 32; base < end; base += THREADS) {
    const int i = base + lane;
    const uint64_t h = i < end ? row[i] : SENTINEL;
    uint64_t prev = __shfl_up_sync(FULL, h, 1);
    if (lane == 0 && i > 0 && i < end) prev = row[i - 1];
    const bool probe = i < end && h != SENTINEL && (i == 0 || prev != h);
    const uint32_t lo = (uint32_t)h, hi = (uint32_t)(h >> 32);
    const uint32_t x = (lo ^ (hi * MIX)) * MUL;  // bucket_indices at occ = 0
    const size_t bucket = log2nb == 0 ? 0u : x >> (32 - log2nb);
    int slot = -1;  // the occupied slot whose lo matches
    if (probe) {
      uint4 key[KV];
#pragma unroll
      for (int v = 0; v < KV; ++v) key[v] = __ldg(keys + bucket * KV + v);
      const uint32_t occupied = key[KV - 1].w;
#pragma unroll
      for (int s = 4 * KV - 2; s >= 0; --s) {  // downwards: the first match stays
        if (s < S && word_of(key[s / 4], s % 4) == lo && ((occupied >> s) & 1u)) slot = s;
      }
    }
    const uint4* rec = slot >= 0 ? slots + (bucket * S + slot) * SV : nullptr;
    // its record, two vectors (8 words) at a time: word 0 is hi, word 1 + w mask word w
    for (int v0 = 0; v0 < SV; v0 += 2) {
      uint4 m[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        m[v] = rec != nullptr && v0 + v < SV ? __ldg(rec + v0 + v) : make_uint4(0u, 0u, 0u, 0u);
      }
      if (v0 == 0 && rec != nullptr && m[0].x != hi) rec = nullptr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int w = 4 * v0 + j - 1;  // mask word of flat word 4 * v0 + j
        if (w < 0) continue;
        if (w >= Wm) break;  // warp-uniform
        count_votes(rec != nullptr ? word_of(m[j / 4], j % 4) : 0u, w, lane, cnt);
      }
    }
  }
  __syncthreads();
  finish_read(cnt, &last, counts, done, out, b, nseg, Wm, T, U);
}

// K10: the same probe of a read's run starts against the sorted-key
// panel (hpv16's fallback past the set-table cap): the element's bucket
// in the directory, then its keys (flipped, ascending as signed values)
// up to the first >= the flipped element; on equality, the key's Wm mask
// words [U, Wm] count as K3 counts a slot's.
__global__ void __launch_bounds__(THREADS)
sorted_probe_kernel(const uint64_t* __restrict__ rows, int64_t row_stride,
                    const int32_t* __restrict__ lens, int n, const int64_t* __restrict__ keys,
                    int nkeys, const int32_t* __restrict__ dir, int bits,
                    const uint32_t* __restrict__ masks, int seg, int Wm, int T, int U,
                    int* __restrict__ counts, int* __restrict__ done,
                    int64_t* __restrict__ out) {
  extern __shared__ int cnt[];  // [32 * Wm] per-reference counters
  __shared__ bool last;

  const int b = blockIdx.x;
  const int len = min(lens[b], n);
  const int first = blockIdx.y * seg;
  if (blockIdx.y > 0 && first >= len) return;  // the read ends before this segment
  const int end = min(first + seg, len);
  const int nseg = max(1, (len + seg - 1) / seg);  // blocks that stay for read b
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < 32 * Wm; r += THREADS) cnt[r] = 0;
  __syncthreads();

  const uint64_t* row = rows + (int64_t)b * row_stride;
  // warp-uniform loop bound: every lane takes part in the shuffles and ballots
  for (int base = first + warp * 32; base < end; base += THREADS) {
    const int i = base + lane;
    const uint64_t h = i < end ? row[i] : SENTINEL;
    uint64_t prev = __shfl_up_sync(FULL, h, 1);
    if (lane == 0 && i > 0 && i < end) prev = row[i - 1];
    const bool probe = i < end && h != SENTINEL && (i == 0 || prev != h);
    const uint32_t* rec = nullptr;  // the mask words of the key equal to h
    if (probe) {
      const int64_t q = (int64_t)(h ^ 0x8000000000000000ULL);
      const uint32_t bk = (uint32_t)(h >> (64 - bits));  // the unsigned top bits
      const int2 pair = __ldg(reinterpret_cast<const int2*>(dir + (bk & ~1u)));
      int lo = (bk & 1u) ? pair.y : pair.x;
      int hi = (bk & 1u) ? __ldg(dir + bk + 1) : pair.y;
      // q's index, if q is a key, stays in [lo, hi)
      while (hi - lo > SCAN) {
        const int mid = lo + ((hi - lo) >> 1);
        if (__ldg(keys + mid) < q) {
          lo = mid + 1;
        } else {
          hi = mid + 1;
        }
      }
      // two keys a load from the even index at or below lo; the keys are
      // distinct, so one outside [lo, hi) never equals q
      for (int j = lo & ~1; j < hi; j += 2) {
        longlong2 v;
        if (j + 1 < nkeys) {
          v = __ldg(reinterpret_cast<const longlong2*>(keys + j));
        } else {
          v = make_longlong2(__ldg(keys + j), LLONG_MAX);
        }
        if (v.x == q || v.y == q) {
          rec = masks + (int64_t)(v.x == q ? j : j + 1) * Wm;
          break;
        }
        if (v.y >= q) break;
      }
    }
    if (!__any_sync(FULL, rec != nullptr)) continue;  // warp-uniform
    // the row's words, MW at a time, all loaded before any is counted
    for (int w0 = 0; w0 < Wm; w0 += MW) {
      uint32_t m[MW];
#pragma unroll
      for (int j = 0; j < MW; ++j) m[j] = rec != nullptr && w0 + j < Wm ? __ldg(rec + w0 + j) : 0u;
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        if (w0 + j >= Wm) break;  // warp-uniform
        count_votes(m[j], w0 + j, lane, cnt);
      }
    }
  }
  __syncthreads();
  finish_read(cnt, &last, counts, done, out, b, nseg, Wm, T, U);
}

template <int KV>
int launch(const int64_t* rows, int64_t row_stride, const int32_t* lens, int B, int n,
           const int32_t* keys, const int32_t* slots, int log2nb, int S, int Wm, int T, int U,
           int seg, int32_t* counts, int32_t* done, int64_t* out, cudaStream_t stream) {
  const size_t smem = (size_t)Wm * 32 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(set_probe_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(B, n > seg ? (n + seg - 1) / seg : 1);
  set_probe_kernel<KV><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), row_stride, lens, n,
      reinterpret_cast<const uint4*>(keys), reinterpret_cast<const uint4*>(slots), log2nb, S,
      Wm, seg, T, U, counts, done, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [B, n] uint64 (row stride row_stride elements, sorted), lens [B]
// int32, the packed set table (keys [2^log2nb, KW] uint32 with KW = max(4,
// next power of two of S + 1): S lo words, zeros, the occupancy bitmap
// last; slots [2^log2nb * S, SW] uint32 with SW = 4 * ceil((1 + Wm) / 4):
// hi, the Wm mask words, zeros; both 16-byte aligned) -> out [B, 2+U]
// int64.  Block (b, j) takes elements [j * seg, (j + 1) * seg) of read b.
// counts [B, 32 * Wm] and done [B], zeroed, are needed when n > seg.
// Requires B >= 1, T >= 1, T + U <= 32 * Wm, S <= 31, seg a positive
// multiple of 32 with ceil(n / seg) <= 65535.
extern "C" int rkmh_set_probe(const int64_t* rows, int64_t row_stride, const int32_t* lens,
                              int B, int n, const int32_t* keys, const int32_t* slots,
                              int log2nb, int S, int Wm, int T, int U, int seg,
                              int32_t* counts, int32_t* done, int64_t* out,
                              cudaStream_t stream) {
  if (seg < 32 || seg % 32 || (n + seg - 1) / seg > 65535 || S < 1 || S > 31 ||
      (n > seg && (counts == nullptr || done == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
#define RKMH_SET_PROBE(KV)                                                                 \
  return launch<KV>(rows, row_stride, lens, B, n, keys, slots, log2nb, S, Wm, T, U, seg, \
                    counts, done, out, stream)
  if (S < 4) RKMH_SET_PROBE(1);
  if (S < 8) RKMH_SET_PROBE(2);
  if (S < 16) RKMH_SET_PROBE(4);
  RKMH_SET_PROBE(8);
#undef RKMH_SET_PROBE
}

// K10: rows, row_stride, lens, B, n, seg, counts, done and out as
// rkmh_set_probe; keys [nkeys] int64, the sorted distinct hashes with the
// sign bit flipped (ascending as signed values), on a 16-byte boundary;
// dir [2^bits + 1] int32 on an 8-byte boundary, bucket b's keys being
// [dir[b], dir[b+1]) (b = the hash's unsigned top bits); masks [nkeys, Wm]
// uint32.  Requires B >= 1, nkeys >= 1, 1 <= bits <= 31, T >= 1, T + U <=
// 32 * Wm, seg a positive multiple of 32 with ceil(n / seg) <= 65535.
extern "C" int rkmh_sorted_probe(const int64_t* rows, int64_t row_stride, const int32_t* lens,
                                 int B, int n, const int64_t* keys, int nkeys,
                                 const int32_t* dir, int bits, const int32_t* masks, int Wm,
                                 int T, int U, int seg, int32_t* counts, int32_t* done,
                                 int64_t* out, cudaStream_t stream) {
  if (seg < 32 || seg % 32 || (n + seg - 1) / seg > 65535 || nkeys < 1 || bits < 1 ||
      bits > 31 || (n > seg && (counts == nullptr || done == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)Wm * 32 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(sorted_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dim3 grid(B, n > seg ? (n + seg - 1) / seg : 1);
  sorted_probe_kernel<<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const uint64_t*>(rows), row_stride, lens, n, keys, nkeys, dir, bits,
      reinterpret_cast<const uint32_t*>(masks), seg, Wm, T, U, counts, done, out);
  return (int)cudaGetLastError();
}
