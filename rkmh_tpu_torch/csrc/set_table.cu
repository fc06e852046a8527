// K13: the set-table fill, the last step of a device-built bucket table.
//
// Replaces the chain at rkmh_tpu/ops/lookup.py:489-516 (in
// _device_set_table :430): the associative_scan of run starts, the rank
// of an entry in its bucket, the (lo, occ) collision test, max_rank, and
// the 3 + Wm scatters into a [nb + 1, width] table that is then sliced
// to nb rows.  The entries arrive sorted by (bucket, lo, occ) (the sorts
// before it stay library calls, ops/lookup.py section (d)).
//
// Output: the logical table [nb, S * (3 + Wm)] int32, slot-major lanes
// [hi*S | lo*S | occ*S | mask_w*S ...] per bucket row, every lane written
// once: slot r of bucket b holds the bucket's entry of rank r, or is
// empty (zeros, 0xFFFFFFFF in its occ lane); an entry of rank >= S is not
// written (the JAX chain sends it to the dropped row nb).  max_rank: the
// largest rank of any entry, or S where two entries of one bucket have
// equal (lo, occ) (the query compares only lo and occ in a bucket); the
// caller grows the table while it is >= S.  It must hold -1 on entry.
//
// What bounds it on the card: the table's bytes (480 MiB for the hpv16
// 182-type panel, of which 11.5% of the slots are occupied) written once,
// beside the entries' 20 + 4 Wm bytes read once: ~0.17 ms at 3.35 TB/s.
//
// Design: a block owns a tile, one contiguous span of the table: `rows`
// whole bucket rows, chosen from the row width so that the tile is about
// TILE_WORDS lanes (32 KiB of shared memory) at every geometry; a row
// wider than that is cut into windows of TILE_WORDS lanes, a block each.
// The block stages its tile in shared memory:
//   1. two warps find the tile's entries, the range [s0, s1) of the sorted
//      buckets [b0, b0 + rows), by a 32-way search each (32 probes a step
//      by one ballot: 5 dependent loads for 1.4M entries, in place of the
//      21 of a binary search), while the block zeroes the tile by 16-byte
//      shared stores;
//   2. the occ lanes of every row are set empty, and the entries, read once
//      and coalesced, mark the run starts (an entry whose bucket differs
//      from the one before it) and the collisions (equal bucket, lo and
//      occ);
//   3. a thread per (entry, lane group), hi, lo, occ or one mask word,
//      takes the entry's rank as e - run_start[bucket[e] - b0] (no search,
//      no division but one 32-bit one by 3 + Wm a lane) and, under S,
//      writes the lane into the tile; the mask words of an entry come from
//      its row of masks by neighbouring threads.  A thread takes UNROLL
//      lanes at once and issues all their loads before it waits on any, so
//      a tile waits on two dependent trips (idx, then the mask word) and
//      not on three a lane;
//   4. the tile goes out by one bulk copy (cp.async.bulk from shared to
//      global memory, one thread issuing it; 16-byte coalesced stores were
//      4% slower on the 182-type table, PERF.md §5); its unaligned head
//      and tail words, only where a tile's span does not start or end on
//      16 bytes, by plain stores.
// The tile's largest rank and its collisions (each entry against the one
// before it) fold into max_rank by one atomicMax a block.  No lane divides
// by the row width or by S: the table's lanes are written from shared
// memory in order, so its write is the only stream to device memory that
// scales with the table.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_WORDS = 8192;    // lanes a tile: 32 KiB of shared memory
constexpr int MAX_ROWS = 1024;      // rows a tile at the narrowest widths
constexpr int CHUNK = 1 << 16;      // entries a pass of step 3: CHUNK (3 + Wm) < 2^32
constexpr int UNROLL = 4;           // lanes a thread loads at once in step 3
constexpr int N_MAX = INT32_MAX - 2 * CHUNK + 1;  // entries: e0 + CHUNK never wraps
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

// The first index e in [0, n) with bucket[e] >= key (n if none), by the
// whole warp: each step 32 lanes probe the range at even spacing and a
// ballot of "below key" cuts it to one spacing.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ bucket, int n,
                                                int key, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int c = __popc(__ballot_sync(FULL, p < hi && __ldg(bucket + p) < key));
    if (c == 0) return lo;  // bucket[lo] >= key
    const int nlo = lo + (c - 1) * step + 1;  // past the last probe below key
    const long long cut = (long long)lo + (long long)c * step;  // the first probe at or past key
    hi = cut < hi ? (int)cut : hi;
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(FULL, lo + lane < hi && __ldg(bucket + lo + lane) < key));
}

__global__ void __launch_bounds__(THREADS) set_table_fill_kernel(
    const int32_t* __restrict__ bucket, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ occ, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ masks, int n, int nb, int S,
    int Wm, int rows, int windows, int32_t* __restrict__ table, int32_t* __restrict__ max_rank) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int range[2];
  __shared__ int block_max;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = S * (3 + Wm);

  // the tile: rows [b0, b0 + nbk), lanes [c0, c0 + cw) of each
  int b0, nbk, c0, cw;
  if (windows == 1) {
    b0 = blockIdx.x * rows;
    nbk = min(rows, nb - b0);
    c0 = 0;
    cw = width;
  } else {  // one row a block, cut into windows of TILE_WORDS lanes
    b0 = blockIdx.x / windows;
    nbk = 1;
    c0 = (blockIdx.x - b0 * windows) * TILE_WORDS;
    cw = min(TILE_WORDS, width - c0);
  }
  const long long G = (long long)b0 * width + c0;  // the tile's first lane in the table
  const int tw = nbk * cw;
  int* run_start = reinterpret_cast<int*>(smem);             // [rows]
  uint32_t* base = smem + ((rows + 3) & ~3);                 // 16-byte aligned
  uint32_t* tile = base + (int)(G & 3);                      // G's alignment mod 16 bytes

  // 1. the tile's entries; the tile zeroed meanwhile
  if (warp < 2) {
    const int at = warp_lower_bound(bucket, n, b0 + warp * nbk, lane);
    if (lane == 0) range[warp] = at;
  }
  if (threadIdx.x == 0) block_max = -1;
  const int q4 = ((int)(G & 3) + tw + 3) >> 2;
  for (int q = threadIdx.x; q < q4; q += THREADS)
    reinterpret_cast<uint4*>(base)[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int s0 = range[0], s1 = range[1];

  // 2. empty occ lanes; the run starts and the collisions (an entry against
  // the one before it, all six words loaded together)
  const int o0 = max(2 * S - c0, 0), o1 = min(3 * S - c0, cw);
  for (int r = warp; r < nbk && o0 < o1; r += WARPS)
    for (int c = o0 + lane; c < o1; c += 32) tile[r * cw + c] = FULL;
  int mine = -1;
  for (int e = s0 + threadIdx.x; e < s1; e += THREADS) {
    const int p = e > s0 ? e - 1 : e;
    const int b = __ldg(bucket + e), pb = __ldg(bucket + p);
    const int32_t l = __ldg(lo + e), pl = __ldg(lo + p), o = __ldg(occ + e), po = __ldg(occ + p);
    if (p == e || pb != b) {
      run_start[b - b0] = e;
    } else if (l == pl && o == po) {
      mine = S;  // two entries of one bucket with equal (lo, occ)
    }
  }
  __syncthreads();

  // 3. the entries' lanes, UNROLL a thread at once: every load first (an
  // entry's idx holds a row of masks whatever its rank), then the ranks and
  // the shared stores
  const unsigned groups = 3u + (unsigned)Wm;
  for (int e0 = s0; e0 < s1; e0 += CHUNK) {
    const unsigned total = (unsigned)min(CHUNK, s1 - e0) * groups;
    for (unsigned k0 = threadIdx.x; k0 < total; k0 += UNROLL * THREADS) {
      int e[UNROLL], j[UNROLL], b[UNROLL];
      uint32_t v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned k = k0 + u * THREADS;
        e[u] = -1;
        if (k < total) {
          const unsigned d = k / groups;
          j[u] = (int)(k - d * groups);
          e[u] = e0 + (int)d;
          b[u] = __ldg(bucket + e[u]);
          v[u] = j[u] >= 3 ? __ldg(masks + (long long)__ldg(idx + e[u]) * Wm + (j[u] - 3))
                           : __ldg((j[u] == 0 ? hi : j[u] == 1 ? lo : occ) + e[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e[u] < 0) continue;
        const int rank = e[u] - run_start[b[u] - b0];
        if (j[u] == 0) mine = max(mine, rank);
        const int c = j[u] * S + rank - c0;
        if (rank < S && c >= 0 && c < cw) tile[(b[u] - b0) * cw + c] = v[u];
      }
    }
  }
  mine = __reduce_max_sync(FULL, mine);
  if (lane == 0 && mine >= 0) atomicMax(&block_max, mine);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tile, seen by step 4's copy
  __syncthreads();
  if (threadIdx.x == 0 && block_max >= 0) atomicMax(max_rank, block_max);

  // 4. the tile out: head [G, h), 16-byte body [h, z), tail [z, G + tw)
  const long long end = G + tw;
  const long long up = (G + 3) & ~3LL, down = end & ~3LL;
  const long long h = up < end ? up : end;
  const long long z = down > h ? down : h;
  uint32_t* out = reinterpret_cast<uint32_t*>(table);
  if (threadIdx.x < h - G) out[G + threadIdx.x] = tile[threadIdx.x];
  if (threadIdx.x < end - z) out[z + threadIdx.x] = tile[z - G + threadIdx.x];
  const int body4 = (int)((z - h) >> 2);
  if (threadIdx.x == 0 && body4 > 0) {
    const unsigned src = (unsigned)__cvta_generic_to_shared(tile + (h - G));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(out + h), "r"(src), "r"(body4 * 16) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // before the tile is freed
  }
}

}  // namespace

// bucket, lo, occ, hi, idx [n] int32, sorted by (bucket, lo, occ); bucket
// values in [0, nb] (nb: an entry left out), lo, occ, hi the entry's words,
// idx its row of masks [*, Wm] int32 (in range for every entry, whatever
// its rank) -> table [nb, S * (3 + Wm)] int32
// (every lane written; 16-byte aligned) and max_rank [1] int32 (holding -1
// before).  Requires 0 <= n <= 2^31 - 2^17, nb >= 1, 1 <= S, 1 <= Wm and 3 +
// Wm < 2^16.
extern "C" int rkmh_set_table_fill(const int32_t* bucket, const int32_t* lo,
                                   const int32_t* occ, const int32_t* hi, const int32_t* idx,
                                   const int32_t* masks, int n, int nb, int S, int Wm,
                                   int32_t* table, int32_t* max_rank, cudaStream_t stream) {
  if (n < 0 || n > N_MAX || nb < 1 || S < 1 || Wm < 1 || Wm >= (1 << 16) - 3 ||
      (reinterpret_cast<uintptr_t>(table) & 15))
    return (int)cudaErrorInvalidValue;
  const long long width = (long long)S * (3 + Wm);
  int rows = (int)std::min<long long>(MAX_ROWS, TILE_WORDS / width);
  long long windows = 1;
  if (rows == 0) {  // a row wider than a tile: windows of TILE_WORDS lanes
    rows = 1;
    windows = (width + TILE_WORDS - 1) / TILE_WORDS;
  } else if (rows >= 4) {
    rows &= ~3;  // every tile but the last starts and ends on 16 bytes
  }
  const long long blocks = windows == 1 ? ((long long)nb + rows - 1) / rows : nb * windows;
  if (width > INT32_MAX / 2 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  // run_start, then the tile with up to 3 lanes of alignment and a 16-byte store's overrun
  const size_t smem = 4 * (size_t)(((rows + 3) & ~3) + std::min<long long>(rows * width,
                                                                            TILE_WORDS) + 8);
  if (smem > SMEM_DEFAULT) {
    cudaFuncSetAttribute(set_table_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  set_table_fill_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      bucket, lo, occ, hi, idx, masks, n, nb, S, Wm, rows, (int)windows, table, max_rank);
  return (int)cudaGetLastError();
}
