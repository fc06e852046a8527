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
// Design: a block takes TILE consecutive buckets.  Their first entries
// come from one binary search each over the sorted buckets (lower_bound
// of b), kept in shared memory; then the block writes the tile's lanes in
// order, one thread a lane, so the table (the function's bytes) is
// written coalesced.  A lane reads its entry's hi, lo or occ word, or one
// mask word of the entry's row (a gather by entry index).  The tile's
// fullest bucket gives its max rank and its entries its collisions (each
// beside the one before it), folded into max_rank by one atomicMax a
// block.
//
// What bounds it on the card: the table's bytes (480 MiB for the hpv16
// 182-type panel) written once, beside the entries' 20 + 4 Wm bytes read
// once: ~0.16 ms at 3.35 TB/s.  The per-lane division by the row width
// and by S is integer arithmetic far under the write's time.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;  // buckets a block

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ bucket, int n,
                                           long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(bucket + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) set_table_fill_kernel(
    const int32_t* __restrict__ bucket, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ occ, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ masks, int n, int nb, int S,
    int Wm, int32_t* __restrict__ table, int32_t* __restrict__ max_rank) {
  __shared__ int start[TILE + 1];
  __shared__ int block_max;
  const long long b0 = (long long)blockIdx.x * TILE;
  const int nbk = (int)min((long long)TILE, nb - b0);
  if (threadIdx.x == 0) block_max = -1;
  for (int t = threadIdx.x; t <= nbk; t += THREADS) start[t] = lower_bound(bucket, n, b0 + t);
  __syncthreads();

  // the tile's max rank and its (lo, occ) collisions
  int mine = -1;
  for (int t = threadIdx.x; t < nbk; t += THREADS) mine = max(mine, start[t + 1] - start[t] - 1);
  for (int e = start[0] + 1 + threadIdx.x; e < start[nbk]; e += THREADS) {
    if (__ldg(bucket + e) == __ldg(bucket + e - 1) && __ldg(lo + e) == __ldg(lo + e - 1) &&
        __ldg(occ + e) == __ldg(occ + e - 1))
      mine = max(mine, S);
  }
  if (mine >= 0) atomicMax(&block_max, mine);

  // the tile's lanes, in order
  const int width = S * (3 + Wm);
  const long long lanes = (long long)nbk * width;
  int32_t* out = table + b0 * width;
  for (long long i = threadIdx.x; i < lanes; i += THREADS) {
    const int row = (int)(i / width);
    const int c = (int)(i - (long long)row * width);
    const int j = c / S;
    const int r = c - j * S;
    const int s0 = start[row];
    int32_t v = j == 2 ? -1 : 0;
    if (r < start[row + 1] - s0) {
      const int e = s0 + r;
      v = j == 0 ? __ldg(hi + e)
        : j == 1 ? __ldg(lo + e)
        : j == 2 ? __ldg(occ + e)
        : __ldg(masks + (long long)__ldg(idx + e) * Wm + (j - 3));
    }
    out[i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_max >= 0) atomicMax(max_rank, block_max);
}

}  // namespace

// bucket, lo, occ, hi, idx [n] int32, sorted by (bucket, lo, occ); bucket
// values in [0, nb] (nb: an entry left out), lo, occ, hi the entry's words,
// idx its row of masks [*, Wm] int32 -> table [nb, S * (3 + Wm)] int32
// (every lane written) and max_rank [1] int32 (holding -1 before).
// Requires n >= 0, nb >= 1, 1 <= S, 1 <= Wm.
extern "C" int rkmh_set_table_fill(const int32_t* bucket, const int32_t* lo,
                                   const int32_t* occ, const int32_t* hi, const int32_t* idx,
                                   const int32_t* masks, int n, int nb, int S, int Wm,
                                   int32_t* table, int32_t* max_rank, cudaStream_t stream) {
  if (n < 0 || nb < 1 || S < 1 || Wm < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)nb + TILE - 1) / TILE;
  set_table_fill_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      bucket, lo, occ, hi, idx, masks, n, nb, S, Wm, table, max_rank);
  return (int)cudaGetLastError();
}
