// K12: the sparse margins of the VW trainer, and their gradient.
//
// It replaces the XLA chain of rkmh_tpu/ml/wabbit.py: `_margins` (:171-174,
// jnp.sum(w[idx] * val, axis=-1)), vmapped over the classes (:219), and its
// jax.grad (:195, :228), a scatter-add of val * dm into the weights.
//   forward:  m[c, n] = sum_f W[c, idx[n, f]] * val[n, f]
//   backward: dW[c, idx[n, f]] += val[n, f] * dm[c, n]
// The kernels read the weights class-minor: Wp [D, Cp] float32, row i the C
// weights of index i side by side, padded with zeros to Cp (1, 2, 4, 8, 12,
// 16, then multiples of 16; ops/sparse_margin.padded_classes), and write
// the gradient dWp in the same layout.  idx [N, F] int32 and val [N, F]
// float32 are in wabbit's padded layout (a short row is padded with idx 0,
// val 0), m [C, N] float32.  The wrapper (ops/sparse_margin.py) keeps idx
// in [0, D).
//
// What bounds it on the card: bytes.  Each pass reads idx and val once (8
// bytes an entry; ~33 MB at the per-read shape N = 4,096, F ~ 1,002) and
// C * 4 bytes of W (or dW) for each distinct index; the sums are a few
// operations a byte.  W (10.5 MB at D = 2**18, C = 10) sits in the L2, so
// what costs is the number of random L2 sectors an entry touches.
// * forward: a warp per example (row n); its lanes stride over the row, so
//   the idx and val loads coalesce.  A lane reads an entry's Cp weights as
//   16-byte vectors: one or two 32-byte sectors (C = 10: 48 bytes at a
//   16-byte offset, two sectors), not C sectors as a [C, D] layout needs.
//   It keeps the sums of TILE classes in registers (TILE = min(Cp, 16);
//   wider Cp takes several passes over the row), then the warp adds its 32
//   partial sums by shuffles and lane 0 writes m[c, n].  The order of the
//   sums is fixed, so a run repeats its bits, but it is not torch's order:
//   the plain version agrees to round-off.
// * backward: no atomics.  The caller's plan (ops/sparse_margin.MarginPlan,
//   built once a training run by a library sort, since idx and val do not
//   change across passes) holds the entries whose val is not 0 in a stable
//   order by (index, position): per entry n | HEAD (HEAD on the first
//   entry of each run of equal indices) and val, the runs' indices (keys),
//   and for each fixed-size chunk of that order the run of its first entry
//   and its first partial slot.  Pass 1 gives each chunk to a warp, so no
//   warp takes more than `chunk` entries however hot an index is.  A lane
//   takes 8 consecutive entries, gathers dm's row n (dmT [N, Cp], the
//   margins' gradient transposed, 16-byte vectors from the L1; the rows of
//   4 entries loaded together), multiplies by val and sums each run in
//   entry order; a run that lies inside the lane is written to dWp at
//   once; runs that cross lanes are joined by a segmented scan over the
//   lanes (shuffles, a fixed tree).  A run inside
//   the chunk is written to dWp by the lane that closes it; a run that
//   crosses a chunk's edge leaves one partial sum a chunk it touches, in
//   consecutive slots, and pass 2 (a warp per such run) adds its partials
//   in slot order and writes its row.  Every sum is taken in an order the
//   plan fixes, so the same inputs give the same bits on every run.  No
//   pass zeroes dWp first: pass 1's last blocks write zeros to the rows no
//   entry touches (the plan's bitmap), so each row is written once.  A
//   small kernel writes dmT before pass 1, which it lets start at once
//   (programmatic dependent launch): pass 1 waits for it only where it
//   first reads dmT, its zero-filling blocks not at all.  The three launch
//   from one entry point.
//
// Measured on the H100 while designing it (PERF.md section 5): at the
// pipeline's shape (N = 180) plain stores of the scattered gradient rows
// ran 2.4x slower than st.global.cg, 8 warps a block crowded a small
// plan's stores onto one SM, and a separate zeroing pass set the floor;
// hence L2-only stores, a warp a block, the zero-filling blocks (whose
// 16-byte stores cover whole sectors) and the early launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int PER_LANE = 8;             // consecutive sorted entries a lane takes
constexpr int GROUP = 4;                // of which it loads dm's rows together
constexpr int SPAN = 32 * PER_LANE;     // entries a warp takes a step; a chunk is a multiple
constexpr int32_t NOT_HEAD = 0x7fffffff;  // rows[e] & NOT_HEAD is the example n

// T consecutive floats at p (aligned to 16 bytes for T >= 4, 8 for T = 2)
template <int T>
__device__ __forceinline__ void load_tile(const float* __restrict__ p, float (&w)[T]) {
  if constexpr (T == 1) {
    w[0] = __ldg(p);
  } else if constexpr (T == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int j = 0; j < T / 4; ++j) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + j);
      w[4 * j] = x.x;
      w[4 * j + 1] = x.y;
      w[4 * j + 2] = x.z;
      w[4 * j + 3] = x.w;
    }
  }
}

// ... stored to the L2 only (st.global.cg): the gradient's rows are scattered
template <int T>
__device__ __forceinline__ void store_tile(float* p, const float (&w)[T]) {
  if constexpr (T == 1) {
    __stcg(p, w[0]);
  } else if constexpr (T == 2) {
    __stcg(reinterpret_cast<float2*>(p), make_float2(w[0], w[1]));
  } else {
#pragma unroll
    for (int j = 0; j < T / 4; ++j)
      __stcg(reinterpret_cast<float4*>(p) + j,
             make_float4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]));
  }
}

// Programmatic dependent launch (sm_90): pass 1 starts while the kernel
// that writes dmT runs, and waits for it (its memory visible) only before
// it reads dmT.
__device__ __forceinline__ void wait_for_dmT() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

template <int T>
__device__ __forceinline__ void warp_sum(float (&s)[T]) {
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[j] += __shfl_xor_sync(FULL, s[j], off);
}

template <int T>
__global__ void __launch_bounds__(WARPS * 32)
    margins_kernel(const float* __restrict__ Wp, const int32_t* __restrict__ idx,
                   const float* __restrict__ val, float* __restrict__ m, int N, int F, int C,
                   int Cp) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform: the shuffles below see full warps
  const int32_t* row_idx = idx + n * F;
  const float* row_val = val + n * F;
  for (int c0 = 0; c0 < C; c0 += T) {
    float acc[T];
#pragma unroll
    for (int j = 0; j < T; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int f = lane; f < F; f += 32) {
      const float v = row_val[f];
      float w[T];
      load_tile<T>(Wp + (int64_t)row_idx[f] * Cp + c0, w);
#pragma unroll
      for (int j = 0; j < T; ++j) acc[j] += w[j] * v;
    }
    warp_sum<T>(acc);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < T; ++j)
        if (c0 + j < C) m[(int64_t)(c0 + j) * N + n] = acc[j];
  }
}

// Pass 1 of the backward: a block of one warp a chunk of the plan's
// entries, then blocks that write zeros to every row no entry touches
// (the plan's bitmap `touched`): each row of dW is written once, by
// this pass or (a run that crosses a chunk's edge) by pass 2, and no
// pass zeroes dW first.  The run open at a step's start is in one of
// three states: NONE (the chunk starts a run: the run before belongs to
// the chunk before), PREV (it began in an earlier chunk: its sum here is a
// partial) or HERE (it began in this chunk: this warp writes it).
enum { NONE, PREV, HERE };

template <int T>
__global__ void __launch_bounds__(32, 16)
    grad_chunks_kernel(const int32_t* __restrict__ rows, const float* __restrict__ vals,
                       const int32_t* __restrict__ keys, const int32_t* __restrict__ chunk_run,
                       const int32_t* __restrict__ chunk_slot,
                       const uint32_t* __restrict__ touched, const float* __restrict__ dmT,
                       float* __restrict__ dW, float* __restrict__ part, int64_t E, int64_t D,
                       int chunk, int nchunks, int Cp) {
  const int lane = threadIdx.x;
  const int64_t j = blockIdx.x;
  if (j >= nchunks) {  // a zero-filling block: tiles of 32 rows, one bitmap word each
    for (int64_t r0 = 32 * (j - nchunks); r0 < D; r0 += 32 * (int64_t)(gridDim.x - nchunks)) {
      const uint32_t word = touched[r0 >> 5];
      const int n = (int)min((int64_t)32, D - r0) * Cp;  // the tile's floats, contiguous
      float* tile = dW + r0 * Cp;
      if (Cp % 4 == 0) {  // 16-byte stores, neighbouring lanes on neighbouring addresses
        for (int q = lane; 4 * q < n; q += 32)
          if (!((word >> (4 * q / Cp)) & 1u))
            __stcg(reinterpret_cast<float4*>(tile) + q, make_float4(0.f, 0.f, 0.f, 0.f));
      } else {
        for (int q = lane; q < n; q += 32)
          if (!((word >> (q / Cp)) & 1u)) __stcg(tile + q, 0.f);
      }
    }
    return;
  }
  const int64_t lo = j * chunk, hi = min(lo + chunk, E);
  const bool lo_head = rows[lo] < 0;
  const bool hi_head = hi == E || rows[hi] < 0;
  for (int c0 = 0; c0 < Cp; c0 += T) {
    int state = lo_head ? NONE : PREV;
    int run = chunk_run[j] - (lo_head ? 1 : 0);  // the open run's id
    int slot = chunk_slot[j];                    // the next partial's slot
    float carry[T];                              // the open run's sum so far
#pragma unroll
    for (int t = 0; t < T; ++t) carry[t] = 0.f;
    for (int64_t w0 = lo; w0 < hi; w0 += SPAN) {
      const int64_t e0 = w0 + lane * PER_LANE;
      const int cnt = (int)max((int64_t)0, min((int64_t)PER_LANE, hi - e0));
      int32_t r[PER_LANE];
      float v[PER_LANE];
      if (cnt == PER_LANE) {  // e0 is a multiple of PER_LANE: 16-byte loads
#pragma unroll
        for (int q = 0; q < PER_LANE / 4; ++q) {
          const int4 rq = reinterpret_cast<const int4*>(rows + e0)[q];
          const float4 vq = reinterpret_cast<const float4*>(vals + e0)[q];
          r[4 * q] = rq.x, r[4 * q + 1] = rq.y, r[4 * q + 2] = rq.z, r[4 * q + 3] = rq.w;
          v[4 * q] = vq.x, v[4 * q + 1] = vq.y, v[4 * q + 2] = vq.z, v[4 * q + 3] = vq.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          r[k] = k < cnt ? rows[e0 + k] : 0;
          v[k] = k < cnt ? vals[e0 + k] : 0.f;
        }
      }
      int heads = 0;
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) heads += (k < cnt && r[k] < 0) ? 1 : 0;
      int before = heads;  // inclusive scan of heads over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, before, d);
        if (lane >= d) before += t;
      }
      const int step_heads = __shfl_sync(FULL, before, 31);
      before -= heads;  // heads in the lanes before this one
      // the keys of the runs this lane closes, loaded together: kk[i] is run
      // run + before + i's (the run open at the lane's start, then the runs
      // its heads begin; run + before is -1 before a chunk's first entry)
      int32_t kk[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        kk[i] = (i < heads && run + before + i >= 0) ? keys[run + before + i] : 0;
      // the lane's entries: `first` sums those before its first head, `acc`
      // the segment open at its end; runs between two of its heads are written
      float first[T], acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) first[t] = acc[t] = 0.f;
      bool seen = false;
      int closed = 0;  // runs this lane has closed
      wait_for_dmT();
#pragma unroll
      for (int k0 = 0; k0 < PER_LANE; k0 += GROUP) {
        float d[GROUP][T];  // dm's rows, loaded before any is used (r[k] = 0 past cnt)
#pragma unroll
        for (int k = 0; k < GROUP; ++k)
          load_tile<T>(dmT + (int64_t)(r[k0 + k] & NOT_HEAD) * Cp + c0, d[k]);
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          if (k0 + k < cnt) {
            if (r[k0 + k] < 0) {
              if (seen) {
                int key = kk[1];
#pragma unroll
                for (int i = 2; i < PER_LANE; ++i) key = closed == i ? kk[i] : key;
                store_tile<T>(dW + (int64_t)key * Cp + c0, acc);
              } else {
#pragma unroll
                for (int t = 0; t < T; ++t) first[t] = acc[t];
                seen = true;
              }
#pragma unroll
              for (int t = 0; t < T; ++t) acc[t] = 0.f;
              ++closed;
            }
#pragma unroll
            for (int t = 0; t < T; ++t) acc[t] += v[k0 + k] * d[k][t];
          }
        }
      }
      // segmented inclusive scan over the lanes: a lane with a head starts
      // a segment, lane 0 starts one with the carry folded in
      if (lane == 0 && !seen)
#pragma unroll
        for (int t = 0; t < T; ++t) acc[t] = carry[t] + acc[t];
      bool flag = seen || lane == 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const bool up_flag = __shfl_up_sync(FULL, flag, d);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float up = __shfl_up_sync(FULL, acc[t], d);
          if (lane >= d && !flag) acc[t] = up + acc[t];
        }
        if (lane >= d) flag = flag || up_flag;
      }
      // acc is now the open run's sum up to this lane's last entry
      const unsigned seen_mask = __ballot_sync(FULL, seen);
      float in[T];  // the open run's sum at this lane's start
#pragma unroll
      for (int t = 0; t < T; ++t) {
        in[t] = __shfl_up_sync(FULL, acc[t], 1);
        if (lane == 0) in[t] = carry[t];
      }
      if (seen) {  // the lane's first head closes the run open at its start
        const int open = (seen_mask & ((1u << lane) - 1u)) ? HERE : state;
        if (open != NONE) {
#pragma unroll
          for (int t = 0; t < T; ++t) first[t] = in[t] + first[t];
          store_tile<T>(open == HERE ? dW + (int64_t)kk[0] * Cp + c0
                                     : part + (int64_t)slot * Cp + c0,
                        first);
        }
      }
      if (seen_mask) {
        if (state == PREV) ++slot;  // the chunk's first partial went out above
        state = HERE;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) carry[t] = __shfl_sync(FULL, acc[t], 31);
      run += step_heads;
    }
    // the run open at the chunk's end: whole if it began here and ends at hi
    if (lane == 0)
      store_tile<T>(hi_head && state == HERE ? dW + (int64_t)keys[run] * Cp + c0
                                             : part + (int64_t)slot * Cp + c0,
                    carry);
  }
}

// Before pass 1: dmT [N, Cp] from dm [C, N], the padding columns 0.  Its
// blocks let pass 1 launch at once.
__global__ void __launch_bounds__(256)
    grad_transpose_kernel(const float* __restrict__ dm, float* __restrict__ dmT, int N, int C,
                          int Cp) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * Cp) return;
  const int64_t n = i / Cp;
  const int c = (int)(i - n * Cp);
  dmT[i] = c < C ? dm[(int64_t)c * N + n] : 0.f;
}

// Pass 2: one warp a run that crosses a chunk's edge; its partials lie in
// slots [cross_slot[i], cross_slot[i + 1]), added lane-strided and by a
// fixed shuffle tree.
template <int T>
__global__ void __launch_bounds__(WARPS * 32)
    grad_cross_kernel(const float* __restrict__ part, const int32_t* __restrict__ cross_key,
                      const int32_t* __restrict__ cross_slot, float* __restrict__ dW, int X,
                      int Cp) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= X) return;
  const int s0 = cross_slot[i], s1 = cross_slot[i + 1];
  for (int c0 = 0; c0 < Cp; c0 += T) {
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int s = s0 + lane; s < s1; s += 32) {
      float p[T];
      load_tile<T>(part + (int64_t)s * Cp + c0, p);
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] += p[t];
    }
    warp_sum<T>(acc);
    if (lane == 0) store_tile<T>(dW + (int64_t)cross_key[i] * Cp + c0, acc);
  }
}

unsigned blocks_for(int64_t warps) { return (unsigned)((warps + WARPS - 1) / WARPS); }

// TILE for a padded class count: Cp itself up to 16, else 16 (Cp a multiple of 16)
int tile_of(int Cp) {
  if (Cp == 1 || Cp == 2 || Cp == 4 || Cp == 8 || Cp == 12 || Cp == 16) return Cp;
  return (Cp > 16 && Cp % 16 == 0) ? 16 : 0;
}

}  // namespace

extern "C" int rkmh_sparse_margin(const float* Wp, const int32_t* idx, const float* val, float* m,
                                  int N, int F, int C, int Cp, cudaStream_t stream) {
  const unsigned blocks = blocks_for(N);
  switch (C > Cp ? 0 : tile_of(Cp)) {
#define K12_FWD(T)                                                                          \
  case T:                                                                                   \
    margins_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(Wp, idx, val, m, N, F, C, Cp); \
    break;
    K12_FWD(1) K12_FWD(2) K12_FWD(4) K12_FWD(8) K12_FWD(12) K12_FWD(16)
#undef K12_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rkmh_sparse_margin_grad(const float* dm, const int32_t* rows, const float* vals,
                                       const int32_t* keys, const int32_t* chunk_run,
                                       const int32_t* chunk_slot, const int32_t* cross_key,
                                       const int32_t* cross_slot, const uint32_t* touched,
                                       float* dmT, float* dW, float* part, int N, int C,
                                       long long D, long long E, int chunk, int nchunks, int X,
                                       int Cp, cudaStream_t stream) {
  if (chunk <= 0 || chunk % SPAN != 0 || C > Cp || !tile_of(Cp))
    return (int)cudaErrorInvalidValue;
  const int64_t n_dmT = (int64_t)N * Cp;
  grad_transpose_kernel<<<(unsigned)((n_dmT + 255) / 256), 256, 0, stream>>>(dm, dmT, N, C, Cp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // pass 1's chunks, then zero-filling blocks: 8 an SM (of its 32), 1 to 8 tiles each
  const int64_t zero_blocks = min((int64_t)((D + 255) / 256), (int64_t)132 * 8);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nchunks + zero_blocks));
  cfg.blockDim = dim3(32);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  switch (tile_of(Cp)) {
#define K12_BWD(T)                                                                            \
  case T:                                                                                     \
    err = (int)cudaLaunchKernelEx(&cfg, grad_chunks_kernel<T>, rows, vals, keys, chunk_run,   \
                                  chunk_slot, touched, (const float*)dmT, dW, part,           \
                                  (int64_t)E, (int64_t)D, chunk, nchunks, Cp);                \
    if (err) return err;                                                                      \
    if (X > 0)                                                                                \
      grad_cross_kernel<T><<<blocks_for(X), WARPS * 32, 0, stream>>>(part, cross_key,       \
                                                                     cross_slot, dW, X, Cp); \
    break;
    K12_BWD(1) K12_BWD(2) K12_BWD(4) K12_BWD(8) K12_BWD(12) K12_BWD(16)
#undef K12_BWD
  }
  return (int)cudaGetLastError();
}
