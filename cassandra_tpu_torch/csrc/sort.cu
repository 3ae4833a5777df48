// K1: the stable lexicographic sort permutation of a merge round.
//
// Replaces cassandra_tpu/ops/merge.py `_lsd_pass` as chained by
// `_traced_sort_perm` (`device_sort_perm`): the sort over (valid,
// lanes[0..K-1], ~ts_h, ~ts_l), most significant first. The JAX package
// runs K+3 stable (key, perm) sorts, least significant key first; here
// each 32-bit key becomes four stable radix passes of 8-bit digits, so
// the whole sort is 4 * (K + 3) passes. A stable lexicographic sort has
// exactly one result, so the permutation is the JAX package's.
//
// Bound on this card: bytes. Read once, the keys are (K + 3) * 4 B and
// the permutation 4 B per row: at N = 524,288 and K = 13 that is
// 35.7 MB, about 11 us at 3.35 TB/s. This design moves far more: every
// pass reads key[perm[i]] through the permutation (a gather, never
// materialised) twice (histogram and scatter) and writes the new
// permutation, and the passes do not skip digits that are constant in
// the round. It is the simple, exact version; fusing digits and
// skipping constant ones is later work.
//
// Each pass: (1) a per-tile histogram of the digit, stored digit-major
// (hist[d * tiles + t]); (2) an exclusive add-scan of that table, which
// gives every (digit, tile) its first output slot; (3) a stable scatter
// that ranks each element inside its tile: the tile is walked in rounds
// of 256 elements in input order, `__match_any_sync` finds the lanes of
// a warp that share a digit, per-warp digit counts in shared memory
// order the warps, and a running per-digit count carries the order
// from one round to the next.
#include "common.cuh"

namespace ctpu {
namespace {

constexpr int SORT_THREADS = 256;
constexpr int SORT_ROUNDS = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ROUNDS;
constexpr int RADIX = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;

__global__ void iota(int* p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = i;
}

__device__ __forceinline__ int digit_of(const uint32_t* key, int stride,
                                        uint32_t xmask, int shift, int p) {
  const uint32_t k = key[(long)p * stride] ^ xmask;
  return (int)((k >> shift) & (RADIX - 1));
}

__global__ void __launch_bounds__(SORT_THREADS)
digit_hist(const uint32_t* key, int stride, uint32_t xmask, int shift,
           const int* perm, int n, int tiles, int* hist) {
  __shared__ int h[RADIX];
  const int tid = threadIdx.x;
  h[tid] = 0;
  __syncthreads();
  const int base = blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int i = base + r * SORT_THREADS + tid;
    if (i < n) atomicAdd(&h[digit_of(key, stride, xmask, shift, perm[i])], 1);
  }
  __syncthreads();
  hist[tid * tiles + blockIdx.x] = h[tid];
}

__global__ void __launch_bounds__(SORT_THREADS)
digit_scatter(const uint32_t* key, int stride, uint32_t xmask, int shift,
              const int* perm_in, int* perm_out, int n, int tiles,
              const int* offs) {
  __shared__ int run[RADIX];
  __shared__ int wcnt[SORT_WARPS][RADIX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  run[tid] = offs[tid * tiles + blockIdx.x];
  const int base = blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    for (int j = tid; j < SORT_WARPS * RADIX; j += SORT_THREADS)
      (&wcnt[0][0])[j] = 0;
    __syncthreads();
    const int i = base + r * SORT_THREADS + tid;
    const bool valid = i < n;
    const int p = valid ? perm_in[i] : 0;
    // out-of-range lanes take digit RADIX: they match only each other
    const int d = valid ? digit_of(key, stride, xmask, shift, p) : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lt_mask);
    if (valid && lane == __ffs(peers) - 1) wcnt[w][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = run[d] + rank;
      for (int w2 = 0; w2 < w; ++w2) pos += wcnt[w2][d];
      perm_out[pos] = p;
    }
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int w2 = 0; w2 < SORT_WARPS; ++w2) s += wcnt[w2][tid];
    run[tid] += s;
    __syncthreads();
  }
}

struct Key {
  const uint32_t* p;
  int stride;
  uint32_t xmask;
};

}  // namespace
}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_sort_scratch_bytes(int n) {
  const long tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const long hist = (long)RADIX * tiles;
  return (hist + scan_scratch_elems(hist)) * (long)sizeof(int);
}

// perm (int32[n]) receives the permutation; perm_tmp (int32[n]) and
// scratch (ctpu_sort_scratch_bytes(n) bytes) are work space.
extern "C" int ctpu_sort_perm(const uint32_t* lanes, int K,
                              const uint32_t* valid, const uint32_t* ts_h,
                              const uint32_t* ts_l, int n, int* perm,
                              int* perm_tmp, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n + SORT_TILE - 1) / SORT_TILE;
  int* hist = (int*)scratch;
  int* scan_scr = hist + (long)RADIX * tiles;
  iota<<<grid_for(n, 256), 256, 0, s>>>(perm, n);
  // least significant key first: ~ts_l, ~ts_h, lanes[K-1..0], valid
  Key keys[3 + 64];
  int nk = 0;
  keys[nk++] = {ts_l, 1, 0xffffffffu};
  keys[nk++] = {ts_h, 1, 0xffffffffu};
  for (int k = K - 1; k >= 0; --k) keys[nk++] = {lanes + k, K, 0u};
  keys[nk++] = {valid, 1, 0u};
  int* a = perm;
  int* b = perm_tmp;
  for (int q = 0; q < nk; ++q) {
    for (int shift = 0; shift < 32; shift += 8) {
      digit_hist<<<tiles, SORT_THREADS, 0, s>>>(keys[q].p, keys[q].stride,
                                                keys[q].xmask, shift, a, n,
                                                tiles, hist);
      scan_add_exclusive(hist, hist, (long)RADIX * tiles, scan_scr, s);
      digit_scatter<<<tiles, SORT_THREADS, 0, s>>>(
          keys[q].p, keys[q].stride, keys[q].xmask, shift, a, b, n, tiles,
          hist);
      int* t = a;
      a = b;
      b = t;
    }
  }
  // 4 * (K + 3) passes is even: the result is back in `perm`
  return (int)cudaGetLastError();
}
