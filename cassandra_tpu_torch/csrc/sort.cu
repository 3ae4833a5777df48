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
//
// The passes (`radix_sort_perm`) also serve the plane programs K6 and
// K7 (planes.cu), whose keys are 1, 2 or 4 bytes wide: a key costs one
// pass per byte, so K1's 32-bit keys keep their four passes each. The
// segmented form (`radix_sort_perm_seg`) sorts S equal segments of the
// rows in the same passes, each inside its own rows: the mesh step K8
// (mesh.cu). A tile never crosses a segment's edge, and the histogram
// table is segment-major, so the one scan per pass gives every segment
// its rows' offsets with no key pass spent on the segment id.
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

__device__ __forceinline__ int digit_of(const SortKey& k, int shift,
                                        int p) {
  const long at = (long)p * k.stride;
  uint32_t v;
  if (k.width == 4)
    v = static_cast<const uint32_t*>(k.p)[at];
  else if (k.width == 2)
    v = static_cast<const uint16_t*>(k.p)[at];
  else
    v = static_cast<const uint8_t*>(k.p)[at];
  return (int)(((v ^ k.xmask) >> shift) & (RADIX - 1));
}

// Tile t of the pass is tile t % tps of segment t / tps: rows
// [base, end) below, never across a segment's edge. Its histogram and
// offsets sit at hist[(segment * RADIX + digit) * tps + tile], so one
// exclusive scan of the table places every segment's rows inside the
// segment's own range (each segment holds seg_len rows).
struct Tile {
  int seg, tile, base, end;
};

__device__ __forceinline__ Tile tile_of(int seg_len, int tps) {
  Tile t;
  t.seg = blockIdx.x / tps;
  t.tile = blockIdx.x % tps;
  const int seg0 = t.seg * seg_len;
  t.base = seg0 + t.tile * SORT_TILE;
  t.end = seg0 + min((t.tile + 1) * SORT_TILE, seg_len);
  return t;
}

__global__ void __launch_bounds__(SORT_THREADS)
digit_hist(SortKey key, int shift, const int* perm, int seg_len, int tps,
           int* hist) {
  __shared__ int h[RADIX];
  const int tid = threadIdx.x;
  h[tid] = 0;
  __syncthreads();
  const Tile t = tile_of(seg_len, tps);
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int i = t.base + r * SORT_THREADS + tid;
    if (i < t.end) atomicAdd(&h[digit_of(key, shift, perm[i])], 1);
  }
  __syncthreads();
  hist[((long)t.seg * RADIX + tid) * tps + t.tile] = h[tid];
}

__global__ void __launch_bounds__(SORT_THREADS)
digit_scatter(SortKey key, int shift, const int* perm_in, int* perm_out,
              int seg_len, int tps, const int* offs) {
  __shared__ int run[RADIX];
  __shared__ int wcnt[SORT_WARPS][RADIX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const Tile t = tile_of(seg_len, tps);
  run[tid] = offs[((long)t.seg * RADIX + tid) * tps + t.tile];
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    for (int j = tid; j < SORT_WARPS * RADIX; j += SORT_THREADS)
      (&wcnt[0][0])[j] = 0;
    __syncthreads();
    const int i = t.base + r * SORT_THREADS + tid;
    const bool valid = i < t.end;
    const int p = valid ? perm_in[i] : 0;
    // out-of-range lanes take digit RADIX: they match only each other
    const int d = valid ? digit_of(key, shift, p) : RADIX;
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

}  // namespace

long radix_seg_scratch_bytes(int n_seg, int seg_len) {
  const long tps = (seg_len + SORT_TILE - 1) / SORT_TILE;
  const long hist = (long)RADIX * n_seg * tps;
  return (hist + scan_scratch_elems(hist)) * (long)sizeof(int);
}

long radix_scratch_bytes(int n) { return radix_seg_scratch_bytes(1, n); }

void radix_sort_perm_seg(const SortKey* keys, int nk, int n_seg,
                         int seg_len, int* perm, int* perm_tmp,
                         void* scratch, cudaStream_t s) {
  const int n = n_seg * seg_len;
  const int tps = (seg_len + SORT_TILE - 1) / SORT_TILE;
  const long hist_n = (long)RADIX * n_seg * tps;
  int* hist = (int*)scratch;
  int* scan_scr = hist + hist_n;
  iota<<<grid_for(n, 256), 256, 0, s>>>(perm, n);
  int* a = perm;
  int* b = perm_tmp;
  for (int q = 0; q < nk; ++q) {
    for (int shift = 0; shift < 8 * keys[q].width; shift += 8) {
      digit_hist<<<n_seg * tps, SORT_THREADS, 0, s>>>(keys[q], shift, a,
                                                      seg_len, tps, hist);
      scan_add_exclusive(hist, hist, hist_n, scan_scr, s);
      digit_scatter<<<n_seg * tps, SORT_THREADS, 0, s>>>(
          keys[q], shift, a, b, seg_len, tps, hist);
      int* t = a;
      a = b;
      b = t;
    }
  }
  // an odd number of passes leaves the result in perm_tmp
  if (a != perm)
    cudaMemcpyAsync(perm, a, (size_t)n * sizeof(int),
                    cudaMemcpyDeviceToDevice, s);
}

void radix_sort_perm(const SortKey* keys, int nk, int n, int* perm,
                     int* perm_tmp, void* scratch, cudaStream_t s) {
  radix_sort_perm_seg(keys, nk, 1, n, perm, perm_tmp, scratch, s);
}

}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_sort_scratch_bytes(int n) {
  return radix_scratch_bytes(n);
}

// perm (int32[n]) receives the permutation; perm_tmp (int32[n]) and
// scratch (ctpu_sort_scratch_bytes(n) bytes) are work space.
extern "C" int ctpu_sort_perm(const uint32_t* lanes, int K,
                              const uint32_t* valid, const uint32_t* ts_h,
                              const uint32_t* ts_l, int n, int* perm,
                              int* perm_tmp, void* scratch, void* stream) {
  // least significant key first: ~ts_l, ~ts_h, lanes[K-1..0], valid
  SortKey keys[3 + 64];
  int nk = 0;
  keys[nk++] = {ts_l, 1, 4, 0xffffffffu};
  keys[nk++] = {ts_h, 1, 4, 0xffffffffu};
  for (int k = K - 1; k >= 0; --k) keys[nk++] = {lanes + k, K, 4, 0u};
  keys[nk++] = {valid, 1, 4, 0u};
  // 4 * (K + 3) passes: an even count, the result lands in `perm`
  radix_sort_perm(keys, nk, n, perm, perm_tmp, scratch,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
