// K5: the LZ4 policy match scan of one full output segment.
//
// Replaces cassandra_tpu/ops/device_compress.py `_policy_scan` as
// jitted in `_scan_kernel` and `segment_scan_kernel`: the little-endian
// byte-plane shuffle of the segment's u32 lanes (planes[(4k+b)*n + i]
// is byte b of lanes[i, k]), the u32-lexicographic order check of the
// lane rows, and, over the META block and over the planes, for every
// position i the longest forward run src[i..] == src[i-d..] over the
// 73 candidate distances (ascending; a run replaces the best only when
// strictly longer, so ties keep the smallest d). The host emits the
// LZ4 sequences from (best_len, best_d).
//
// Bound on this card: operations. Read once, the inputs are the META
// block (25 B/cell) and the lanes (52 B/cell at K = 13); the outputs
// are the planes and four int32 arrays: at 65,536 cells about 49 MB,
// 15 us at 3.35 TB/s. The scan does at least four integer operations
// per (position, distance) (the shifted compare, the running minimum,
// the run length and the strict-greater update): 73 x 5.05 M x 4 =
// 1.5 G, about 22 us at the 67 T/s non-tensor rate.
//
// Design. For distance d the run at i is nxt(i) - i, where nxt(i) is
// the first j >= i with j < d or src[j] != src[j-d], and n if there is
// none. The lane planes hold long constant stretches (the high bytes of
// small lanes are zero for whole planes), so runs reach hundreds of
// thousands of bytes and a forward walk per position would be
// quadratic. nxt is a reverse minimum instead, in three launches:
// (1) every tile of 1,024 positions records its first mismatch for each
// distance; (2) a reverse exclusive minimum over the tiles, per
// distance, gives each tile the first mismatch after it; (3) each tile
// recomputes its in-tile suffix minimum (thread-local, then warp
// shuffles, then across warps) and combines it with that carry. Each
// thread keeps best_len / best_d for its four positions in registers
// across the distance loop. The inputs (5 MB) stay in the 50 MB L2, so
// the look-back src[i-d] (up to 32,768 back) reads global memory.
#include "common.cuh"

namespace ctpu {
namespace {

// The candidate distances, ascending: 1..64, then 128, 256, ..., 32768.
// Must stay identical to DISTANCES in ops/device_compress.py (and to
// LZ4_DIST in ops/native/codec.cpp).
constexpr int LZ_NDIST = 73;

__host__ __device__ __forceinline__ int lz_dist(int k) {
  return k < 64 ? k + 1 : 128 << (k - 64);
}

constexpr int LZ_THREADS = 256;
constexpr int LZ_ITEMS = 4;
constexpr int LZ_TILE = LZ_THREADS * LZ_ITEMS;
constexpr int LZ_WARPS = LZ_THREADS / 32;

inline int lz_tiles(long n) { return (int)((n + LZ_TILE - 1) / LZ_TILE); }

// Distances below n (the JAX package stops at the first d >= n).
inline int lz_ndist(long n) {
  int k = 0;
  while (k < LZ_NDIST && lz_dist(k) < n) ++k;
  return k;
}

// The mismatch position j (j < d or src[j] != src[j-d]), else n.
__device__ __forceinline__ int mismatch_at(const uint8_t* src, int n,
                                           int d, int j, uint8_t cur) {
  if (j >= n) return n;
  if (j < d) return j;
  return cur != __ldg(src + j - d) ? j : n;
}

__global__ void __launch_bounds__(LZ_THREADS)
lz_first(const uint8_t* src, int n, int nd, int tiles, int* fm) {
  __shared__ int wmin[LZ_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int i0 = blockIdx.x * LZ_TILE + tid * LZ_ITEMS;
  uint8_t cur[LZ_ITEMS];
#pragma unroll
  for (int j = 0; j < LZ_ITEMS; ++j)
    cur[j] = i0 + j < n ? src[i0 + j] : 0;
  for (int dk = 0; dk < nd; ++dk) {
    const int d = lz_dist(dk);
    int m = n;
#pragma unroll
    for (int j = LZ_ITEMS - 1; j >= 0; --j)
      m = min(m, mismatch_at(src, n, d, i0 + j, cur[j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) wmin[w] = m;
    __syncthreads();
    if (tid == 0) {
      int t = wmin[0];
#pragma unroll
      for (int k = 1; k < LZ_WARPS; ++k) t = min(t, wmin[k]);
      fm[(long)dk * tiles + blockIdx.x] = t;
    }
    __syncthreads();
  }
}

// carry[dk][t] = min(fm[dk][t+1 ..]), n when t is the last tile. One
// block per distance walks the tiles from the end in chunks of 1,024.
__global__ void __launch_bounds__(1024)
lz_carry(const int* fm, int n, int tiles, int* carry) {
  __shared__ int wtot[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int* f = fm + (long)blockIdx.x * tiles;
  int* c = carry + (long)blockIdx.x * tiles;
  int run = n;
  for (int end = tiles; end > 0; end -= 1024) {
    const int t = end - 1 - tid;           // thread order runs backward
    const int v = t >= 0 ? f[t] : n;
    int x = v;                             // inclusive min over threads
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = min(x, y);
    }
    if (lane == 31) wtot[w] = x;
    __syncthreads();
    if (w == 0) {
      int s = wtot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s = min(s, y);
      }
      wtot[lane] = s;
    }
    __syncthreads();
    int excl = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) excl = n;
    if (w > 0) excl = min(excl, wtot[w - 1]);
    if (t >= 0) c[t] = min(run, excl);
    run = min(run, wtot[31]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(LZ_THREADS)
lz_final(const uint8_t* src, int n, int nd, int tiles, const int* carry,
         int* best_len, int* best_d) {
  __shared__ int wsuf[LZ_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int i0 = blockIdx.x * LZ_TILE + tid * LZ_ITEMS;
  uint8_t cur[LZ_ITEMS];
  int bl[LZ_ITEMS], bd[LZ_ITEMS];
#pragma unroll
  for (int j = 0; j < LZ_ITEMS; ++j) {
    cur[j] = i0 + j < n ? src[i0 + j] : 0;
    bl[j] = 0;
    bd[j] = 0;
  }
  for (int dk = 0; dk < nd; ++dk) {
    const int d = lz_dist(dk);
    // suffix minimum of the mismatch positions over this thread's items
    int suf[LZ_ITEMS];
    int m = n;
#pragma unroll
    for (int j = LZ_ITEMS - 1; j >= 0; --j) {
      m = min(m, mismatch_at(src, n, d, i0 + j, cur[j]));
      suf[j] = m;
    }
    // inclusive suffix minimum over the lanes of the warp
    int x = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, x, o);
      if (lane + o < 32) x = min(x, y);
    }
    if (lane == 0) wsuf[w] = x;
    __syncthreads();
    int later = __shfl_down_sync(0xffffffffu, x, 1);
    if (lane == 31) later = n;
    for (int k = w + 1; k < LZ_WARPS; ++k) later = min(later, wsuf[k]);
    later = min(later, carry[(long)dk * tiles + blockIdx.x]);
#pragma unroll
    for (int j = 0; j < LZ_ITEMS; ++j) {
      const int i = i0 + j;
      const int run = min(suf[j], later) - i;
      if (i < n && run > bl[j]) {
        bl[j] = run;
        bd[j] = d;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < LZ_ITEMS; ++j) {
    if (i0 + j < n) {
      best_len[i0 + j] = bl[j];
      best_d[i0 + j] = bd[j];
    }
  }
}

void match_scan(const uint8_t* src, int n, int* best_len, int* best_d,
                int* scratch, cudaStream_t s) {
  if (n <= 0) return;
  const int tiles = lz_tiles(n);
  const int nd = lz_ndist(n);
  int* fm = scratch;
  int* carry = fm + (long)LZ_NDIST * tiles;
  if (nd > 0) {
    lz_first<<<tiles, LZ_THREADS, 0, s>>>(src, n, nd, tiles, fm);
    lz_carry<<<nd, 1024, 0, s>>>(fm, n, tiles, carry);
  }
  lz_final<<<tiles, LZ_THREADS, 0, s>>>(src, n, nd, tiles, carry, best_len,
                                        best_d);
}

// planes[(4c + b) * rows + i] = byte b of lanes[i, c]
__global__ void lz_shuffle(const uint32_t* lanes, int rows, int k,
                           uint8_t* planes) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)rows * k) return;
  const int c = (int)(idx / rows);
  const int i = (int)(idx % rows);
  const uint32_t v = lanes[(long)i * k + c];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    planes[(long)(4 * c + b) * rows + i] = (uint8_t)(v >> (8 * b));
}

// bad = 1 when some row is u32-lexicographically below its predecessor
__global__ void lz_order(const uint32_t* lanes, int rows, int k, int* bad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i + 1 >= rows) return;
  const uint32_t* a = lanes + (long)i * k;
  const uint32_t* b = a + k;
  for (int c = 0; c < k; ++c) {
    if (a[c] != b[c]) {
      if (b[c] < a[c]) atomicExch(bad, 1);
      return;
    }
  }
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

// int32 work space of one match scan over n bytes, in bytes.
extern "C" long ctpu_lzscan_scratch_bytes(long n) {
  return 2L * LZ_NDIST * lz_tiles(n) * (long)sizeof(int);
}

// One full segment: planes (u8[4 * k * rows]) from lanes (u32[rows, k]),
// *bad (zeroed by the caller) set on an order violation, and the match
// scans of meta (u8[n_meta]) and of the planes. scratch holds
// ctpu_lzscan_scratch_bytes(max(n_meta, 4 * k * rows)) bytes; the two
// scans run one after the other on the stream and share it.
extern "C" int ctpu_segment_scan(const uint8_t* meta, int n_meta,
                                 const uint32_t* lanes, int rows, int k,
                                 uint8_t* planes, int* mbl, int* mbd,
                                 int* lbl, int* lbd, int* bad,
                                 void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long cells = (long)rows * k;
  if (cells > 0) {
    lz_shuffle<<<grid_for(cells, 256), 256, 0, s>>>(lanes, rows, k, planes);
    if (rows > 1)
      lz_order<<<grid_for(rows - 1, 256), 256, 0, s>>>(lanes, rows, k, bad);
  }
  match_scan(meta, n_meta, mbl, mbd, (int*)scratch, s);
  match_scan(planes, (int)(4 * cells), lbl, lbd, (int*)scratch, s);
  return (int)cudaGetLastError();
}
