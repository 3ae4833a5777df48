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
// are the planes and two int32 arrays per scanned byte: at 65,536
// cells about 49 MB, 15 us at 3.35 TB/s. The scan does at least four
// integer operations per (position, distance): 73 x 5.05 M x 4 =
// 1.5 G, about 22 us at the 67 T/s non-tensor rate.
//
// Design: one launch a segment (after one memset of the tiles' flags).
// Blocks take work items by atomic ticket: first the shuffle (and
// order check) of SH_ROWS lane rows each, then the META tiles, then the
// plane tiles, each input's tiles from its end. A plane tile waits
// until every shuffle item has published its bytes.
// For distance d the run at i is nxt(i) - i, where nxt(i) is the first
// j >= i with j < d or src[j] != src[j-d] (n if none). A tile of
// LZ_TILE bytes is staged in shared memory with the LZ_BACK bytes
// before it; each warp owns LZ_ROWS rows of 128 bytes, a lane one
// 4-byte word of a row. A word is compared with the word d bytes back
// in one xor (a funnel shift of two staged words for d <= 64, an
// aligned L2 read for the nine long distances), and the xor's zero
// bytes give the word's mismatch mask. Runs cross tiles (constant byte
// planes give runs of hundreds of thousands of bytes), so each warp
// first finds its first mismatch per distance, the block takes their
// minimum, and a reverse decoupled look-back over the later tiles (a
// flag word per tile; each warp reads one later tile, its lanes every
// distance, so one round trip serves all 73) gives the first mismatch
// after the tile. Then each warp walks its rows from the last, carrying
// the first mismatch after the row; a ballot finds, for each lane, the
// next lane of the row with a mismatch, and a row with no match at all
// costs one vote. A thread keeps one key a position, run * 128 +
// (127 - distance index), whose maximum over the distances is the
// longest run with the smallest d on ties. The tiles away from the
// input's ends (EDGE false) skip the checks for bytes below d or past
// n. What bounds it on the card: the issue of about 45 instructions a
// word and distance in the walk (compare, mask, ballot, two shuffles,
// the four keys), not memory.
#include "common.cuh"

namespace ctpu {
namespace {

// The candidate distances, ascending: 1..64, then 128, 256, ..., 32768.
// Must stay identical to DISTANCES in ops/device_compress.py (and to
// LZ4_DIST in ops/native/codec.cpp).
constexpr int LZ_NDIST = 73;
constexpr int LZ_SHORT = 64;      // distances compared from shared memory

__host__ __device__ __forceinline__ int lz_dist(int k) {
  return k < LZ_SHORT ? k + 1 : 128 << (k - LZ_SHORT);
}

constexpr int LZ_THREADS = 256;
constexpr int LZ_WARPS = LZ_THREADS / 32;
constexpr int LZ_ROWS = 4;                        // rows a warp walks
constexpr int LZ_ROW = 128;                       // bytes a row: 32 words
constexpr int LZ_WARP_BYTES = LZ_ROWS * LZ_ROW;
constexpr int LZ_TILE = LZ_WARPS * LZ_WARP_BYTES;  // 4,096 bytes
constexpr int LZ_BACK = 64;                       // staged before a tile
constexpr int LZ_FAR = 32768;                     // the longest distance
constexpr int LZ_STAGE_WORDS = (LZ_BACK + LZ_TILE) / 4 + 2;
constexpr int SH_ROWS = 256;                      // lane rows a shuffle item
// a key is run * 128 + 127 - k in 32 bits: runs below 2^25
constexpr long LZ_MAX_N = 1L << 25;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t ALL_MISMATCH = 0x80808080u;
constexpr unsigned ST_AGG = 1, ST_INC = 2;

inline int lz_tiles(long n) { return (int)((n + LZ_TILE - 1) / LZ_TILE); }

// Distances below n (the JAX package stops at the first d >= n).
inline int lz_ndist(long n) {
  int k = 0;
  while (k < LZ_NDIST && lz_dist(k) < n) ++k;
  return k;
}

// One scanned input: its tiles' flags and values ([tiles][LZ_NDIST]
// first mismatches: the tile's own, and from its start to the end).
struct LzInput {
  const uint8_t* src;
  int* best_len;
  int* best_d;
  unsigned* flag;
  int* agg;
  int* inc;
  int n;
  int nd;
  int tiles;
};

struct LzArgs {
  LzInput in[2];              // the META block, the planes
  const uint32_t* lanes;
  uint8_t* planes;
  int* ticket;                // zeroed
  int* done;                  // shuffle items finished; zeroed
  int* bad_acc;               // zeroed
  bool* ok;
  int rows;
  int k;
  int n_shuffle;
};

// The shuffle of lane rows [r0, r0 + SH_ROWS) to byte planes, and the
// order check of each of those rows against the next. The last item to
// finish writes whether the rows are in order.
__device__ void lz_shuffle_item(const LzArgs& a, int item) {
  const int tid = threadIdx.x;
  const int r0 = item * SH_ROWS;
  const int cnt = min(SH_ROWS, a.rows - r0);
  const int k = a.k;
  for (int idx = tid; idx < k * cnt; idx += LZ_THREADS) {
    const int c = idx / cnt;
    const int i = r0 + idx % cnt;
    const uint32_t v = a.lanes[(long)i * k + c];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      a.planes[(long)(4 * c + b) * a.rows + i] = (uint8_t)(v >> (8 * b));
  }
  bool bad = false;
  for (int i = r0 + tid; i < r0 + cnt && i + 1 < a.rows; i += LZ_THREADS) {
    const uint32_t* x = a.lanes + (long)i * k;
    const uint32_t* y = x + k;
    for (int c = 0; c < k; ++c) {
      if (x[c] != y[c]) {
        bad |= y[c] < x[c];
        break;
      }
    }
  }
  if (__syncthreads_or(bad) && tid == 0) atomicOr(a.bad_acc, 1);
  __threadfence();
  __syncthreads();
  if (tid == 0 && atomicAdd(a.done, 1) == a.n_shuffle - 1) {
    __threadfence();
    *a.ok = atomicOr(a.bad_acc, 0) == 0;
  }
}

// The word of src at byte pos (a multiple of 4), 0 outside [0, n).
__device__ __forceinline__ uint32_t lz_word(const uint8_t* src, long pos,
                                            int n) {
  if (pos < 0 || pos >= n) return 0u;
  if (pos + 4 <= n) return __ldcg((const unsigned*)(src + pos));
  uint32_t v = 0;
  for (int b = 0; pos + b < n; ++b)
    v |= (uint32_t)__ldcg(src + pos + b) << (8 * b);
  return v;
}

// The mismatch mask (0x80 in each mismatching byte) of the word at
// absolute position P (tile offset p) for distance d: a byte mismatches
// when it differs from the byte d back, lies below d or at n or past.
// Only an EDGE tile (one of the first 32 KiB, or the last) has bytes
// of the last two kinds.
// For a short distance, sb points at the staged word holding the first
// byte d back from this lane's word of row 0 and sh is that byte's bit
// offset in it.
template <bool LONG, bool EDGE>
__device__ __forceinline__ uint32_t lz_mismatch(const uint32_t* sb, int sh,
                                                const uint8_t* src, int P,
                                                int r, int d, int n,
                                                uint32_t cur) {
  if (EDGE && P >= n) return ALL_MISMATCH;
  uint32_t back, mm = 0;
  if (LONG) {
    if (EDGE && P < d) return ALL_MISMATCH;
    back = __ldcg((const unsigned*)(src + P - d));
  } else {
    back = __funnelshift_r(sb[r * 32], sb[r * 32 + 1], sh);
    if (EDGE && P < d) {
      const int m = d - P;
      mm = m >= 4 ? ALL_MISMATCH : ALL_MISMATCH & ((1u << (8 * m)) - 1u);
    }
  }
  const uint32_t x = cur ^ back;
  // 0x80 in each zero byte of x (no carry crosses a byte)
  const uint32_t z = ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
  mm |= z ^ ALL_MISMATCH;
  if (EDGE && P + 4 > n) mm |= ALL_MISMATCH << (8 * (n - P));
  return mm;
}

// The staged word and bit offset of the byte d back from this lane's
// word of row 0 (wb: the warp's first byte in the tile).
__device__ __forceinline__ const uint32_t* lz_back(const uint32_t* S,
                                                   int wb, int lane, int d,
                                                   int& sh) {
  sh = ((4 - (d & 3)) & 3) * 8;
  return S + (wb >> 2) + lane + (LZ_BACK >> 2) - ((d + 3) >> 2);
}

// The first mismatch of the warp's rows for distance d (n if none).
template <bool LONG, bool EDGE>
__device__ __forceinline__ int lz_first(const uint32_t* S,
                                        const LzInput& I, int tb, int wb,
                                        int lane, int d,
                                        const uint32_t* cur) {
  int sh;
  const uint32_t* sb = lz_back(S, wb, lane, d, sh);
#pragma unroll
  for (int r = 0; r < LZ_ROWS; ++r) {
    const int p = wb + r * LZ_ROW + lane * 4;
    const uint32_t mm =
        lz_mismatch<LONG, EDGE>(sb, sh, I.src, tb + p, r, d, I.n, cur[r]);
    const unsigned B = __ballot_sync(FULL, mm != 0);
    if (B) {
      const int at = tb + p + (__ffs(mm) >> 3) - 1;
      return min(I.n, __shfl_sync(FULL, at, __ffs(B) - 1));
    }
  }
  return I.n;
}

// The runs of the warp's rows for distance index dk, from the last row,
// with c the first mismatch after the warp's rows.
template <bool LONG, bool EDGE>
__device__ __forceinline__ void lz_runs(const uint32_t* S,
                                        const LzInput& I, int tb, int wb,
                                        int lane, int dk, int c,
                                        const uint32_t* cur,
                                        uint32_t (*best)[4]) {
  const int d = lz_dist(dk);
  const uint32_t tag = 127u - dk;
  const unsigned later = ~((2u << lane) - 1u);
  int sh;
  const uint32_t* sb = lz_back(S, wb, lane, d, sh);
#pragma unroll
  for (int r = LZ_ROWS - 1; r >= 0; --r) {
    const int P = tb + wb + r * LZ_ROW + lane * 4;
    const uint32_t mm =
        lz_mismatch<LONG, EDGE>(sb, sh, I.src, P, r, d, I.n, cur[r]);
    if (__all_sync(FULL, mm == ALL_MISMATCH)) {   // no run: the row's
      c = min(I.n, P - lane * 4);                  // first byte is next
      continue;
    }
    const unsigned B = __ballot_sync(FULL, mm != 0);
    const int at = P + (__ffs(mm) >> 3) - 1;
    const unsigned hi = B & later;
    const int v = __shfl_sync(FULL, at, __ffs(hi) - 1);   // used if hi
    const int A = hi ? (EDGE ? min(v, I.n) : v) : c;  // next mismatch
    if (mm == 0) {                           // the word matches: A's runs
      const uint32_t q = (uint32_t)(A - P) * 128u + tag;
#pragma unroll
      for (int j = 0; j < 4; ++j) best[r][j] = max(best[r][j], q - 128u * j);
    } else if (mm != ALL_MISMATCH) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t mj = mm >> (8 * j);
        const int run = mj ? (__ffs(mj) >> 3) - 1 : A - P - j;
        best[r][j] = max(best[r][j], (uint32_t)run * 128u + tag);
      }
    }
    if (B) {
      const int f = __shfl_sync(FULL, at, __ffs(B) - 1);
      c = EDGE ? min(I.n, f) : f;
    }
  }
}

// Each warp's first mismatch per distance (into fmw), then each
// warp's runs, with the first mismatch after its rows in fmw.
template <bool EDGE>
__device__ __forceinline__ void lz_first_all(const uint32_t* S,
                                             const LzInput& I, int tb,
                                             int (*fmw)[LZ_NDIST],
                                             const uint32_t* cur) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wb = w * LZ_WARP_BYTES;
  for (int dk = 0; dk < I.nd; ++dk) {
    const int d = lz_dist(dk);
    const int fm =
        dk < LZ_SHORT ? lz_first<false, EDGE>(S, I, tb, wb, lane, d, cur)
                      : lz_first<true, EDGE>(S, I, tb, wb, lane, d, cur);
    if (lane == 0) fmw[w][dk] = fm;
  }
}

template <bool EDGE>
__device__ __forceinline__ void lz_runs_all(const uint32_t* S,
                                            const LzInput& I, int tb,
                                            int (*fmw)[LZ_NDIST],
                                            const uint32_t* cur,
                                            uint32_t (*best)[4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int wb = w * LZ_WARP_BYTES;
  const int nshort = min(I.nd, LZ_SHORT);
  for (int dk = 0; dk < nshort; ++dk)
    lz_runs<false, EDGE>(S, I, tb, wb, lane, dk, fmw[w][dk], cur, best);
  for (int dk = LZ_SHORT; dk < I.nd; ++dk)
    lz_runs<true, EDGE>(S, I, tb, wb, lane, dk, fmw[w][dk], cur, best);
}

__device__ void lz_tile(const LzInput& I, int t, uint32_t* S,
                        int (*fmw)[LZ_NDIST], int (*lb_val)[LZ_NDIST]) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tb = t * LZ_TILE;
  const int n = I.n, nd = I.nd;
  const bool edge = tb < LZ_FAR || tb + LZ_TILE > n;
  for (int i = tid; i < LZ_STAGE_WORDS; i += LZ_THREADS)
    S[i] = lz_word(I.src, (long)tb - LZ_BACK + 4L * i, n);
  __syncthreads();
  const int wb = w * LZ_WARP_BYTES;
  uint32_t cur[LZ_ROWS];
#pragma unroll
  for (int r = 0; r < LZ_ROWS; ++r)
    cur[r] = S[(LZ_BACK + wb + r * LZ_ROW + lane * 4) >> 2];

  if (edge)
    lz_first_all<true>(S, I, tb, fmw, cur);
  else
    lz_first_all<false>(S, I, tb, fmw, cur);
  __syncthreads();
  // the tile's first mismatches, published
  const bool last = t == I.tiles - 1;
  if (tid < nd) {
    int mine = n;
#pragma unroll
    for (int k = 0; k < LZ_WARPS; ++k) mine = min(mine, fmw[k][tid]);
    I.agg[(long)t * LZ_NDIST + tid] = mine;
    if (last) I.inc[(long)t * LZ_NDIST + tid] = mine;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) *(volatile unsigned*)(I.flag + t) = last ? ST_INC : ST_AGG;
  // the first mismatch after the tile, per distance: warp w reads
  // tile j0 + w, its lanes every distance (one round trip for all of
  // them), 8 later tiles at a time until each distance has met an
  // inclusive tile or one with a mismatch
  int car = n;                               // thread tid: distance tid
  bool open = tid < nd;
  for (int j0 = t + 1; !last; j0 += LZ_WARPS) {
    const int j = j0 + w;
    unsigned f = ST_INC;                     // past the end: nothing
    if (j < I.tiles && lane == 0) {
      do {
        f = *(volatile unsigned*)(I.flag + j);
      } while (f == 0);
    }
    f = __shfl_sync(FULL, f, 0);
    __threadfence();
    const volatile int* vals = (const volatile int*)(
        (f == ST_INC ? I.inc : I.agg) + (long)j * LZ_NDIST);
    for (int dk = lane; dk < nd; dk += 32) {
      const int v = j < I.tiles ? vals[dk] : n;
      lb_val[w][dk] = f == ST_INC || v < n ? -1 - v : v;  // < 0: the end
    }
    __syncthreads();
    if (open) {
      for (int k = 0; k < LZ_WARPS && open; ++k) {
        const int v = lb_val[k][tid];
        car = min(car, v < 0 ? -1 - v : v);
        open = v >= 0;
      }
    }
    if (!__syncthreads_or(open)) break;
  }
  if (tid < nd) {
    int mine = n;
#pragma unroll
    for (int k = 0; k < LZ_WARPS; ++k) mine = min(mine, fmw[k][tid]);
    if (!last) {
      I.inc[(long)t * LZ_NDIST + tid] = min(mine, car);
      __threadfence();
    }
    // each warp's carry: the first mismatch after its rows
    for (int k = LZ_WARPS - 1; k >= 0; --k) {
      const int f = fmw[k][tid];
      fmw[k][tid] = car;
      car = min(car, f);
    }
  }
  __syncthreads();
  if (tid == 0 && !last) *(volatile unsigned*)(I.flag + t) = ST_INC;

  uint32_t best[LZ_ROWS][4];
#pragma unroll
  for (int r = 0; r < LZ_ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) best[r][j] = 0;
  if (edge)
    lz_runs_all<true>(S, I, tb, fmw, cur, best);
  else
    lz_runs_all<false>(S, I, tb, fmw, cur, best);

  const bool vec = (((uintptr_t)I.best_len | (uintptr_t)I.best_d) & 15) == 0;
#pragma unroll
  for (int r = 0; r < LZ_ROWS; ++r) {
    const int P = tb + wb + r * LZ_ROW + lane * 4;
    if (P >= n) break;
    int len[4], dd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      len[j] = (int)(best[r][j] >> 7);
      dd[j] = len[j] > 0 ? lz_dist(127 - (int)(best[r][j] & 127u)) : 0;
    }
    if (vec && P + 4 <= n) {
      *(int4*)(I.best_len + P) = make_int4(len[0], len[1], len[2], len[3]);
      *(int4*)(I.best_d + P) = make_int4(dd[0], dd[1], dd[2], dd[3]);
    } else {
      for (int j = 0; j < 4 && P + j < n; ++j) {
        I.best_len[P + j] = len[j];
        I.best_d[P + j] = dd[j];
      }
    }
  }
}

// two blocks an SM at least: at most 128 registers a thread (64 used)
__global__ void __launch_bounds__(LZ_THREADS, 2)
lz_segment(const __grid_constant__ LzArgs a) {
  __shared__ uint32_t S[LZ_STAGE_WORDS];
  __shared__ int fmw[LZ_WARPS][LZ_NDIST];
  __shared__ int lb_val[LZ_WARPS][LZ_NDIST];
  __shared__ int s_item;
  if (threadIdx.x == 0) s_item = atomicAdd(a.ticket, 1);
  __syncthreads();
  int u = s_item;
  if (u < a.n_shuffle) {
    lz_shuffle_item(a, u);
    return;
  }
  if (u == 0 && threadIdx.x == 0) *a.ok = true;   // no lane rows
  u -= a.n_shuffle;
  const int which = u < a.in[0].tiles ? 0 : 1;
  if (which == 1) {
    u -= a.in[0].tiles;
    // the planes are this launch's shuffle output
    if (threadIdx.x == 0) {
      while (*(volatile int*)a.done < a.n_shuffle) {
      }
      __threadfence();
    }
    __syncthreads();
  }
  const LzInput& I = a.in[which];
  lz_tile(I, I.tiles - 1 - u, S, fmw, lb_val);
}

// the zeroed head of the scratch: ticket, done, bad_acc, then a flag
// per tile of either input
long lz_head_bytes(int tiles) {
  return ((4L + tiles) * (long)sizeof(int) + 15) / 16 * 16;
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

// Work space of one segment scan (META of n_meta bytes, planes of
// n_planes), in bytes.
extern "C" long ctpu_lzscan_scratch_bytes(long n_meta, long n_planes) {
  const int tiles = lz_tiles(n_meta) + lz_tiles(n_planes);
  return lz_head_bytes(tiles) + 2L * tiles * LZ_NDIST * (long)sizeof(int);
}

// One full segment: planes (u8[4 * k * rows]) from lanes (u32[rows, k]),
// *ok whether the rows are in u32-lexicographic order, and the scans of
// meta (u8[n_meta]) and of the planes into (best_len, best_d) int32
// arrays. meta must be 4-byte aligned; both inputs below 2^25 bytes.
// scratch holds ctpu_lzscan_scratch_bytes(n_meta, 4 * k * rows) bytes.
// One memset and one kernel, on the stream, without waiting.
extern "C" int ctpu_segment_scan(const uint8_t* meta, int n_meta,
                                 const uint32_t* lanes, int rows, int k,
                                 uint8_t* planes, int* mbl, int* mbd,
                                 int* lbl, int* lbd, bool* ok,
                                 void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long n_planes = 4L * rows * k;
  if (n_meta < 0 || n_meta >= LZ_MAX_N || n_planes >= LZ_MAX_N ||
      ((uintptr_t)meta & 3) != 0)
    return (int)cudaErrorInvalidValue;
  LzArgs a;
  const int tm = lz_tiles(n_meta), tp = lz_tiles(n_planes);
  const int tiles = tm + tp;
  int* head = (int*)scratch;
  int* vals = (int*)((char*)scratch + lz_head_bytes(tiles));
  a.in[0] = LzInput{meta, mbl, mbd, (unsigned*)head + 4, vals,
                    vals + (long)tiles * LZ_NDIST, n_meta,
                    lz_ndist(n_meta), tm};
  a.in[1] = LzInput{planes, lbl, lbd, (unsigned*)head + 4 + tm,
                    vals + (long)tm * LZ_NDIST,
                    vals + (long)(tiles + tm) * LZ_NDIST, (int)n_planes,
                    lz_ndist(n_planes), tp};
  a.lanes = lanes;
  a.planes = planes;
  a.ticket = head;
  a.done = head + 1;
  a.bad_acc = head + 2;
  a.ok = ok;
  a.rows = rows;
  a.k = k;
  a.n_shuffle = n_planes > 0 ? (rows + SH_ROWS - 1) / SH_ROWS : 0;
  const int items = a.n_shuffle + tiles;
  if (items == 0) {
    cudaMemsetAsync(ok, 1, sizeof(bool), s);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(scratch, 0, lz_head_bytes(tiles), s);
  lz_segment<<<items, LZ_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
