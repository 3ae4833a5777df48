// K1: the stable lexicographic sort permutation of a merge round, and
// the sort of the mesh step K8 (mesh.cu), which is the same code over S
// segments (shards) of N rows each.
//
// Replaces cassandra_tpu/ops/merge.py `_lsd_pass` as chained by
// `_traced_sort_perm` (`device_sort_perm`): the sort over (valid,
// lanes[0..K-1], ~ts_h, ~ts_l), most significant first, 4 (K + 3) key
// bytes a row. The JAX package runs K+3 stable (key, perm) sorts, least
// significant key first. A stable lexicographic sort has exactly one
// result, and dropping a byte that is constant among the rows it orders
// leaves that result unchanged, so the permutation is the JAX package's.
//
// Bound on this card: bytes. Read once, the keys are (K + 3) * 4 B and
// the permutation 4 B per row: at N = 2^24 and K = 13, 1.07 GB, 0.34 ms
// at 3.35 TB/s. Two things held the first design far above it:
// every key byte was a pass (64 at K = 13), and each pass took three
// launches and read its byte through the permutation twice (a random
// 4-byte read from a 52-byte lane row in the histogram and again in the
// scatter). This design, per call over S segments:
//
//   1. plan: one read of every row's key builds a 256-bin histogram
//      of each key byte per (segment, group), group = live (valid == 0)
//      or pad (valid != 0), in shared memory, added into global memory
//      with atomics. A byte varies in a group when more than one bin is
//      filled. One small device-to-host copy and a stream sync bring
//      back the varying bytes and the group sizes: the call's only host
//      sync. The histograms, scanned in place, stay on the device as
//      every pass's digit bases; no pass builds a histogram.
//   2. split: each segment's rows are stably partitioned into live, then
//      pad (an exclusive add-scan of the live flags). `valid` is the
//      most significant key, so every pad row sorts after every live
//      row, and each (segment, group) becomes a range with its own
//      varying bytes. Padding rows are identical in practice: their
//      range runs no pass. Among pad rows `valid`'s bytes count like any
//      other, so pad rows whose `valid` differs still sort right.
//   3. pack: each row's varying bytes, most significant first, go into
//      ceil(D / 4) word-major u32 arrays (D = the bytes that vary in
//      the row's range). Concatenated in order of significance, they
//      order exactly as the whole key.
//   4. passes: one LSD pass per packed byte, least significant first,
//      each ONE kernel over contiguous (key word, position) pairs. A
//      tile of 4,096 ranks its digits in shared memory (each warp ranks
//      its own 512 rows with __match_any_sync and its own digit counts,
//      then one scan over the warps), takes its offset per digit from
//      the tiles before it in its range by decoupled look-back (tiles
//      take their index from an atomic ticket, so a tile only waits on
//      tiles that started before it; flag and prefix are one 64-bit
//      word, tagged with the pass), and stages its rows in shared memory
//      so that one digit's rows go out to consecutive addresses. When
//      the passes move on to the next more significant word, the pass
//      gathers that word through the permutation once; the last pass of
//      a range writes the rows' indices to the output.
//
// A range with fewer varying bytes than another simply stops earlier:
// pass p runs the ranges with D > p, each at its own byte D - 1 - p.
//
// The first design's passes (`radix_sort_perm`, three launches a key
// byte) stay for the plane programs K6 and K7 (planes.cu), whose keys
// are 1, 2 or 4 bytes wide, and for K10's winner order (ann.cu).
#include <chrono>
#include <cstring>
#include <vector>

#include "common.cuh"

namespace ctpu {
namespace {

constexpr int SORT_THREADS = 256;
constexpr int SORT_ROUNDS = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ROUNDS;
constexpr int RADIX = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;

// ------------------------------------------ radix_sort_perm (K6, K7, K10)

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

// Tile t holds rows [t * SORT_TILE, min((t + 1) * SORT_TILE, n)); its
// histogram and offsets sit at hist[digit * tiles + t], so one exclusive
// scan of the table gives every (digit, tile) its first output slot.
__global__ void __launch_bounds__(SORT_THREADS)
digit_hist(SortKey key, int shift, const int* perm, int n, int* hist) {
  __shared__ int h[RADIX];
  const int tid = threadIdx.x;
  h[tid] = 0;
  __syncthreads();
  const int base = blockIdx.x * SORT_TILE;
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int i = base + r * SORT_THREADS + tid;
    if (i < n) atomicAdd(&h[digit_of(key, shift, perm[i])], 1);
  }
  __syncthreads();
  hist[(long)tid * gridDim.x + blockIdx.x] = h[tid];
}

// A stable scatter: the tile is walked in rounds of 256 elements in
// input order, `__match_any_sync` finds the lanes of a warp that share a
// digit, per-warp digit counts in shared memory order the warps, and a
// running per-digit count carries the order from one round to the next.
__global__ void __launch_bounds__(SORT_THREADS)
digit_scatter(SortKey key, int shift, const int* perm_in, int* perm_out,
              int n, const int* offs) {
  __shared__ int run[RADIX];
  __shared__ int wcnt[SORT_WARPS][RADIX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int base = blockIdx.x * SORT_TILE;
  run[tid] = offs[(long)tid * gridDim.x + blockIdx.x];
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    for (int j = tid; j < SORT_WARPS * RADIX; j += SORT_THREADS)
      (&wcnt[0][0])[j] = 0;
    __syncthreads();
    const int i = base + r * SORT_THREADS + tid;
    const bool valid = i < n;
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

// ------------------------------------------------- the round sort (K1, K8)

constexpr int PLAN_THREADS = 256;
constexpr int PLAN_WORDS = 4;         // key words per plan block
constexpr int PLAN_MIN_ROWS = 4096;   // rows per plan block, at least
constexpr int PLAN_BLOCKS = 2048;     // plan blocks per call, about
constexpr int PASS_THREADS = 256;
constexpr int PASS_ITEMS = 16;
constexpr int PASS_TILE = PASS_THREADS * PASS_ITEMS;
constexpr int PASS_WARPS = PASS_THREADS / 32;

// Key word w of row i, most significant first: valid, the K lanes,
// then the descending stamps flipped.
__device__ __forceinline__ uint32_t key_word(const RoundKeys& k, long i,
                                             int w) {
  if (w == 0) return k.valid[i];
  if (w <= k.K) return k.lanes[i * k.K + (w - 1)];
  return w == k.K + 1 ? ~k.ts_h[i] : ~k.ts_l[i];
}

// Byte b of the key (0 = most significant) sits in word b / 4.
__device__ __forceinline__ int byte_shift(int b) { return 24 - 8 * (b & 3); }

// Plan block (chunk, tile, segment): rows [tile * rows, ...) of the
// segment, key words [chunk * PLAN_WORDS, ...). A warp whose lanes all
// hold one (group, word), or one (group, byte), adds once; the others
// add per lane.
// hist[((segment * 2 + group) * B + byte) * RADIX + bin] counts rows;
// chunk 0 also writes live[i] = (valid == 0).
__global__ void __launch_bounds__(PLAN_THREADS)
plan_hist(RoundKeys key, int N, int rows, int* hist, int* live) {
  __shared__ int h[2][PLAN_WORDS * 4][RADIX];
  const int tid = threadIdx.x, lane = tid & 31;
  const int W = key.K + 3, B = 4 * W;
  const int w0 = blockIdx.x * PLAN_WORDS;
  const int nw = min(PLAN_WORDS, W - w0);
  const int s = blockIdx.z;
  for (int j = tid; j < 2 * PLAN_WORDS * 4 * RADIX; j += PLAN_THREADS)
    (&h[0][0][0])[j] = 0;
  __syncthreads();
  const long seg0 = (long)s * N;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(r0 + rows, N);
  for (int rb = r0; rb < r1; rb += PLAN_THREADS) {
    const int r = rb + tid;
    const bool act = r < r1;
    const unsigned amask = __ballot_sync(0xffffffffu, act);
    if (amask == 0) continue;
    const long i = seg0 + r;
    const uint32_t v = act ? key.valid[i] : 0u;
    const int g = v != 0;
    if (act && blockIdx.x == 0) live[i] = !g;
    const int lead = __ffs(amask) - 1;
    const int g0 = __shfl_sync(0xffffffffu, g, lead);
    // the row's words first, so that their loads are in flight together
    uint32_t x[PLAN_WORDS];
#pragma unroll
    for (int w = 0; w < PLAN_WORDS; ++w)
      x[w] = act && w < nw ? key_word(key, i, w0 + w) : 0u;
#pragma unroll
    for (int w = 0; w < PLAN_WORDS; ++w) {
      if (w >= nw) break;
      const uint32_t x0 = __shfl_sync(0xffffffffu, x[w], lead);
      if (__all_sync(0xffffffffu, !act || (x[w] == x0 && g == g0))) {
        // one (group, word) in every lane: each byte adds once
        if (lane == lead)
          for (int j = 0; j < 4; ++j)
            atomicAdd(&h[g0][4 * w + j][(x0 >> byte_shift(j)) & 255],
                      __popc(amask));
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bin = (g << 8) | ((x[w] >> byte_shift(j)) & 255);
        const int b0 = __shfl_sync(0xffffffffu, bin, lead);
        if (__all_sync(0xffffffffu, !act || bin == b0)) {
          if (lane == lead)
            atomicAdd(&h[b0 >> 8][4 * w + j][b0 & 255], __popc(amask));
        } else if (act) {
          atomicAdd(&h[g][4 * w + j][bin & 255], 1);
        }
      }
    }
  }
  __syncthreads();
  const int per_g = nw * 4 * RADIX;
  for (int e = tid; e < 2 * per_g; e += PLAN_THREADS) {
    const int g = e / per_g, jb = (e % per_g) / RADIX, d = e % RADIX;
    const int c = h[g][jb][d];
    if (c)
      atomicAdd(&hist[(((long)s * 2 + g) * B + 4 * w0 + jb) * RADIX + d], c);
  }
}

// Exclusive scan of one value per thread over a block of RADIX threads.
__device__ __forceinline__ int block_excl_scan(int c, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  int before = 0;
  for (int j = 0; j < w; ++j) before += wsum[j];
  return before + x - c;
}

// One block per (range, byte): the range's counts of that byte become
// its digits' first positions inside the range (in place), vary[] says
// whether more than one bin is filled, and byte 0 gives the range's
// rows (sizes[range]).
__global__ void __launch_bounds__(RADIX)
plan_bases(int* hist, int B, uint8_t* vary, int* sizes) {
  __shared__ int wsum[RADIX / 32];
  const long row = blockIdx.x;
  const int d = threadIdx.x;
  const int c = hist[row * RADIX + d];
  const int filled = __syncthreads_count(c != 0);
  const int excl = block_excl_scan(c, wsum);
  hist[row * RADIX + d] = excl;
  if (d == 0) vary[row] = filled > 1;
  if (d == RADIX - 1 && row % B == 0) sizes[row / B] = excl + c;
}

// Split and pack, one thread per row i of segment s: its position in
// the segment's (live, then pad) order, idx[pos] = i (and out[pos] = i,
// the answer for a range that runs no pass), and its range's varying
// bytes packed into pk[word * n + pos].
__global__ void split_pack(RoundKeys key, int N, long n, const int* ex,
                           const int* sizes, const int* dr,
                           const int* blist, int B, uint32_t* pk,
                           int* idx, int* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = (int)(i / N);
  const long seg0 = (long)s * N;
  const bool live = key.valid[i] == 0;
  const int lb = ex[i] - ex[seg0];
  const long pos = seg0 + (live ? lb : sizes[2 * s] + (i - seg0 - lb));
  idx[pos] = (int)i;
  out[pos] = (int)i;
  const int r = 2 * s + !live;
  const int D = dr[r];
  const int* bl = blist + (long)r * B;
  int cur = -1;
  uint32_t x = 0, word = 0;
  for (int q = 0; q < D; ++q) {
    const int b = bl[q];
    if ((b >> 2) != cur) {
      cur = b >> 2;
      x = key_word(key, i, cur);
    }
    word |= ((x >> byte_shift(b)) & 255u) << byte_shift(q);
    if ((q & 3) == 3 || q == D - 1) {
      pk[(long)(q >> 2) * n + pos] = word;
      word = 0;
    }
  }
}

// One range of one pass: positions [start, start + len), its first tile
// in the pass's numbering, the row of its digits' bases (range * B +
// byte), the digit's shift, the packed word pass 0 reads its keys from
// (else -1: the keys come from the last pass), the packed word gathered
// into the output keys when the next pass starts a new word (else -1),
// and whether this is the range's last pass.
struct PassRange {
  int start, len, tile0, base_row, shift, in_word, next_word, last;
};

__device__ __forceinline__ void put_status(unsigned long long* p,
                                           unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

__device__ __forceinline__ unsigned long long get_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__global__ void __launch_bounds__(PASS_THREADS)
round_pass(const PassRange* ranges, int nr, unsigned tag,
           const uint32_t* pk, long n, const uint32_t* kin, const int* pin,
           uint32_t* kout, int* pout, const int* idx, int* out,
           const int* bases, unsigned long long* status, int* ticket) {
  __shared__ int wcnt[PASS_WARPS][RADIX];
  __shared__ uint32_t skey[PASS_TILE];
  __shared__ int spos[PASS_TILE];
  __shared__ int s_tile;
  __shared__ int lstart[RADIX], gofs[RADIX], wsum[PASS_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  for (int j = tid; j < PASS_WARPS * RADIX; j += PASS_THREADS)
    (&wcnt[0][0])[j] = 0;
  __syncthreads();
  const int t = s_tile;
  int r = 0;
  while (r + 1 < nr && ranges[r + 1].tile0 <= t) ++r;
  const PassRange R = ranges[r];
  const int ti = t - R.tile0;
  const int count = min(PASS_TILE, R.len - ti * PASS_TILE);
  const long base = (long)R.start + (long)ti * PASS_TILE;
  const unsigned lt = (1u << lane) - 1u;

  // warp w holds the tile's elements [w, w + 1) * PASS_ITEMS * 32, in
  // rounds of 32 consecutive ones: loads first, all in flight together
  const int wbase = w * PASS_ITEMS * 32;
  uint32_t k[PASS_ITEMS];
  int p[PASS_ITEMS], rk[PASS_ITEMS];
#pragma unroll
  for (int it = 0; it < PASS_ITEMS; ++it) {
    const int e = wbase + it * 32 + lane;
    const long i = base + e;
    const bool v = e < count;
    k[it] = !v ? 0u : R.in_word >= 0 ? pk[(long)R.in_word * n + i] : kin[i];
    p[it] = !v ? 0 : R.in_word >= 0 ? (int)i : pin[i];
  }
  // rank in the warp: its rows of the digit in earlier rounds (the
  // warp's own counts in shared memory), then the lanes below
  int* mine_cnt = wcnt[w];
#pragma unroll
  for (int it = 0; it < PASS_ITEMS; ++it) {
    const bool v = wbase + it * 32 + lane < count;
    // out-of-range lanes take digit RADIX: they match only each other
    const int d = v ? (int)((k[it] >> R.shift) & 255u) : RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int before = v ? mine_cnt[d] : 0;
    rk[it] = before + __popc(peers & lt);
    __syncwarp();
    if (v && lane == __ffs(peers) - 1) mine_cnt[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread = digit: the tile's rows of it before each warp, and in all
  int run = 0;
#pragma unroll
  for (int j = 0; j < PASS_WARPS; ++j) {
    const int c = wcnt[j][tid];
    wcnt[j][tid] = run;
    run += c;
  }
  const int tot = run;

  // decoupled look-back over the range's earlier tiles: flag in the high
  // word (2 tag - 1 = this tile's count, 2 tag = the inclusive prefix;
  // anything lower is an earlier pass's), the value in the low word
  const unsigned long long AGG = (unsigned long long)(2 * tag - 1) << 32;
  const unsigned long long INC = (unsigned long long)(2 * tag) << 32;
  unsigned long long* mine = status + (long)t * RADIX + tid;
  int before = 0;
  if (ti == 0) {
    put_status(mine, INC | (unsigned)tot);
  } else {
    put_status(mine, AGG | (unsigned)tot);
    for (long j = t - 1;; --j) {
      unsigned long long v;
      do {
        v = get_status(status + j * RADIX + tid);
      } while ((unsigned)(v >> 32) < 2 * tag - 1);
      before += (int)(unsigned)v;
      if ((unsigned)(v >> 32) == 2 * tag) break;
    }
    put_status(mine, INC | (unsigned)(before + tot));
  }
  const int ls = block_excl_scan(tot, wsum);
  lstart[tid] = ls;
  gofs[tid] = R.start + bases[(long)R.base_row * RADIX + tid] + before - ls;
  __syncthreads();
  // stage the tile in digit order, so one digit's rows go out together
#pragma unroll
  for (int it = 0; it < PASS_ITEMS; ++it)
    if (wbase + it * 32 + lane < count) {
      const int d = (int)((k[it] >> R.shift) & 255u);
      const int lp = lstart[d] + wcnt[w][d] + rk[it];
      skey[lp] = k[it];
      spos[lp] = p[it];
    }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < PASS_ITEMS; ++it) {
    const int e = it * PASS_THREADS + tid;
    if (e >= count) break;
    const uint32_t key = skey[e];
    const int pos = spos[e];
    const long dst = gofs[(key >> R.shift) & 255u] + e;
    if (R.last) {
      out[dst] = idx[pos];
    } else {
      pout[dst] = pos;
      kout[dst] = R.next_word >= 0 ? pk[(long)R.next_word * n + pos] : key;
    }
  }
}

// Scratch of the round sort, in this order (each part 256-byte aligned).
struct RoundScratch {
  int* hist;        // [2 S, B, RADIX] counts, then digit bases
  int* sizes;       // [2 S] rows per range  } one device-to-host copy
  uint8_t* vary;    // [2 S, B]              }
  int* table;       // dr[2 S], blist[2 S, B], PassRange[B][2 S]
  int* tickets;     // [B]
  unsigned long long* status;  // [tiles, RADIX]
  int* scan;        // scan_scratch_elems(n)
  int* idx;         // [n]
  uint32_t* kbuf[2];  // [n] each; the live flags and their scan first
  int* pbuf[2];       // [n] each
  uint32_t* pk;     // [K + 3, n]
  long bytes;
};

long align256(long b) { return (b + 255) / 256 * 256; }

long status_tiles(int S, long n) { return n / PASS_TILE + 2L * S + 1; }

RoundScratch carve(void* base, int S, int N, int K) {
  const long n = (long)S * N;
  const int W = K + 3, B = 4 * W;
  RoundScratch r;
  char* p = (char*)base;
  long off = 0;
  auto take = [&](long bytes) {
    char* q = p == nullptr ? nullptr : p + off;
    off += align256(bytes);
    return (void*)q;
  };
  r.hist = (int*)take(2L * S * B * RADIX * 4);
  r.sizes = (int*)take(2L * S * 4 + 2L * S * B);
  r.vary = (uint8_t*)(r.sizes == nullptr ? nullptr : r.sizes + 2 * S);
  r.table = (int*)take((2L * S + 2L * S * B) * 4
                       + (long)B * 2 * S * sizeof(PassRange));
  r.tickets = (int*)take((long)B * 4);
  r.status = (unsigned long long*)take(status_tiles(S, n) * RADIX * 8);
  r.scan = (int*)take(scan_scratch_elems(n) * 4);
  r.idx = (int*)take(n * 4);
  r.kbuf[0] = (uint32_t*)take(n * 4);
  r.kbuf[1] = (uint32_t*)take(n * 4);
  r.pbuf[0] = (int*)take(n * 4);
  r.pbuf[1] = (int*)take(n * 4);
  r.pk = (uint32_t*)take((long)W * n * 4);
  r.bytes = off;
  return r;
}

}  // namespace

long radix_scratch_bytes(int n) {
  const long tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const long hist = (long)RADIX * tiles;
  return (hist + scan_scratch_elems(hist)) * (long)sizeof(int);
}

void radix_sort_perm(const SortKey* keys, int nk, int n, int* perm,
                     int* perm_tmp, void* scratch, cudaStream_t s) {
  const int tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const long hist_n = (long)RADIX * tiles;
  int* hist = (int*)scratch;
  int* scan_scr = hist + hist_n;
  iota<<<grid_for(n, 256), 256, 0, s>>>(perm, n);
  int* a = perm;
  int* b = perm_tmp;
  for (int q = 0; q < nk; ++q) {
    for (int shift = 0; shift < 8 * keys[q].width; shift += 8) {
      digit_hist<<<tiles, SORT_THREADS, 0, s>>>(keys[q], shift, a, n, hist);
      scan_add_exclusive(hist, hist, hist_n, scan_scr, s);
      digit_scatter<<<tiles, SORT_THREADS, 0, s>>>(keys[q], shift, a, b, n,
                                                   hist);
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

long round_sort_scratch_bytes(int S, int N, int K) {
  return carve(nullptr, S, N, K).bytes;
}

cudaError_t round_sort_perm(const RoundKeys& key, int S, int N, int* out,
                            void* scratch, cudaStream_t s,
                            long long* info) {
  info[0] = info[1] = 0;
  const long n = (long)S * N;
  if (n == 0) return cudaSuccess;
  const int W = key.K + 3, B = 4 * W, R = 2 * S;
  RoundScratch sc = carve(scratch, S, N, key.K);
  int* live = (int*)sc.kbuf[0];
  int* ex = (int*)sc.kbuf[1];

  // 1. plan
  cudaMemsetAsync(sc.hist, 0, (size_t)R * B * RADIX * 4, s);
  cudaMemsetAsync(sc.tickets, 0, (size_t)B * 4, s);
  cudaMemsetAsync(sc.status, 0, (size_t)status_tiles(S, n) * RADIX * 8, s);
  const int chunks = (W + PLAN_WORDS - 1) / PLAN_WORDS;
  const int want = PLAN_BLOCKS / (chunks * S);
  int tiles = (N + PLAN_MIN_ROWS - 1) / PLAN_MIN_ROWS;
  if (tiles > want) tiles = want > 1 ? want : 1;
  const int rows = (N + tiles - 1) / tiles;
  plan_hist<<<dim3(chunks, tiles, S), PLAN_THREADS, 0, s>>>(key, N, rows,
                                                           sc.hist, live);
  scan_add_exclusive(live, ex, n, sc.scan, s);
  plan_bases<<<R * B, RADIX, 0, s>>>(sc.hist, B, sc.vary, sc.sizes);
  std::vector<uint8_t> summary((size_t)R * 4 + (size_t)R * B);
  const auto t0 = std::chrono::steady_clock::now();
  cudaError_t err = cudaMemcpyAsync(summary.data(), sc.sizes, summary.size(),
                                    cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  info[1] = std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - t0).count();
  if (err != cudaSuccess) return err;
  const int* sizes = (const int*)summary.data();
  const uint8_t* vary = summary.data() + (size_t)R * 4;

  // the ranges' varying bytes and, per pass, the ranges it runs
  std::vector<int> table((size_t)R + (size_t)R * B, 0);
  int passes = 0;
  for (int r = 0; r < R; ++r) {
    int D = 0;
    for (int b = 0; b < B; ++b)
      if (vary[(size_t)r * B + b]) table[R + (size_t)r * B + D++] = b;
    table[r] = D;
    if (D > passes) passes = D;
  }
  std::vector<int> first(passes + 1, 0);  // each pass's first entry
  std::vector<int> tiles_of(passes, 0);
  std::vector<PassRange> pr;
  for (int p = 0; p < passes; ++p) {
    first[p] = (int)pr.size();
    for (int r = 0; r < R; ++r) {
      const int D = table[r];
      if (D <= p) continue;
      const int q = D - 1 - p;  // this pass's packed byte
      PassRange e;
      e.start = (r / 2) * N + (r % 2 ? sizes[r - 1] : 0);
      e.len = sizes[r];
      e.tile0 = tiles_of[p];
      e.base_row = r * B + table[R + (size_t)r * B + q];
      e.shift = 24 - 8 * (q & 3);
      e.in_word = p == 0 ? q >> 2 : -1;
      e.next_word = (q & 3) == 0 && q > 0 ? (q >> 2) - 1 : -1;
      e.last = q == 0;
      pr.push_back(e);
      tiles_of[p] += (e.len + PASS_TILE - 1) / PASS_TILE;
    }
  }
  first[passes] = (int)pr.size();
  const size_t head = table.size() * sizeof(int);
  std::vector<uint8_t> blob(head + pr.size() * sizeof(PassRange));
  memcpy(blob.data(), table.data(), head);
  if (!pr.empty())
    memcpy(blob.data() + head, pr.data(), pr.size() * sizeof(PassRange));
  cudaMemcpyAsync(sc.table, blob.data(), blob.size(), cudaMemcpyHostToDevice,
                  s);
  const int* dr = sc.table;
  const int* blist = sc.table + R;
  const PassRange* dev_pr = (const PassRange*)((char*)sc.table + head);

  // 2 + 3. split and pack
  split_pack<<<grid_for(n, 256), 256, 0, s>>>(key, N, n, ex, sc.sizes, dr,
                                              blist, B, sc.pk, sc.idx, out);
  // 4. passes
  for (int p = 0; p < passes; ++p) {
    const uint32_t* kin = sc.kbuf[(p + 1) & 1];
    const int* pin = sc.pbuf[(p + 1) & 1];
    round_pass<<<tiles_of[p], PASS_THREADS, 0, s>>>(
        dev_pr + first[p], first[p + 1] - first[p], (unsigned)(p + 1),
        sc.pk, n, kin, pin, sc.kbuf[p & 1], sc.pbuf[p & 1], sc.idx, out,
        sc.hist, sc.status, sc.tickets + p);
  }
  info[0] = passes;
  return cudaGetLastError();
}

}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_sort_scratch_bytes(int n, int K) {
  return round_sort_scratch_bytes(1, n, K);
}

// perm (int32[n]) receives the permutation; scratch
// (ctpu_sort_scratch_bytes(n, K) bytes) is work space. info (host
// int64[2]) receives the passes run and the host nanoseconds spent in
// the plan's device-to-host copy and stream sync.
extern "C" int ctpu_sort_perm(const uint32_t* lanes, int K,
                              const uint32_t* valid, const uint32_t* ts_h,
                              const uint32_t* ts_l, int n, int* perm,
                              void* scratch, void* stream,
                              long long* info) {
  const RoundKeys key{lanes, valid, ts_h, ts_l, K};
  return (int)round_sort_perm(key, 1, n, perm, scratch,
                              (cudaStream_t)stream, info);
}
