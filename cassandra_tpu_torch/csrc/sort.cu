// The round sort: the stable lexicographic sort permutation of K1 (a
// merge round), of the mesh step K8 (mesh.cu: the same code over S
// segments, the shards, of N rows each), of the plane programs K6 and
// K7 (planes.cu) and of K10's winners on its select path (ann.cu).
//
// K1 replaces cassandra_tpu/ops/merge.py `_lsd_pass` as chained by
// `_traced_sort_perm` (`device_sort_perm`): the sort over (valid,
// lanes[0..K-1], ~ts_h, ~ts_l), most significant first, 4 (K + 3) key
// bytes a row. K6's and K7's sorts replace `_plane_program_fast`'s and
// `_plane_lsd_sort`'s chains of stable sorts over planes of 1, 2 or 4
// bytes (the partition rank, the varying lanes, the stamp planes,
// descending ones flipped). The JAX package runs one stable (key, perm)
// sort per key, least significant first. A stable lexicographic sort
// has exactly one result, and dropping a byte that is constant among
// the rows it orders leaves that result unchanged, so the permutation
// is the JAX package's.
//
// Bound on this card: bytes. Read once, K1's keys are (K + 3) * 4 B and
// the permutation 4 B per row: at N = 2^24 and K = 13, 1.07 GB, 0.34 ms
// at 3.35 TB/s; a K6 round reads 5-8 B a row. The first design (a
// radix sort of the permutation, since deleted) ran every key byte as a
// pass of three launches, reading its byte through the permutation
// twice. This design, per call over S segments of a key of B bytes
// (RoundKey, common.cuh):
//
//   1. plan: one read of every row's key builds a 256-bin histogram
//      of each key byte per (segment, group), group = live or pad
//      (plane 0 below the key's threshold or not), in shared memory,
//      added into global memory with atomics. A byte varies in a group
//      when more than one bin is filled. The histograms, scanned in
//      place, stay on the device as every pass's digit bases; no pass
//      builds a histogram.
//   2. table: one block reads the plan (which bytes vary, the groups'
//      sizes) and writes, on the card, each range's varying bytes and,
//      per pass, the ranges it runs, their tiles and its tile count.
//      Nothing goes to the host: the sort never waits for the device,
//      so a round's submit returns while the card works.
//   3. split: each segment's rows are stably partitioned into live, then
//      pad (an exclusive add-scan of the live flags). Plane 0 is the
//      most significant key, so every pad row sorts after every live
//      row, and each (segment, group) becomes a range with its own
//      varying bytes. Padding rows are identical in practice: their
//      range runs no pass. Among pad rows plane 0's bytes count like any
//      other, so pad rows whose plane 0 differs still sort right.
//   4. pack: each row's varying bytes, most significant first, go into
//      ceil(D / 4) word-major u32 arrays (D = the bytes that vary in
//      the row's range). Concatenated in order of significance, they
//      order exactly as the whole key.
//   5. passes: one LSD pass per packed byte, least significant first,
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
// The host knows only the upper bound B of the passes (the key's
// bytes). It launches all B as one CUDA graph of B kernel nodes (one
// launch on the host; the graph is built once per stream, key width and
// grid, and takes each call's arguments), each on at most one wave of
// resident blocks that take tiles by ticket until the pass's tiles,
// read on the card, run out. A pass past the plan's count has none:
// every block exits at once.
#include <atomic>
#include <cstring>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

#include "common.cuh"

namespace ctpu {
namespace {

constexpr int RADIX = 256;

constexpr int PLAN_THREADS = 256;
constexpr int PLAN_WORDS = 4;         // key planes per plan block
constexpr int PLAN_MIN_ROWS = 1024;   // rows per plan block and plane chunk
constexpr int PLAN_BLOCKS = 2048;     // plan blocks per call, about
constexpr int TABLE_THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int PASS_ITEMS = 16;
constexpr int PASS_TILE = PASS_THREADS * PASS_ITEMS;
constexpr int PASS_WARPS = PASS_THREADS / 32;

// Plane k's value of row i, xor'd with its mask.
__device__ __forceinline__ uint32_t plane_val(const KeyPlane& k, long i) {
  const long at = i * k.stride;
  uint32_t v;
  if (k.width == 4)
    v = static_cast<const uint32_t*>(k.p)[at];
  else if (k.width == 2)
    v = static_cast<const uint16_t*>(k.p)[at];
  else
    v = static_cast<const uint8_t*>(k.p)[at];
  return v ^ k.xmask;
}

__device__ __forceinline__ bool is_live(const RoundKey& k, long i) {
  return plane_val(k.pl[0], i) < k.live_below;
}

// Plan block (chunk, tile, segment): rows [tile * rows, ...) of the
// segment, key planes [chunk * PLAN_WORDS, ...). A warp whose lanes all
// hold one (group, value), or one (group, byte), adds once; the others
// add per lane.
// hist[((segment * 2 + group) * B + byte) * RADIX + bin] counts rows;
// chunk 0 also writes live[i].
// W4: every plane is 4 bytes wide (K1's and K8's keys), so the widths
// are known at compile time.
template <bool W4>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_hist(const __grid_constant__ RoundKey key, int N, int rows, int* hist,
          int* live) {
  __shared__ int h[2][PLAN_WORDS * 4][RADIX];
  const int tid = threadIdx.x, lane = tid & 31;
  const int B = key.bytes;
  const int w0 = blockIdx.x * PLAN_WORDS;
  const int nw = min(PLAN_WORDS, key.np - w0);
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
    // the row's values first, so that their loads are in flight together
    uint32_t x[PLAN_WORDS];
#pragma unroll
    for (int w = 0; w < PLAN_WORDS; ++w) {
      const KeyPlane& k = key.pl[w0 + w];
      x[w] = !act || w >= nw ? 0u
             : W4 ? static_cast<const uint32_t*>(k.p)[i * k.stride] ^ k.xmask
                  : plane_val(k, i);
    }
    const int g = !act                 ? 0
                  : W4 && w0 == 0       ? !(x[0] < key.live_below)
                                        : !is_live(key, i);
    if (act && blockIdx.x == 0) live[i] = !g;
    const int lead = __ffs(amask) - 1;
    const int g0 = __shfl_sync(0xffffffffu, g, lead);
#pragma unroll
    for (int w = 0; w < PLAN_WORDS; ++w) {
      if (w >= nw) break;
      const int width = W4 ? 4 : key.pl[w0 + w].width;
      const uint32_t x0 = __shfl_sync(0xffffffffu, x[w], lead);
      if (__all_sync(0xffffffffu, !act || (x[w] == x0 && g == g0))) {
        // one (group, value) in every lane: each byte adds once
        if (lane == lead)
          for (int j = 0; j < width; ++j)
            atomicAdd(&h[g0][4 * w + j][(x0 >> (8 * (width - 1 - j))) & 255],
                      __popc(amask));
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= width) break;
        const int bin = (g << 8) | ((x[w] >> (8 * (width - 1 - j))) & 255);
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
    const int w = jb >> 2, j = jb & 3;
    if (!W4 && j >= key.pl[w0 + w].width) continue;
    const int c = h[g][jb][d];
    if (c)
      atomicAdd(&hist[(((long)s * 2 + g) * B + key.first_byte[w0 + w] + j)
                      * RADIX + d], c);
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

// One range of one pass: positions [start, start + len), its first tile
// in the pass's numbering, the row of its digits' bases (range * B +
// byte), the digit's shift, the packed word pass 0 reads its keys from
// (else -1: the keys come from the last pass), the packed word gathered
// into the output keys when the next pass starts a new word (else -1),
// and whether this is the range's last pass.
struct PassRange {
  int start, len, tile0, base_row, shift, in_word, next_word, last;
};

// The pass table, built on the card by one block from the plan: each
// range r's varying bytes (dr[r] of them, most significant first, in
// blist[r * B ...]); per pass p < B, its ranges (ranges[p * R ...]),
// their count and tiles (hdr[2 p], hdr[2 p + 1]); and the passes run,
// the most varying bytes of any range.
__global__ void __launch_bounds__(TABLE_THREADS)
plan_table(const uint8_t* vary, const int* sizes, int R, int B, int N,
           int* dr, int* blist, int* hdr, PassRange* ranges, int* passes) {
  __shared__ int most;
  const int tid = threadIdx.x;
  if (tid == 0) most = 0;
  __syncthreads();
  for (int r = tid; r < R; r += TABLE_THREADS) {
    int D = 0;
    for (int b = 0; b < B; ++b)
      if (vary[(long)r * B + b]) blist[(long)r * B + D++] = b;
    dr[r] = D;
    atomicMax(&most, D);
  }
  __syncthreads();
  for (int p = tid; p < B; p += TABLE_THREADS) {
    int cnt = 0, tiles = 0;
    for (int r = 0; r < R; ++r) {
      const int D = dr[r];
      if (D <= p) continue;
      const int q = D - 1 - p;  // this pass's packed byte
      PassRange e;
      e.start = (r / 2) * N + (r % 2 ? sizes[r - 1] : 0);
      e.len = sizes[r];
      e.tile0 = tiles;
      e.base_row = r * B + blist[(long)r * B + q];
      e.shift = 24 - 8 * (q & 3);
      e.in_word = p == 0 ? q >> 2 : -1;
      e.next_word = (q & 3) == 0 && q > 0 ? (q >> 2) - 1 : -1;
      e.last = q == 0;
      ranges[(long)p * R + cnt++] = e;
      tiles += (e.len + PASS_TILE - 1) / PASS_TILE;
    }
    hdr[2 * p] = cnt;
    hdr[2 * p + 1] = tiles;
  }
  if (tid == 0) *passes = most;
}

// Split and pack, one thread per row i of segment s: its position in
// the segment's (live, then pad) order, idx[pos] = i (and out[pos] = i,
// the answer for a range that runs no pass), and its range's varying
// bytes packed into pk[word * n + pos].
__global__ void split_pack(const __grid_constant__ RoundKey key, int N,
                           long n, const int* ex, const int* sizes,
                           const int* dr, const int* blist, uint32_t* pk,
                           int* idx, int* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int B = key.bytes;
  const int s = (int)(i / N);
  const long seg0 = (long)s * N;
  const bool live = is_live(key, i);
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
    const int at = key.byte_at[bl[q]];
    if ((at >> 5) != cur) {
      cur = at >> 5;
      x = plane_val(key.pl[cur], i);
    }
    word |= ((x >> (at & 31)) & 255u) << (24 - 8 * (q & 3));
    if ((q & 3) == 3 || q == D - 1) {
      pk[(long)(q >> 2) * n + pos] = word;
      word = 0;
    }
  }
}

__device__ __forceinline__ void put_status(unsigned long long* p,
                                           unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

__device__ __forceinline__ unsigned long long get_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

// The passes' operands (the table and the buffers), one launch argument
// for every pass.
struct PassArgs {
  const PassRange* ranges;  // [B, R]
  const int* hdr;           // [B, 2]: ranges and tiles per pass
  const uint32_t* pk;
  uint32_t* kbuf[2];
  int* pbuf[2];
  const int* idx;
  int* out;
  const int* bases;
  unsigned long long* status;
  int* tickets;             // [B]
  long n;
  int R;
};

// Pass `pass`. A block takes tiles by ticket until they run out; a
// block at or past the pass's tile count exits at once. Three blocks an
// SM.
__global__ void __launch_bounds__(PASS_THREADS, 3)
round_pass(const __grid_constant__ PassArgs a, int pass) {
  __shared__ int wcnt[PASS_WARPS][RADIX];
  __shared__ uint32_t skey[PASS_TILE];
  __shared__ int spos[PASS_TILE];
  __shared__ int s_tile;
  __shared__ int lstart[RADIX], gofs[RADIX], wsum[PASS_WARPS];
  const PassRange* ranges = a.ranges + (long)pass * a.R;
  const int nr = a.hdr[2 * pass], tiles = a.hdr[2 * pass + 1];
  const unsigned tag = (unsigned)(pass + 1);
  const long n = a.n;
  const uint32_t* pk = a.pk;
  const uint32_t* kin = a.kbuf[(pass + 1) & 1];
  const int* pin = a.pbuf[(pass + 1) & 1];
  uint32_t* kout = a.kbuf[pass & 1];
  int* pout = a.pbuf[pass & 1];
  const int* idx = a.idx;
  int* out = a.out;
  const int* bases = a.bases;
  unsigned long long* status = a.status;
  int* ticket = a.tickets + pass;
  if ((int)blockIdx.x >= tiles) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  // warp w holds the tile's elements [w, w + 1) * PASS_ITEMS * 32, in
  // rounds of 32 consecutive ones
  const int wbase = w * PASS_ITEMS * 32;
  for (;;) {
    if (tid == 0) s_tile = atomicAdd(ticket, 1);
    for (int j = tid; j < PASS_WARPS * RADIX; j += PASS_THREADS)
      (&wcnt[0][0])[j] = 0;
    __syncthreads();
    const int t = s_tile;
    if (t >= tiles) return;
    int r = 0;
    while (r + 1 < nr && ranges[r + 1].tile0 <= t) ++r;
    const PassRange R = ranges[r];
    const int ti = t - R.tile0;
    const int count = min(PASS_TILE, R.len - ti * PASS_TILE);
    const long base = (long)R.start + (long)ti * PASS_TILE;

    // loads first, all in flight together
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

    // decoupled look-back over the range's earlier tiles: flag in the
    // high word (2 tag - 1 = this tile's count, 2 tag = the inclusive
    // prefix; anything lower is an earlier pass's), the value in the
    // low word
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
    __syncthreads();  // the tile's shared memory is free again
  }
}

// Scratch of the round sort, in this order (each part 256-byte aligned).
struct RoundScratch {
  int* hist;        // [2 S, B, RADIX] counts, then digit bases
  int* sizes;       // [2 S] rows per range
  uint8_t* vary;    // [2 S, B]
  int* dr;          // [2 S] varying bytes per range
  int* blist;       // [2 S, B] their indices
  int* hdr;         // [B, 2] ranges and tiles per pass
  PassRange* ranges;  // [B, 2 S]
  int* tickets;     // [B]
  unsigned long long* status;  // [tiles, RADIX]
  int* scan;        // scan_scratch_elems(n)
  int* idx;         // [n]
  uint32_t* kbuf[2];  // [n] each; the live flags and their scan first
  int* pbuf[2];       // [n] each
  uint32_t* pk;     // [ceil(B / 4), n]
  long bytes;
};

long align256(long b) { return (b + 255) / 256 * 256; }

// Tiles of one pass, at most: each range adds at most one partial tile.
long pass_tiles(int S, long n) {
  return (n + PASS_TILE - 1) / PASS_TILE + 2L * S;
}

RoundScratch carve(void* base, int S, int N, int B) {
  const long n = (long)S * N;
  const long R = 2L * S;
  RoundScratch r;
  char* p = (char*)base;
  long off = 0;
  auto take = [&](long bytes) {
    char* q = p == nullptr ? nullptr : p + off;
    off += align256(bytes);
    return (void*)q;
  };
  r.hist = (int*)take(R * B * RADIX * 4);
  r.sizes = (int*)take(R * 4 + R * B);
  r.vary = (uint8_t*)(r.sizes == nullptr ? nullptr : r.sizes + R);
  r.dr = (int*)take(R * 4);
  r.blist = (int*)take(R * B * 4);
  r.hdr = (int*)take(2L * B * 4);
  r.ranges = (PassRange*)take((long)B * R * sizeof(PassRange));
  r.tickets = (int*)take((long)B * 4);
  r.status = (unsigned long long*)take(pass_tiles(S, n) * RADIX * 8);
  r.scan = (int*)take(scan_scratch_elems(n) * 4);
  r.idx = (int*)take(n * 4);
  r.kbuf[0] = (uint32_t*)take(n * 4);
  r.kbuf[1] = (uint32_t*)take(n * 4);
  r.pbuf[0] = (int*)take(n * 4);
  r.pbuf[1] = (int*)take(n * 4);
  r.pk = (uint32_t*)take((long)(B + 3) / 4 * n * 4);
  r.bytes = off;
  return r;
}

}  // namespace

RoundKey round_key(uint32_t live_below) {
  RoundKey k;
  memset(&k, 0, sizeof(k));
  k.live_below = live_below;
  return k;
}

void round_key_add(RoundKey& key, const void* p, int stride, int width,
                   uint32_t xmask) {
  const int j = key.np++;
  key.pl[j] = KeyPlane{p, stride, width, xmask};
  key.first_byte[j] = (uint16_t)key.bytes;
  for (int t = 0; t < width; ++t)
    key.byte_at[key.bytes++] = (uint16_t)(j << 5 | 8 * (width - 1 - t));
}

RoundKey lanes_key(const uint32_t* lanes, int K, const uint32_t* valid,
                   const uint32_t* ts_h, const uint32_t* ts_l) {
  RoundKey k = round_key(1u);
  round_key_add(k, valid, 1, 4, 0u);
  for (int j = 0; j < K; ++j) round_key_add(k, lanes + j, K, 4, 0u);
  round_key_add(k, ts_h, 1, 4, 0xffffffffu);
  round_key_add(k, ts_l, 1, 4, 0xffffffffu);
  return k;
}

long round_sort_scratch_bytes(int S, int N, int B) {
  return carve(nullptr, S, N, B).bytes;
}

// Resident blocks of round_pass on the current device: one wave.
long pass_wave() {
  static std::atomic<int> cached[64];  // per device; 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  int w = dev < 64 ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (w == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, round_pass,
                                                  PASS_THREADS, 0);
    w = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cached[dev].store(w, std::memory_order_relaxed);
  }
  return w;
}

// The B pass launches of one (device, stream, B, grid): a CUDA graph of
// B kernel nodes, instantiated at the first call and relaunched with
// each call's arguments (set into the executable graph, which changes
// only later launches): one launch on the host in place of B. The
// graphs are kept for the process; each is used under its own lock and
// belongs to one stream, so calls on two streams never share one.
struct PassGraph {
  std::mutex mu;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  std::vector<cudaGraphNode_t> nodes;
};

cudaError_t run_passes(const PassArgs& a, long most, int B, cudaStream_t s) {
  static std::mutex cache_mu;
  static std::map<std::tuple<int, cudaStream_t, int, unsigned>, PassGraph*>
      cache;
  const long wave = pass_wave();
  const unsigned grid = (unsigned)(most < wave ? most : wave);
  int dev = 0;
  cudaGetDevice(&dev);
  PassGraph* g;
  {
    std::lock_guard<std::mutex> lk(cache_mu);
    PassGraph*& slot = cache[std::make_tuple(dev, s, B, grid)];
    if (slot == nullptr) slot = new PassGraph();
    g = slot;
  }
  std::lock_guard<std::mutex> lk(g->mu);
  PassArgs args = a;
  int p = 0;
  void* params[2] = {&args, &p};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)round_pass;
  kp.gridDim = dim3(grid);
  kp.blockDim = dim3(PASS_THREADS);
  kp.sharedMemBytes = 0;
  kp.kernelParams = params;
  cudaError_t err = cudaSuccess;
  if (g->exec == nullptr) {
    if (g->graph == nullptr) {
      err = cudaGraphCreate(&g->graph, 0);
      if (err != cudaSuccess) return err;
      g->nodes.resize(B);
      for (p = 0; p < B && err == cudaSuccess; ++p)
        err = cudaGraphAddKernelNode(&g->nodes[p], g->graph,
                                     p ? &g->nodes[p - 1] : nullptr,
                                     p ? 1 : 0, &kp);
      if (err != cudaSuccess) {
        cudaGraphDestroy(g->graph);
        g->graph = nullptr;
        return err;
      }
    }
    err = cudaGraphInstantiate(&g->exec, g->graph, 0);
    if (err != cudaSuccess) {
      g->exec = nullptr;
      return err;
    }
  }
  for (p = 0; p < B && err == cudaSuccess; ++p)
    err = cudaGraphExecKernelNodeSetParams(g->exec, g->nodes[p], &kp);
  if (err != cudaSuccess) return err;
  return cudaGraphLaunch(g->exec, s);
}

cudaError_t round_sort_perm(const RoundKey& key, int S, int N, int* out,
                            void* scratch, cudaStream_t s, int* passes) {
  const long n = (long)S * N;
  if (n == 0) {
    cudaMemsetAsync(passes, 0, sizeof(int), s);
    return cudaGetLastError();
  }
  const int B = key.bytes, R = 2 * S;
  RoundScratch sc = carve(scratch, S, N, B);
  int* live = (int*)sc.kbuf[0];
  int* ex = (int*)sc.kbuf[1];
  const long most = pass_tiles(S, n);

  // 1. plan
  cudaMemsetAsync(sc.hist, 0, (size_t)R * B * RADIX * 4, s);
  cudaMemsetAsync(sc.tickets, 0, (size_t)B * 4, s);
  cudaMemsetAsync(sc.status, 0, (size_t)most * RADIX * 8, s);
  const int chunks = (key.np + PLAN_WORDS - 1) / PLAN_WORDS;
  const int want = PLAN_BLOCKS / (chunks * S);
  int tiles = (N + PLAN_MIN_ROWS * chunks - 1) / (PLAN_MIN_ROWS * chunks);
  if (tiles > want) tiles = want > 1 ? want : 1;
  const int rows = (N + tiles - 1) / tiles;
  bool w4 = true;
  for (int j = 0; j < key.np; ++j) w4 = w4 && key.pl[j].width == 4;
  const dim3 pgrid(chunks, tiles, S);
  if (w4)
    plan_hist<true><<<pgrid, PLAN_THREADS, 0, s>>>(key, N, rows, sc.hist,
                                                   live);
  else
    plan_hist<false><<<pgrid, PLAN_THREADS, 0, s>>>(key, N, rows, sc.hist,
                                                    live);
  scan_add_exclusive(live, ex, n, sc.scan, s);
  plan_bases<<<R * B, RADIX, 0, s>>>(sc.hist, B, sc.vary, sc.sizes);
  // 2. table, on the card
  plan_table<<<1, TABLE_THREADS, 0, s>>>(sc.vary, sc.sizes, R, B, N,
                                         sc.dr, sc.blist, sc.hdr, sc.ranges,
                                         passes);
  // 3 + 4. split and pack
  split_pack<<<grid_for(n, 256), 256, 0, s>>>(key, N, n, ex, sc.sizes, sc.dr,
                                              sc.blist, sc.pk, sc.idx, out);
  // 5. passes, on at most one wave of resident blocks
  PassArgs a;
  a.ranges = sc.ranges;
  a.hdr = sc.hdr;
  a.pk = sc.pk;
  a.kbuf[0] = sc.kbuf[0];
  a.kbuf[1] = sc.kbuf[1];
  a.pbuf[0] = sc.pbuf[0];
  a.pbuf[1] = sc.pbuf[1];
  a.idx = sc.idx;
  a.out = out;
  a.bases = sc.hist;
  a.status = sc.status;
  a.tickets = sc.tickets;
  a.n = n;
  a.R = R;
  const cudaError_t err = run_passes(a, most, B, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_sort_scratch_bytes(int n, int K) {
  return round_sort_scratch_bytes(1, n, 4 * (K + 3));
}

// perm (int32[n]) receives the permutation; scratch
// (ctpu_sort_scratch_bytes(n, K) bytes) is work space; passes (device
// int32[1]) receives the passes run. Returns without waiting for the
// device.
extern "C" int ctpu_sort_perm(const uint32_t* lanes, int K,
                              const uint32_t* valid, const uint32_t* ts_h,
                              const uint32_t* ts_l, int n, int* perm,
                              void* scratch, void* stream, int* passes) {
  const RoundKey key = lanes_key(lanes, K, valid, ts_h, ts_l);
  return (int)round_sort_perm(key, 1, n, perm, scratch, (cudaStream_t)stream,
                              passes);
}
