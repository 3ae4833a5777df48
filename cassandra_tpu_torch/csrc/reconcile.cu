// K2: the reconcile of a sorted merge round.
//
// Replaces cassandra_tpu/ops/merge.py `_reconcile_core` (jitted as
// `reconcile_kernel`): over the sort permutation, the partition / row /
// column / cell boundaries from lane differences, the three segmented
// forward-fills of the (hi, lo) deletion stamps, shadowing, TTL expiry,
// gc-grace purge and the equal-(identity, ts) ambiguity flag, packed
// into one u8 per sorted position (bit0 keep, bit1 ambiguous,
// bit2 expired, bit3 shadowed).
//
// Bound on this card: bytes. Read once, the inputs are the lanes
// (K * 4 B), nine u32 columns and the permutation, and the output is
// 1 B: at N = 2^24 and K = 13 about 1.56 GB, 0.47 ms at 3.35 TB/s. The
// rows are read through the permutation, so each 4-byte read costs a
// 32-byte sector unless its neighbours in sorted order lie near it in
// storage (in a round merged from a few sorted runs they mostly do; in
// the smoke's synthetic rounds, whose rows come in random order, not).
//
// Design: one kernel (after one memset of the tiles' flags). Blocks
// take work by atomic ticket, in order: first the packing of every
// row's stamp and flags into one 16-byte record (storage order,
// coalesced; a random gather of seven 4-byte columns would fetch seven
// 32-byte sectors a row), then tiles of REC_TILE sorted positions,
// each thread four consecutive positions. A thread gathers each of its
// rows' lanes and record once (and the row before its first), so the
// boundaries and the same-ts flag compare registers, not a second
// gather; a tile reads its lanes while the packing finishes. The three
// forward-fills are segmented scans whose value is the stamp written at
// the segment's last start (`Fill`), so a start row is never read
// again: in the thread, then across the warp by shuffles, then across
// the block's warps, then across tiles by decoupled look-back: a tile
// publishes its aggregate, then its inclusive prefix, each behind a
// flag word, and one warp reads its predecessors 32 at a time until one
// is inclusive or holds a partition start (which fills all three
// levels). A round's padding holds no start, so a tile there folds the
// aggregates of every predecessor not yet inclusive: read one at a
// time, that walk would be a chain of round trips as long as the
// padding. The purge stamp is read only where purge is possible.
// `reconcile_seg` runs the same kernel over equal segments (the mesh
// step K8, mesh.cu): the first row of every segment starts a partition
// and has no previous row, as row 0 of a round has, so a full segment
// never reads its neighbour's last row.
#include "common.cuh"

namespace ctpu {
namespace {

constexpr uint32_t COL_PARTITION_DEL = 0;
constexpr uint32_t COL_ROW_DEL = 1;

constexpr int REC_THREADS = 256;
constexpr int REC_ITEMS = 4;
constexpr int REC_TILE = REC_THREADS * REC_ITEMS;
constexpr int REC_WARPS = REC_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// The forward-fills' carry over a span of sorted positions: bit L of
// `has` says a level-L segment (0 partition, 1 row, 2 column) starts in
// the span, and st[L] is the stamp written at its last start: the
// row's (hi << 32) | lo when it is a deletion of that level, else 0.
struct Fill {
  unsigned long long has;
  unsigned long long st[3];
};

__device__ __forceinline__ Fill fill_none() {
  Fill f;
  f.has = 0;
  f.st[0] = f.st[1] = f.st[2] = 0;
  return f;
}

// The span a followed by the span b: each level keeps b's last start
// where b has one.
__device__ __forceinline__ Fill fill_then(const Fill& a, const Fill& b) {
  Fill r;
  r.has = a.has | b.has;
#pragma unroll
  for (int L = 0; L < 3; ++L) r.st[L] = (b.has >> L) & 1 ? b.st[L] : a.st[L];
  return r;
}

__device__ __forceinline__ Fill fill_shfl_up(const Fill& f, int o) {
  Fill r;
  r.has = __shfl_up_sync(FULL, f.has, o);
#pragma unroll
  for (int L = 0; L < 3; ++L) r.st[L] = __shfl_up_sync(FULL, f.st[L], o);
  return r;
}

__device__ __forceinline__ Fill fill_shfl_down(const Fill& f, int o) {
  Fill r;
  r.has = __shfl_down_sync(FULL, f.has, o);
#pragma unroll
  for (int L = 0; L < 3; ++L) r.st[L] = __shfl_down_sync(FULL, f.st[L], o);
  return r;
}

__device__ __forceinline__ void fill_store(Fill* p, const Fill& f) {
  volatile unsigned long long* q = (volatile unsigned long long*)p;
  q[0] = f.has;
  q[1] = f.st[0];
  q[2] = f.st[1];
  q[3] = f.st[2];
}

__device__ __forceinline__ Fill fill_load(const Fill* p) {
  const volatile unsigned long long* q = (const volatile unsigned long long*)p;
  Fill f;
  f.has = q[0];
  f.st[0] = q[1];
  f.st[1] = q[2];
  f.st[2] = q[3];
  return f;
}

// A tile's status: 0 not yet published, 1 its aggregate, 2 its
// inclusive prefix.
constexpr unsigned ST_AGG = 1, ST_INC = 2;

// A row's stamp and flags, packed by the first phase so that a
// gather through the permutation reads one 16-byte record, not seven
// columns: (ts_h, ts_l, ldt, bit0 valid | bit1 expiring | bit2 death |
// bit3 complex deletion).
constexpr uint32_t R_VALID = 1, R_EXPIRING = 2, R_DEATH = 4, R_CDEL = 8;
constexpr int PACK_ROWS = 4096;   // rows a packing item

struct RecArgs {
  RecIn in;
  const int* perm;
  uint8_t* packed;
  int* ticket;      // zeroed
  int* done;        // packing items finished; zeroed
  unsigned* flag;   // [tiles], zeroed
  Fill* agg;        // [tiles]
  Fill* inc;        // [tiles]
  uint4* rec;       // [n]
  int K;
  int n;
  int n_pack;
  int seg_len;
  int now;
  int gc_before;
};

// Records of rows [item * PACK_ROWS, +PACK_ROWS), in storage order
// (every read and write coalesced).
__device__ void rec_pack(const RecArgs& a, int item) {
  const RecIn& in = a.in;
  const int end = min(a.n, (item + 1) * PACK_ROWS);
  for (int r = item * PACK_ROWS + threadIdx.x; r < end; r += REC_THREADS) {
    const uint32_t f = (in.valid[r] == 0 ? R_VALID : 0) |
                       (in.expiring[r] == 1 ? R_EXPIRING : 0) |
                       (in.death[r] == 1 ? R_DEATH : 0) |
                       (in.cdel[r] == 1 ? R_CDEL : 0);
    a.rec[r] = make_uint4(in.ts_h[r], in.ts_l[r], (uint32_t)in.ldt[r], f);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(a.done, 1);
}

__device__ __forceinline__ unsigned long long pair64(uint32_t h,
                                                     uint32_t l) {
  return ((unsigned long long)h << 32) | l;
}

// d[j] |= lane k of row p[j] differs from the row before it (q for
// the first); val, when given, receives the lane.
__device__ __forceinline__ void lane_diff(const uint32_t* lanes, int K,
                                          int q, const int* p, int k,
                                          bool* d, uint32_t* val = nullptr) {
  uint32_t prev = q >= 0 ? __ldg(lanes + (long)q * K + k) : 0u;
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j) {
    const uint32_t cur = p[j] >= 0 ? __ldg(lanes + (long)p[j] * K + k) : 0u;
    d[j] |= cur != prev;
    if (val) val[j] = cur;
    prev = cur;
  }
}

__global__ void __launch_bounds__(REC_THREADS)
rec_tiles(const __grid_constant__ RecArgs a) {
  __shared__ int s_tile;
  __shared__ Fill s_warp[REC_WARPS];
  __shared__ Fill s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(a.ticket, 1);
  __syncthreads();
  if (s_tile < a.n_pack) {
    rec_pack(a, s_tile);
    return;
  }
  const int t = s_tile - a.n_pack;
  const RecIn& in = a.in;
  const int K = a.K, n = a.n;
  const int i0 = t * REC_TILE + tid * REC_ITEMS;

  // this thread's rows, and the row before its first (-1: none, at a
  // segment's first position)
  int p[REC_ITEMS];
  bool first[REC_ITEMS];
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j) {
    const int i = i0 + j;
    p[j] = i < n ? a.perm[i] : -1;
    first[j] = i % a.seg_len == 0;
  }
  const int q = (i0 < n && !first[0]) ? a.perm[i0 - 1] : -1;

  // boundaries: the lanes of each row against the row before
  bool d_part[REC_ITEMS], d_row[REC_ITEMS], d_col[REC_ITEMS],
      d_cell[REC_ITEMS];
  uint32_t colv[REC_ITEMS];
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j) {
    d_part[j] = d_row[j] = d_col[j] = d_cell[j] = false;
    colv[j] = 0;
  }
  // (lanes 0-3 and K-3..K-1 unrolled, so that a thread has 15-20
  // gathers in flight, not the five of one lane)
#pragma unroll
  for (int k = 0; k < 4; ++k)
    lane_diff(in.lanes, K, q, p, k, d_part);
#pragma unroll 4
  for (int k = 4; k < K - 3; ++k) lane_diff(in.lanes, K, q, p, k, d_row);
  lane_diff(in.lanes, K, q, p, K - 3, d_col, colv);
#pragma unroll
  for (int k = K - 2; k < K; ++k) lane_diff(in.lanes, K, q, p, k, d_cell);

  // each row's record, once (after the packing items, which took the
  // earlier tickets, have finished); the starts and their stamps
  if (tid == 0) {
    while (*(volatile int*)a.done < a.n_pack) {
    }
    __threadfence();
  }
  __syncthreads();
  uint4 rc[REC_ITEMS];
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j)
    rc[j] = p[j] >= 0 ? __ldcg(a.rec + p[j]) : make_uint4(0, 0, 0, 0);
  const uint4 prc = q >= 0 ? __ldcg(a.rec + q) : make_uint4(0, 0, 0, 0);
  uint32_t th[REC_ITEMS], tl[REC_ITEMS];
  uint8_t lvl[REC_ITEMS];   // bits: 0 partition, 1 row, 2 column, 3 cell
  bool is_cd[REC_ITEMS];
  uint32_t pth = prc.x, ptl = prc.y;
  bool same_ts[REC_ITEMS];
  Fill mine = fill_none();
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j) {
    const int r = p[j];
    th[j] = rc[j].x;
    tl[j] = rc[j].y;
    is_cd[j] = (rc[j].w & R_CDEL) != 0;
    const bool part = first[j] || d_part[j];
    const bool row = part || d_row[j];
    const bool col = row || d_col[j];
    const bool cell = col || d_cell[j];
    lvl[j] = r < 0 ? 0
                   : (uint8_t)((part ? 1 : 0) | (row ? 2 : 0) |
                               (col ? 4 : 0) | (cell ? 8 : 0));
    same_ts[j] = !first[j] && th[j] == pth && tl[j] == ptl;
    pth = th[j];
    ptl = tl[j];
    const unsigned long long ts = pair64(th[j], tl[j]);
    const unsigned long long v[3] = {
        colv[j] == COL_PARTITION_DEL ? ts : 0ull,
        colv[j] == COL_ROW_DEL ? ts : 0ull, is_cd[j] ? ts : 0ull};
#pragma unroll
    for (int L = 0; L < 3; ++L)
      if ((lvl[j] >> L) & 1) mine.st[L] = v[L];
    mine.has |= lvl[j] & 7;
  }

  // the fills across the warp (inclusive, then shifted to exclusive)
  Fill x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Fill y = fill_shfl_up(x, o);
    if (lane >= o) x = fill_then(y, x);
  }
  Fill carry = fill_shfl_up(x, 1);
  if (lane == 0) carry = fill_none();
  if (lane == 31) s_warp[w] = x;
  __syncthreads();

  // across tiles: decoupled look-back by warp 0, over 32 predecessors
  // at a time (lane l reads tile j0 - l): a window folds back to its
  // nearest inclusive prefix or aggregate holding a partition start
  // (which fills all three levels), else the next window goes on
  if (w == 0) {
    Fill agg = s_warp[0];
#pragma unroll
    for (int k = 1; k < REC_WARPS; ++k) agg = fill_then(agg, s_warp[k]);
    if (lane == 0) {
      fill_store((t == 0 ? a.inc : a.agg) + t, agg);
      __threadfence();
      *(volatile unsigned*)(a.flag + t) = t == 0 ? ST_INC : ST_AGG;
    }
    Fill pre = fill_none();
    for (int j0 = t - 1; j0 >= 0; j0 -= 32) {
      const int j = j0 - lane;
      unsigned f = ST_INC;                   // before tile 0: nothing
      Fill v = fill_none();
      if (j >= 0) {
        do {
          f = *(volatile unsigned*)(a.flag + j);
        } while (f == 0);
        __threadfence();
        v = fill_load(f == ST_INC ? a.inc + j : a.agg + j);
      }
      const unsigned stop = __ballot_sync(FULL, f == ST_INC || v.has == 7);
      if (stop && lane > __ffs(stop) - 1) v = fill_none();
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const Fill y = fill_shfl_down(v, o);
        if (lane + o < 32) v = fill_then(y, v);
      }
      pre = fill_then(v, pre);               // lane 0's is the window's
      if (stop) break;
    }
    if (lane == 0) {
      if (t > 0) {
        fill_store(a.inc + t, fill_then(pre, agg));
        __threadfence();
        *(volatile unsigned*)(a.flag + t) = ST_INC;
      }
      s_prefix = pre;
    }
  }
  __syncthreads();
  Fill before = s_prefix;
  for (int k = 0; k < w; ++k) before = fill_then(before, s_warp[k]);
  carry = fill_then(before, carry);

  // the rules at each position
  uint8_t out[REC_ITEMS];
#pragma unroll
  for (int j = 0; j < REC_ITEMS; ++j) {
    out[j] = 0;
    const int r = p[j];
    if (r < 0) continue;
    const unsigned long long ts = pair64(th[j], tl[j]);
    const unsigned long long v[3] = {
        colv[j] == COL_PARTITION_DEL ? ts : 0ull,
        colv[j] == COL_ROW_DEL ? ts : 0ull, is_cd[j] ? ts : 0ull};
#pragma unroll
    for (int L = 0; L < 3; ++L)
      if ((lvl[j] >> L) & 1) carry.st[L] = v[L];
    const unsigned long long pd = carry.st[0], rd = carry.st[1],
                             cd = carry.st[2];
    const unsigned long long del = rd < pd ? pd : rd;
    const unsigned long long cdel = del < cd ? cd : del;
    const bool is_pd = colv[j] == COL_PARTITION_DEL;
    const bool is_rd = colv[j] == COL_ROW_DEL;
    bool shadowed;
    if (!is_pd && !is_rd && !is_cd[j])
      shadowed = ts <= cdel;
    else if (is_rd)
      shadowed = ts <= pd;
    else if (is_cd[j])
      shadowed = ts <= del;
    else
      shadowed = false;

    const bool valid = (rc[j].w & R_VALID) != 0;
    const bool expiring = (rc[j].w & R_EXPIRING) != 0;
    const bool death = (rc[j].w & R_DEATH) != 0;
    bool expired = false, purged = false;
    if (expiring || death) {
      const int ldt = (int)rc[j].z;
      expired = expiring && ldt <= a.now;
      if ((death || expired) && ldt < a.gc_before)
        purged = ts < pair64(__ldg(in.purge_h + r), __ldg(in.purge_l + r));
    }
    const bool cell_new = (lvl[j] & 8) != 0;
    const bool keep = cell_new && valid && !shadowed && !purged;
    const bool ambiguous = !cell_new && same_ts[j] && valid;
    out[j] = (uint8_t)((keep ? 1 : 0) | (ambiguous ? 2 : 0) |
                       (expired ? 4 : 0) | (shadowed ? 8 : 0));
  }
  if (i0 + REC_ITEMS <= n && ((uintptr_t)(a.packed + i0) & 3) == 0) {
    *(uint32_t*)(a.packed + i0) = (uint32_t)out[0] | ((uint32_t)out[1] << 8) |
                                  ((uint32_t)out[2] << 16) |
                                  ((uint32_t)out[3] << 24);
  } else {
#pragma unroll
    for (int j = 0; j < REC_ITEMS; ++j)
      if (i0 + j < n) a.packed[i0 + j] = out[j];
  }
}

inline int rec_tiles_for(int n) { return (n + REC_TILE - 1) / REC_TILE; }

// the zeroed head of the scratch: the ticket, done, then a flag per tile
inline long rec_head_bytes(int n) {
  return ((long)(2 + rec_tiles_for(n)) * sizeof(unsigned) + 31) / 32 * 32;
}

}  // namespace

long reconcile_scratch_bytes(int n) {
  return rec_head_bytes(n) + 2L * rec_tiles_for(n) * (long)sizeof(Fill) +
         (long)n * sizeof(uint4);
}

void reconcile_seg(const RecIn& in, int K, const int* perm, int n,
                   int seg_len, int now, int gc_before, uint8_t* packed,
                   void* scratch, cudaStream_t s) {
  if (n <= 0) return;
  const int tiles = rec_tiles_for(n);
  const long head = rec_head_bytes(n);
  RecArgs a;
  a.in = in;
  a.perm = perm;
  a.packed = packed;
  a.ticket = (int*)scratch;
  a.done = (int*)scratch + 1;
  a.flag = (unsigned*)scratch + 2;
  a.agg = (Fill*)((char*)scratch + head);
  a.inc = a.agg + tiles;
  a.rec = (uint4*)(a.inc + tiles);
  a.K = K;
  a.n = n;
  a.n_pack = (n + PACK_ROWS - 1) / PACK_ROWS;
  a.seg_len = seg_len;
  a.now = now;
  a.gc_before = gc_before;
  cudaMemsetAsync(scratch, 0, head, s);
  rec_tiles<<<a.n_pack + tiles, REC_THREADS, 0, s>>>(a);
}

}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_reconcile_scratch_bytes(int n) {
  return reconcile_scratch_bytes(n);
}

// packed (u8[n]) receives the masks in sorted order.
extern "C" int ctpu_reconcile(const uint32_t* lanes, int K,
                              const uint32_t* ts_h, const uint32_t* ts_l,
                              const uint32_t* valid, const int* ldt,
                              const uint32_t* expiring,
                              const uint32_t* cdel, const uint32_t* death,
                              const uint32_t* purge_h,
                              const uint32_t* purge_l, int now,
                              int gc_before, const int* perm, int n,
                              uint8_t* packed, void* scratch,
                              void* stream) {
  RecIn in{lanes, ts_h, ts_l, valid, ldt, expiring, cdel, death,
           purge_h, purge_l};
  reconcile_seg(in, K, perm, n, n, now, gc_before, packed, scratch,
                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
