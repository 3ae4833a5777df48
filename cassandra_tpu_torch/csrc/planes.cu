// K6 and K7: the plane programs of a non-resident merge round.
//
// K6 replaces cassandra_tpu/ops/merge.py `_plane_program_fast` (v3,
// truncated-key planes): a stable LSD sort over range-shrunk u8 / u16 /
// u32 planes sliced from one u8 buffer (the partition rank, the varying
// clustering / path lanes, the pre-flipped truncated timestamp), then
// per sorted row the identity boundary against row i-1, the same
// truncated stamp, keep / ambiguous, and the source run of the row
// (searchsorted(offsets, perm, 'right') - 1, over at most 16 offsets):
// one u8 per row, bits 0-3 run, bit 4 keep, bit 5 ambiguous.
//
// K7 replaces `_plane_lsd_sort`, `_plane_reconcile` and `_plane_program`
// (v2 planes): a stable sort over the u32 rank, the varying u32 lanes
// and the timestamp planes ts_lo u32, ts_mid u16 and [ts_hi u16]
// descending; the partition / row / column / cell boundaries; the three
// (hi, lo) forward-fills of partition, row and complex deletion stamps;
// shadowing and the equal-(identity, ts) ambiguity flag (expiry and
// purge are the host's post-pass). One u32 per row:
// (keep | ambiguous << 1 | shadowed << 3) << 24 | perm.
//
// Bound on this card: bytes. Read once, a K6 round is its buffer
// (5-8 B/row on the stcs rounds) plus 1 B/row out, at N = 524,288 about
// 4-5 MB, 1.3 us at 3.35 TB/s; K7 reads 14-20 B/row and writes 4. The
// design moves far more: each byte of key is one radix pass that
// gathers the key through the permutation twice (histogram, scatter)
// and rewrites the permutation, as in K1 (sort.cu, whose passes these
// programs share). A plane's width decides its passes, so K6 sorts an
// stcs round in about 8 passes where K1 takes 64. Skipping digits that
// are constant in a round is later work.
//
// The tails: K6 is one pass over the sorted rows (a row reads its
// predecessor through the permutation; the run offsets sit in shared
// memory). K7 is K2's structure (reconcile.cu): a boundary pass that
// writes `is_start ? i : 0` per fill, three inclusive max-scans
// (scan.cu) that turn them into segment starts, and a final pass that
// reads each stamp at its segment's start.
#include "common.cuh"

namespace ctpu {
namespace {

constexpr int MAX_PLANES = 64;
constexpr int MAX_RUNS = 15;
constexpr uint32_t COL_PARTITION_DEL = 0;
constexpr uint32_t COL_ROW_DEL = 1;
constexpr uint8_t B_PART = 1, B_ROW = 2, B_COL = 4, B_CELL = 8;

struct Planes {
  const void* p[MAX_PLANES];
  int width[MAX_PLANES];
};

__device__ __forceinline__ uint32_t load(const void* p, int width, int i) {
  if (width == 4) return static_cast<const uint32_t*>(p)[i];
  if (width == 2) return static_cast<const uint16_t*>(p)[i];
  return static_cast<const uint8_t*>(p)[i];
}

// ---------------------------------------------------------------- K6 --

// planes: [rank, lane 0..n_lanes-1, q 0..n_q-1]
__global__ void fast_tail(Planes pl, int n_lanes, int n_q,
                          uint32_t sentinel, const int* offsets, int k,
                          const int* perm, int n, uint8_t* out) {
  __shared__ int offs[MAX_RUNS + 1];
  if (threadIdx.x <= k) offs[threadIdx.x] = offsets[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = perm[i];
  const uint32_t rank = load(pl.p[0], pl.width[0], p);
  const bool valid = rank != sentinel;
  bool cell_new = true, same_q = false;
  if (i > 0) {
    const int q = perm[i - 1];
    cell_new = rank != load(pl.p[0], pl.width[0], q);
    for (int j = 1; j <= n_lanes && !cell_new; ++j)
      cell_new = load(pl.p[j], pl.width[j], p) !=
                 load(pl.p[j], pl.width[j], q);
    same_q = true;
    for (int j = 1 + n_lanes; j <= n_lanes + n_q && same_q; ++j)
      same_q = load(pl.p[j], pl.width[j], p) ==
               load(pl.p[j], pl.width[j], q);
  }
  const bool keep = cell_new && valid;
  const bool amb = !cell_new && same_q && valid;
  int src = -1;                       // entries of offsets <= p, minus 1
  for (int j = 0; j <= k; ++j) src += offs[j] <= p;
  out[i] = (uint8_t)(src | (keep ? 0x10 : 0) | (amb ? 0x20 : 0));
}

// ---------------------------------------------------------------- K7 --

struct V2 {
  const uint32_t* rank;
  const uint32_t* lane[MAX_PLANES];
  int n_row, n_col, n_path;
  const uint32_t* ts_lo;
  const uint16_t* ts_mid;
  const uint16_t* ts_hi;   // null: hi_const
  uint32_t hi_const;
  const uint8_t* cdel;     // null: no complex deletions
  uint32_t col_const;
};

__device__ __forceinline__ uint32_t col_of(const V2& v, int p) {
  return v.n_col ? v.lane[v.n_row][p] : v.col_const;
}

__device__ __forceinline__ uint32_t ts_h_of(const V2& v, int p) {
  const uint32_t hi = v.ts_hi != nullptr ? v.ts_hi[p] : v.hi_const;
  return (hi << 16) | v.ts_mid[p];
}

__device__ __forceinline__ bool cd_of(const V2& v, int p) {
  return v.cdel != nullptr && v.cdel[p] == 1;
}

__global__ void v2_bounds(V2 v, const int* perm, int n, uint8_t* bnd,
                          int* ps, int* rs, int* cs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool part = true, row = true, col = true, cell = true;
  if (i > 0) {
    const int p = perm[i], q = perm[i - 1];
    part = v.rank[p] != v.rank[q];
    bool d_row = false, d_col = false, d_cell = false;
    for (int j = 0; j < v.n_row; ++j) d_row |= v.lane[j][p] != v.lane[j][q];
    if (v.n_col) d_col = v.lane[v.n_row][p] != v.lane[v.n_row][q];
    for (int j = v.n_row + v.n_col; j < v.n_row + v.n_col + v.n_path; ++j)
      d_cell |= v.lane[j][p] != v.lane[j][q];
    row = part || d_row;
    col = row || d_col;
    cell = col || d_cell;
  }
  bnd[i] = (part ? B_PART : 0) | (row ? B_ROW : 0) | (col ? B_COL : 0) |
           (cell ? B_CELL : 0);
  ps[i] = part ? i : 0;
  rs[i] = row ? i : 0;
  cs[i] = col ? i : 0;
}

__global__ void v2_final(V2 v, const int* perm, int n, const uint8_t* bnd,
                         const int* ps, const int* rs, const int* cs,
                         uint32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = perm[i];
  const uint32_t col = col_of(v, p);
  const uint32_t th = ts_h_of(v, p), tl = v.ts_lo[p];
  const bool valid = v.rank[p] != 0xffffffffu;
  const bool is_cd = cd_of(v, p);
  const bool cell_new = (bnd[i] & B_CELL) != 0;
  const bool is_pd = col == COL_PARTITION_DEL;
  const bool is_rd = col == COL_ROW_DEL;

  // forward-filled stamps: the value written at the segment's start
  const int sp = perm[ps[i]];
  const bool pd_at = col_of(v, sp) == COL_PARTITION_DEL;
  const uint32_t pd_h = pd_at ? ts_h_of(v, sp) : 0u;
  const uint32_t pd_l = pd_at ? v.ts_lo[sp] : 0u;
  const int sr = perm[rs[i]];
  const bool rd_at = col_of(v, sr) == COL_ROW_DEL;
  const uint32_t rd_h = rd_at ? ts_h_of(v, sr) : 0u;
  const uint32_t rd_l = rd_at ? v.ts_lo[sr] : 0u;
  const bool use_pd = lt_pair(rd_h, rd_l, pd_h, pd_l);
  const uint32_t del_h = use_pd ? pd_h : rd_h;
  const uint32_t del_l = use_pd ? pd_l : rd_l;
  const int sc = perm[cs[i]];
  const bool cd_at = cd_of(v, sc);
  const uint32_t cd_h = cd_at ? ts_h_of(v, sc) : 0u;
  const uint32_t cd_l = cd_at ? v.ts_lo[sc] : 0u;
  const bool use_cd = lt_pair(del_h, del_l, cd_h, cd_l);
  const uint32_t cdel_h = use_cd ? cd_h : del_h;
  const uint32_t cdel_l = use_cd ? cd_l : del_l;

  const bool plain = !is_pd && !is_rd && !is_cd;
  bool shadowed;
  if (plain)
    shadowed = le_pair(th, tl, cdel_h, cdel_l);
  else if (is_rd)
    shadowed = le_pair(th, tl, pd_h, pd_l);
  else if (is_cd)
    shadowed = le_pair(th, tl, del_h, del_l);
  else
    shadowed = false;

  const bool keep = cell_new && valid && !shadowed;
  bool same_ts = false;
  if (i > 0) {
    const int q = perm[i - 1];
    same_ts = ts_h_of(v, q) == th && v.ts_lo[q] == tl;
  }
  const bool ambiguous = !cell_new && same_ts && valid;
  const uint32_t m = (keep ? 1u : 0u) | (ambiguous ? 2u : 0u) |
                     (shadowed ? 8u : 0u);
  out[i] = (m << 24) | (uint32_t)p;
}

long tail_bytes(int n) {
  // bnd (n bytes, padded to 16) + ps, rs, cs (int32[n] each) + scan
  const long bnd = ((long)n + 15) / 16 * 16;
  return bnd + (3L * n + scan_scratch_elems(n)) * (long)sizeof(int);
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_planes_scratch_bytes(int n) {
  const long a = radix_scratch_bytes(n), b = tail_bytes(n);
  return a > b ? a : b;
}

// K6. buf holds the planes [rank, lanes, q planes] of `widths` (1, 2 or
// 4 bytes each; 1 + n_lanes + n_q of them), each N rows, back to back,
// then the int32 run offsets (k + 1 of them). out (u8[N]) receives the
// per-row byte; perm, perm_tmp (int32[N]) and scratch
// (ctpu_planes_scratch_bytes(N)) are work space.
extern "C" int ctpu_plane_fast(const uint8_t* buf, int N, int n_lanes,
                               int n_q, const int* widths, int k,
                               uint8_t* out, int* perm, int* perm_tmp,
                               void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int np = 1 + n_lanes + n_q;
  if (np > MAX_PLANES || k > MAX_RUNS) return (int)cudaErrorInvalidValue;
  Planes pl;
  long off = 0;
  for (int j = 0; j < np; ++j) {
    pl.p[j] = buf + off;
    pl.width[j] = widths[j];
    off += (long)N * widths[j];
  }
  const int* offsets = reinterpret_cast<const int*>(buf + off);
  // least significant first: q planes (pre-flipped: ascending is ts
  // descending) last to first, lanes last to first, then the rank
  SortKey keys[MAX_PLANES];
  int nk = 0;
  for (int j = np - 1; j >= 0; --j)
    keys[nk++] = {pl.p[j], 1, pl.width[j], 0u};
  radix_sort_perm(keys, nk, N, perm, perm_tmp, scratch, s);
  const uint32_t sentinel = widths[0] == 4   ? 0xffffffffu
                            : widths[0] == 2 ? 0xffffu
                                             : 0xffu;
  fast_tail<<<grid_for(N, 256), 256, 0, s>>>(pl, n_lanes, n_q, sentinel,
                                             offsets, k, perm, N, out);
  return (int)cudaGetLastError();
}

// K7. lanes: n_row + n_col + n_path u32 planes (a host array of device
// pointers); ts_hi and cdel may be null (hi_const, no complex
// deletions). out (u32[N]) receives (masks << 24) | perm; perm,
// perm_tmp (int32[N]) and scratch (ctpu_planes_scratch_bytes(N)) are
// work space.
extern "C" int ctpu_plane_v2(const uint32_t* rank, const uint32_t* const* lanes,
                             int n_row, int n_col, int n_path,
                             const uint32_t* ts_lo, const uint16_t* ts_mid,
                             const uint16_t* ts_hi, uint32_t hi_const,
                             const uint8_t* cdel, uint32_t col_const, int N,
                             uint32_t* out, int* perm, int* perm_tmp,
                             void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nl = n_row + n_col + n_path;
  if (nl > MAX_PLANES) return (int)cudaErrorInvalidValue;
  V2 v;
  v.rank = rank;
  for (int j = 0; j < nl; ++j) v.lane[j] = lanes[j];
  v.n_row = n_row;
  v.n_col = n_col;
  v.n_path = n_path;
  v.ts_lo = ts_lo;
  v.ts_mid = ts_mid;
  v.ts_hi = ts_hi;
  v.hi_const = hi_const;
  v.cdel = cdel;
  v.col_const = col_const;
  // least significant first: ~ts_lo, ~ts_mid, [~ts_hi], lanes last to
  // first, then the rank (padding rows carry rank 0xFFFFFFFF)
  SortKey keys[MAX_PLANES + 4];
  int nk = 0;
  keys[nk++] = {ts_lo, 1, 4, 0xffffffffu};
  keys[nk++] = {ts_mid, 1, 2, 0xffffu};
  if (ts_hi != nullptr) keys[nk++] = {ts_hi, 1, 2, 0xffffu};
  for (int j = nl - 1; j >= 0; --j) keys[nk++] = {lanes[j], 1, 4, 0u};
  keys[nk++] = {rank, 1, 4, 0u};
  radix_sort_perm(keys, nk, N, perm, perm_tmp, scratch, s);
  uint8_t* bnd = (uint8_t*)scratch;
  int* ps = (int*)(bnd + ((long)N + 15) / 16 * 16);
  int* rs = ps + N;
  int* cs = rs + N;
  int* scan_scr = cs + N;
  const unsigned g = grid_for(N, 256);
  v2_bounds<<<g, 256, 0, s>>>(v, perm, N, bnd, ps, rs, cs);
  scan_max_inclusive(ps, ps, N, scan_scr, s);
  scan_max_inclusive(rs, rs, N, scan_scr, s);
  scan_max_inclusive(cs, cs, N, scan_scr, s);
  v2_final<<<g, 256, 0, s>>>(v, perm, N, bnd, ps, rs, cs, out);
  return (int)cudaGetLastError();
}
