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
// (K * 4 B), eight u32 columns, ldt and the permutation, and the output
// is 1 B: at N = 524,288 and K = 13 about 48 MB, 15 us at 3.35 TB/s.
// Design: each `associative_scan` forward-fill becomes an inclusive
// max-scan of `is_start ? i : 0` (the index of the segment's start),
// and the stamp is read at that start, so a fill costs one int32 scan
// instead of a scan over (hi, lo, flag) triples. Three launches and
// three scans: a boundary pass (reads rows i-1 and i through the
// permutation), the scans, and one elementwise pass that evaluates the
// rules at each sorted position. The rows are gathered through the
// permutation, not materialised in sorted order. `reconcile_seg` runs
// the same passes over equal segments (the mesh step K8, mesh.cu): the
// first row of every segment starts a partition and has no previous
// row, as row 0 of a round has, so a full segment never reads its
// neighbour's last row.
#include "common.cuh"

namespace ctpu {
namespace {

constexpr uint32_t COL_PARTITION_DEL = 0;
constexpr uint32_t COL_ROW_DEL = 1;

constexpr uint8_t B_PART = 1, B_ROW = 2, B_COL = 4, B_CELL = 8;

__global__ void rec_bounds(const uint32_t* lanes, int K, const int* perm,
                           int n, int seg_len, uint8_t* bnd, int* ps,
                           int* rs, int* cs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool part = true, row = true, col = true, cell = true;
  if (i % seg_len != 0) {
    const uint32_t* a = lanes + (long)perm[i] * K;
    const uint32_t* b = lanes + (long)perm[i - 1] * K;
    bool d_part = false, d_row = false, d_cell = false;
    for (int k = 0; k < 4; ++k) d_part |= a[k] != b[k];
    for (int k = 4; k < K - 3; ++k) d_row |= a[k] != b[k];
    const bool d_col = a[K - 3] != b[K - 3];
    for (int k = K - 2; k < K; ++k) d_cell |= a[k] != b[k];
    part = d_part;
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

__global__ void rec_final(RecIn in, int K, const int* perm, int n,
                          int seg_len, int now, int gc_before,
                          const uint8_t* bnd, const int* ps, const int* rs,
                          const int* cs, uint8_t* packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = perm[i];
  const uint32_t col = in.lanes[(long)p * K + K - 3];
  const uint32_t th = in.ts_h[p], tl = in.ts_l[p];
  const bool valid = in.valid[p] == 0;
  const int ldt = in.ldt[p];
  const bool expiring = in.expiring[p] == 1;
  const bool is_cd = in.cdel[p] == 1;
  const bool death = in.death[p] == 1;
  const bool cell_new = (bnd[i] & B_CELL) != 0;
  const bool is_pd = col == COL_PARTITION_DEL;
  const bool is_rd = col == COL_ROW_DEL;

  // forward-filled stamps: the value written at the segment's start
  const int sp = perm[ps[i]];
  const bool pd_at = in.lanes[(long)sp * K + K - 3] == COL_PARTITION_DEL;
  const uint32_t pd_h = pd_at ? in.ts_h[sp] : 0u;
  const uint32_t pd_l = pd_at ? in.ts_l[sp] : 0u;
  const int sr = perm[rs[i]];
  const bool rd_at = in.lanes[(long)sr * K + K - 3] == COL_ROW_DEL;
  const uint32_t rd_h = rd_at ? in.ts_h[sr] : 0u;
  const uint32_t rd_l = rd_at ? in.ts_l[sr] : 0u;
  const bool use_pd = lt_pair(rd_h, rd_l, pd_h, pd_l);
  const uint32_t del_h = use_pd ? pd_h : rd_h;
  const uint32_t del_l = use_pd ? pd_l : rd_l;
  const int sc = perm[cs[i]];
  const bool cd_at = in.cdel[sc] == 1;
  const uint32_t cd_h = cd_at ? in.ts_h[sc] : 0u;
  const uint32_t cd_l = cd_at ? in.ts_l[sc] : 0u;
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

  const bool expired = expiring && ldt <= now;
  const bool death_eff = death || expired;
  const bool purgeable = lt_pair(th, tl, in.purge_h[p], in.purge_l[p]);
  const bool purged = death_eff && ldt < gc_before && purgeable;
  const bool keep = cell_new && valid && !shadowed && !purged;

  bool same_ts = false;
  if (i % seg_len != 0) {
    const int q = perm[i - 1];
    same_ts = in.ts_h[q] == th && in.ts_l[q] == tl;
  }
  const bool ambiguous = !cell_new && same_ts && valid;
  packed[i] = (uint8_t)((keep ? 1 : 0) | (ambiguous ? 2 : 0) |
                        (expired ? 4 : 0) | (shadowed ? 8 : 0));
}

}  // namespace

long reconcile_scratch_bytes(int n) {
  // bnd (n bytes, padded to 16) + ps, rs, cs (int32[n] each) + scan
  const long bnd = ((long)n + 15) / 16 * 16;
  return bnd + (3L * n + scan_scratch_elems(n)) * (long)sizeof(int);
}

void reconcile_seg(const RecIn& in, int K, const int* perm, int n,
                   int seg_len, int now, int gc_before, uint8_t* packed,
                   void* scratch, cudaStream_t s) {
  uint8_t* bnd = (uint8_t*)scratch;
  int* ps = (int*)(bnd + ((long)n + 15) / 16 * 16);
  int* rs = ps + n;
  int* cs = rs + n;
  int* scan_scr = cs + n;
  const unsigned g = grid_for(n, 256);
  rec_bounds<<<g, 256, 0, s>>>(in.lanes, K, perm, n, seg_len, bnd, ps, rs,
                               cs);
  scan_max_inclusive(ps, ps, n, scan_scr, s);
  scan_max_inclusive(rs, rs, n, scan_scr, s);
  scan_max_inclusive(cs, cs, n, scan_scr, s);
  rec_final<<<g, 256, 0, s>>>(in, K, perm, n, seg_len, now, gc_before, bnd,
                              ps, rs, cs, packed);
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
