// K3: the kept-first compaction and column gather of a resident round.
//
// Replaces the tail of cassandra_tpu/ops/device_write.py
// `_resident_program` (after the sort and the reconcile, which are K1
// and K2): the counts n_keep, n_amb and n_exp_kept; the stable
// partition that moves the kept cells to the front in sorted order
// (a second stable sort in the JAX package); and the gather of the
// eight RESIDENT_COLS through the resulting permutation.
//
// Bound on this card: bytes. Read once, the inputs are perm and packed
// (5 B/row) and the eight columns (K * 4 + 6 * 4 + 1 B/row); the
// outputs are perm_out and the gathered columns: at N = 524,288 and
// K = 13 about 85 MB, 25 us at 3.35 TB/s. Design: the stable partition
// is a stream compaction: an exclusive add-scan of the keep flags gives
// each kept cell its slot (prefix[i]) and each dropped cell
// n_keep + i - prefix[i], so one scatter places perm and one gather
// (thread per output row) moves the columns. The counts are block
// reductions (`__syncthreads_count`) with one atomic per block.
#include "common.cuh"

namespace ctpu {
namespace {

__global__ void cmp_flags(const uint8_t* packed, int n, int* keepi,
                          int* counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = i < n ? packed[i] : 0;
  const int keep = b & 1;
  if (i < n) keepi[i] = keep;
  const int c_keep = __syncthreads_count(keep);
  const int c_amb = __syncthreads_count(b & 2);
  const int c_exp = __syncthreads_count(keep && (b & 4));
  if (threadIdx.x == 0) {
    if (c_keep) atomicAdd(&counts[0], c_keep);
    if (c_amb) atomicAdd(&counts[1], c_amb);
    if (c_exp) atomicAdd(&counts[2], c_exp);
  }
}

__global__ void cmp_scatter(const int* perm, const int* keepi,
                            const int* prefix, const int* counts, int n,
                            int* perm_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int dest = keepi[i] ? prefix[i] : counts[0] + i - prefix[i];
  perm_out[dest] = perm[i];
}

struct Cols {
  const uint32_t* lanes;
  const uint32_t* ts_h;
  const uint32_t* ts_l;
  const int* ldt;
  const int* ttl;
  const uint8_t* flags8;
  const uint32_t* fl;
  const uint32_t* vr;
};

struct ColsOut {
  uint32_t* lanes;
  uint32_t* ts_h;
  uint32_t* ts_l;
  int* ldt;
  int* ttl;
  uint8_t* flags8;
  uint32_t* fl;
  uint32_t* vr;
};

__global__ void cmp_gather(Cols in, ColsOut out, int K, const int* perm_out,
                           int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int p = perm_out[j];
  const uint32_t* src = in.lanes + (long)p * K;
  uint32_t* dst = out.lanes + (long)j * K;
  for (int k = 0; k < K; ++k) dst[k] = src[k];
  out.ts_h[j] = in.ts_h[p];
  out.ts_l[j] = in.ts_l[p];
  out.ldt[j] = in.ldt[p];
  out.ttl[j] = in.ttl[p];
  out.flags8[j] = in.flags8[p];
  out.fl[j] = in.fl[p];
  out.vr[j] = in.vr[p];
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_compact_scratch_bytes(int n) {
  // keep flags and their prefix (int32[n] each) + scan
  return (2L * n + scan_scratch_elems(n)) * (long)sizeof(int);
}

// counts (int32[3], zeroed by the caller) receives n_keep, n_amb and
// n_exp_kept; perm_out (int32[n]) the kept-first permutation; the
// *_out columns the gathered rows.
extern "C" int ctpu_compact_gather(
    const int* perm, const uint8_t* packed, int n, int K,
    const uint32_t* lanes, const uint32_t* ts_h, const uint32_t* ts_l,
    const int* ldt, const int* ttl, const uint8_t* flags8,
    const uint32_t* fl, const uint32_t* vr, int* counts, int* perm_out,
    uint32_t* lanes_o, uint32_t* ts_h_o, uint32_t* ts_l_o, int* ldt_o,
    int* ttl_o, uint8_t* flags8_o, uint32_t* fl_o, uint32_t* vr_o,
    void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* keepi = (int*)scratch;
  int* prefix = keepi + n;
  int* scan_scr = prefix + n;
  const unsigned g = grid_for(n, 256);
  cmp_flags<<<g, 256, 0, s>>>(packed, n, keepi, counts);
  scan_add_exclusive(keepi, prefix, n, scan_scr, s);
  cmp_scatter<<<g, 256, 0, s>>>(perm, keepi, prefix, counts, n, perm_out);
  Cols in{lanes, ts_h, ts_l, ldt, ttl, flags8, fl, vr};
  ColsOut out{lanes_o, ts_h_o, ts_l_o, ldt_o, ttl_o, flags8_o, fl_o, vr_o};
  cmp_gather<<<g, 256, 0, s>>>(in, out, K, perm_out, n);
  return (int)cudaGetLastError();
}
