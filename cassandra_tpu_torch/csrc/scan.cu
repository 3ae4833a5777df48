// Device-wide int32 prefix scans (add exclusive, max inclusive).
//
// Replaces the scans that XLA generates inside the JAX programs: the
// `jax.lax.associative_scan` forward-fills of ops/merge.py
// _seg_carry_pair (as a max-scan of segment start indices), the
// per-digit offsets of the sort passes and the stable kept-first
// partition of ops/device_write.py _resident_program (as an exclusive
// add-scan of the keep flags).
//
// Bound on this card: bytes. A scan reads each input once and writes
// each output once (8 B/element, plus a few bytes per 4,096 elements
// for the block totals); at 524,288 elements that is 4.2 MB, about
// 1.3 us at 3.35 TB/s. Design: one pass over the data in tiles of
// 4,096 (1,024 threads x 4 consecutive items), warp shuffles for the
// in-block scan, the block totals scanned by the same routine, and
// one add-back pass. Simple and exact; the add-back re-reads the output
// (a second pass), which a decoupled look-back scan would avoid.
#include <climits>

#include "common.cuh"

namespace ctpu {
namespace {

struct AddOp {
  static __device__ __forceinline__ int id() { return 0; }
  static __device__ __forceinline__ int f(int a, int b) { return a + b; }
};

struct MaxOp {
  static __device__ __forceinline__ int id() { return INT_MIN; }
  static __device__ __forceinline__ int f(int a, int b) {
    return a > b ? a : b;
  }
};

template <class Op, bool EXCL>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(const int* in, int* out, long n, int* sums) {
  __shared__ int warp_tot[SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const long base = (long)blockIdx.x * SCAN_TILE + (long)tid * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int acc = Op::id();
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const long i = base + j;
    v[j] = i < n ? in[i] : Op::id();
    acc = Op::f(acc, v[j]);
  }
  // inclusive scan of the thread totals within the warp
  int x = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = Op::f(x, y);
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = Op::f(t, y);
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  int run = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) run = Op::id();
  if (w > 0) run = Op::f(warp_tot[w - 1], run);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const long i = base + j;
    if (EXCL) {
      if (i < n) out[i] = run;
      run = Op::f(run, v[j]);
    } else {
      run = Op::f(run, v[j]);
      if (i < n) out[i] = run;
    }
  }
  if (tid == 0 && sums != nullptr)
    sums[blockIdx.x] = warp_tot[SCAN_THREADS / 32 - 1];
}

template <class Op>
__global__ void add_back(int* out, long n, const int* carry) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const long b = i / SCAN_TILE;
    if (b > 0) out[i] = Op::f(carry[b], out[i]);
  }
}

template <class Op, bool EXCL>
void scan(const int* in, int* out, long n, int* scratch, cudaStream_t s) {
  if (n <= 0) return;
  const long nb = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (nb == 1) {
    scan_tiles<Op, EXCL><<<1, SCAN_THREADS, 0, s>>>(in, out, n, nullptr);
    return;
  }
  int* sums = scratch;
  scan_tiles<Op, EXCL><<<(unsigned)nb, SCAN_THREADS, 0, s>>>(in, out, n,
                                                             sums);
  // exclusive scan of the block totals gives each block its carry
  scan<Op, true>(sums, sums, nb, scratch + nb, s);
  add_back<Op><<<grid_for(n, 256), 256, 0, s>>>(out, n, sums);
}

}  // namespace

long scan_scratch_elems(long n) {
  long total = 0;
  while (n > 1) {
    n = (n + SCAN_TILE - 1) / SCAN_TILE;
    total += n + 1;
  }
  return total + 1;
}

void scan_add_exclusive(const int* in, int* out, long n, int* scratch,
                        cudaStream_t stream) {
  scan<AddOp, true>(in, out, n, scratch, stream);
}

void scan_max_inclusive(const int* in, int* out, long n, int* scratch,
                        cudaStream_t stream) {
  scan<MaxOp, false>(in, out, n, scratch, stream);
}

}  // namespace ctpu
