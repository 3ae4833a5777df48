// K9: the scan pushdown's predicate mask and aggregate fold.
//
// Replaces cassandra_tpu/ops/device_scan.py `_define_kernels`: the eight
// jitted predicate masks (eq, ne, lt, ge, gt, le, in, all) over u64 scan
// keys, and `_fold`, the count and the unsigned min / max of the keys
// under a mask. The JAX package carries each key as a (hi, lo) u32 pair
// only because jax defaults to 32-bit types; here a key is one native
// uint64_t (torch holds it as the int64 bit pattern) and compares as one.
//
// Bound on this card: bytes, and at the sizes the scan gives it, the
// host's cost of issuing a launch. The mask reads 8 B per key and
// writes 1 B (a 65,536-key segment is 0.59 MB, 0.18 us at 3.35 TB/s, far
// below a launch); the fold reads 9 B per key. So the scan does not
// launch per segment: it masks a run of consecutive device-gated
// segments of one source, up to 2^20 keys, with one launch
// (ops/device_scan.py `mask_run`: one pinned H2D copy of the keys, one
// D2H copy of the mask into pinned memory, one wait), and the wrappers
// keep their issue path lean (no device switch when the keys' device is
// current, the raw stream handle, no slice for an empty IN list: qlist
// may be null when m == 0). Design: the mask is one thread per key, the
// op a kernel parameter, the single bound passed by value and the IN
// list read from device memory (through the read-only cache; every
// thread walks it); one byte a key, which the host reads as numpy bools.
// The fold is a two-pass block reduction: each of at most FOLD_BLOCKS
// blocks folds a grid-stride slice into (count, min, max) with warp
// shuffles and writes its partial, then one block folds the partials.
// Sentinels: min starts at UINT64_MAX and max at 0, so an empty mask
// gives (0, UINT64_MAX, 0), as `_fold` does.
#include "common.cuh"

namespace ctpu {
namespace {

typedef unsigned long long u64;

// op codes: ops/device_scan.py SCAN_OPS
enum ScanOp { OP_EQ = 0, OP_NE, OP_LT, OP_GE, OP_GT, OP_LE, OP_IN, OP_ALL };

constexpr int MASK_THREADS = 256;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_BLOCKS = 264;  // two per SM

__global__ void __launch_bounds__(MASK_THREADS)
scan_mask(const u64* keys, int n, int op, u64 q0, const u64* qlist, int m,
          uint8_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 k = keys[i];
  bool r;
  switch (op) {
    case OP_EQ: r = k == q0; break;
    case OP_NE: r = k != q0; break;
    case OP_LT: r = k < q0; break;
    case OP_GE: r = k >= q0; break;
    case OP_GT: r = k > q0; break;
    case OP_LE: r = k <= q0; break;
    case OP_IN:
      r = false;
      for (int j = 0; j < m; ++j) r |= k == __ldg(qlist + j);
      break;
    default: r = true;
  }
  out[i] = r ? 1 : 0;
}

__device__ __forceinline__ void fold3(u64& c, u64& mn, u64& mx, u64 c2,
                                      u64 mn2, u64 mx2) {
  c += c2;
  mn = mn2 < mn ? mn2 : mn;
  mx = mx2 > mx ? mx2 : mx;
}

// Block-wide fold of (c, mn, mx); thread 0 holds the result.
__device__ __forceinline__ void block_fold(u64& c, u64& mn, u64& mx) {
  __shared__ u64 sc[32], smn[32], smx[32];
  for (int o = 16; o > 0; o >>= 1)
    fold3(c, mn, mx, __shfl_down_sync(0xffffffffu, c, o),
          __shfl_down_sync(0xffffffffu, mn, o),
          __shfl_down_sync(0xffffffffu, mx, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    sc[w] = c;
    smn[w] = mn;
    smx[w] = mx;
  }
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    c = lane < nw ? sc[lane] : 0ull;
    mn = lane < nw ? smn[lane] : ~0ull;
    mx = lane < nw ? smx[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1)
      fold3(c, mn, mx, __shfl_down_sync(0xffffffffu, c, o),
            __shfl_down_sync(0xffffffffu, mn, o),
            __shfl_down_sync(0xffffffffu, mx, o));
  }
}

__global__ void __launch_bounds__(FOLD_THREADS)
fold_partial(const u64* keys, const uint8_t* mask, int n, u64* part) {
  u64 c = 0, mn = ~0ull, mx = 0;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if (mask[i]) {
      const u64 k = keys[i];
      fold3(c, mn, mx, 1, k, k);
    }
  }
  block_fold(c, mn, mx);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = c;
    part[gridDim.x + blockIdx.x] = mn;
    part[2 * gridDim.x + blockIdx.x] = mx;
  }
}

__global__ void __launch_bounds__(FOLD_THREADS)
fold_final(const u64* part, int g, u64* out) {
  u64 c = 0, mn = ~0ull, mx = 0;
  for (int j = threadIdx.x; j < g; j += blockDim.x)
    fold3(c, mn, mx, part[j], part[g + j], part[2 * g + j]);
  block_fold(c, mn, mx);
  if (threadIdx.x == 0) {
    out[0] = c;
    out[1] = mn;
    out[2] = mx;
  }
}

int fold_blocks(int n) {
  const int g = (int)grid_for(n, FOLD_THREADS);
  return g < 1 ? 1 : (g > FOLD_BLOCKS ? FOLD_BLOCKS : g);
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

// out (u8[n]) receives 1 where keys[i] <op> the bound: q0 for the
// single-bound ops, any of qlist[0..m) for OP_IN (m = 0: none, and
// qlist may be null).
extern "C" int ctpu_scan_mask(const u64* keys, int n, int op, u64 q0,
                              const u64* qlist, int m, uint8_t* out,
                              void* stream) {
  if (n > 0)
    scan_mask<<<grid_for(n, MASK_THREADS), MASK_THREADS, 0,
                (cudaStream_t)stream>>>(keys, n, op, q0, qlist, m, out);
  return (int)cudaGetLastError();
}

extern "C" long ctpu_scan_fold_scratch_bytes(int n) {
  return 3L * fold_blocks(n) * (long)sizeof(u64);
}

// out (u64[3]) receives (count, min, max) of keys[i] where mask[i] != 0.
extern "C" int ctpu_scan_fold(const u64* keys, const uint8_t* mask, int n,
                              u64* out, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int g = fold_blocks(n);
  u64* part = (u64*)scratch;
  fold_partial<<<g, FOLD_THREADS, 0, s>>>(keys, mask, n, part);
  fold_final<<<1, FOLD_THREADS, 0, s>>>(part, g, out);
  return (int)cudaGetLastError();
}
