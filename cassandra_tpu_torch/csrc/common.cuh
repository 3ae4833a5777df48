// Shared declarations of the port's CUDA kernels (built by
// ops/cuda_lib.py into one shared library with a plain C interface).
//
// Every u32 lane of the JAX package arrives here as the bit pattern of
// an int32 torch tensor and is read as uint32_t; ldt, ttl, now and
// gc_before stay signed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ctpu {

// Device-wide prefix scans over int32 (scan.cu), shared by the radix
// passes' digit offsets (K6, K7, K10), the round sort's live/pad split
// (K1, K8), the reconcile's segment starts (K2) and the kept-first
// compaction (K3). Three phases: each block scans its tile
// in shared memory and writes its total, the totals are scanned by the
// same routine (recursively), and the carries are added back. In place
// (in == out) is allowed.
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr long SCAN_TILE = (long)SCAN_THREADS * SCAN_ITEMS;

// int32 elements of scratch either scan needs for n inputs.
long scan_scratch_elems(long n);
void scan_add_exclusive(const int* in, int* out, long n, int* scratch,
                        cudaStream_t stream);
void scan_max_inclusive(const int* in, int* out, long n, int* scratch,
                        cudaStream_t stream);

// Stable LSD radix sort of a permutation (sort.cu), the round sort's
// first design, now serving the plane programs (K6, K7) and K10's
// winner order. A key is one column read through the permutation: `width`
// bytes per element (1, 2 or 4) at p + row * stride elements, xor'd
// with `xmask` before its digits are taken (a descending key flips at
// its own width: xmask = its max). Each key costs `width` stable passes
// of 8-bit digits, three launches each.
struct SortKey {
  const void* p;
  int stride;
  int width;
  uint32_t xmask;
};

// Bytes of scratch radix_sort_perm needs for n rows.
long radix_scratch_bytes(int n);
// keys[0] is the LEAST significant; perm receives the permutation,
// perm_tmp (int32[n]) is work space.
void radix_sort_perm(const SortKey* keys, int nk, int n, int* perm,
                     int* perm_tmp, void* scratch, cudaStream_t stream);

// The round sort (sort.cu) of K1 and K8: the stable lexicographic sort
// over (valid, lanes[0..K-1], ~ts_h, ~ts_l) of S segments of N rows
// each (operands in row-major [S * N] order, lanes [S * N, K]), every
// segment sorted inside its own rows [s N, (s + 1) N). It runs one pass
// per key byte that varies among a segment's live rows (valid == 0) or
// among its pad rows, and no pass for a byte that does not.
struct RoundKeys {
  const uint32_t* lanes;
  const uint32_t* valid;
  const uint32_t* ts_h;
  const uint32_t* ts_l;
  int K;
};
// Bytes of scratch for S segments of N rows with K lanes: the packed
// varying bytes of a row can reach all 4 (K + 3) of its key bytes.
long round_sort_scratch_bytes(int S, int N, int K);
// perm (int32[S * N]) receives row indices of the whole array. One host
// sync (the plan's varying bytes and group sizes). info (host
// int64[2]): the passes run (the largest count of varying bytes of any
// (segment, group)) and the host ns of the plan's copy and sync.
cudaError_t round_sort_perm(const RoundKeys& key, int S, int N, int* perm,
                            void* scratch, cudaStream_t stream,
                            long long* info);

// The reconcile of K2 (reconcile.cu) over a sort permutation of n rows
// in segments of seg_len rows: a segment's first row starts a
// partition whatever its lanes (seg_len = n for one round; the mesh
// step's shards for K8). packed (u8[n]) receives the masks in sorted
// order.
struct RecIn {
  const uint32_t* lanes;
  const uint32_t* ts_h;
  const uint32_t* ts_l;
  const uint32_t* valid;
  const int* ldt;
  const uint32_t* expiring;
  const uint32_t* cdel;
  const uint32_t* death;
  const uint32_t* purge_h;
  const uint32_t* purge_l;
};
long reconcile_scratch_bytes(int n);
void reconcile_seg(const RecIn& in, int K, const int* perm, int n,
                   int seg_len, int now, int gc_before, uint8_t* packed,
                   void* scratch, cudaStream_t stream);

inline unsigned grid_for(long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Unsigned 64-bit pair compares over (hi, lo) u32 halves.
__device__ __forceinline__ bool lt_pair(uint32_t ah, uint32_t al,
                                        uint32_t bh, uint32_t bl) {
  return (ah < bh) || (ah == bh && al < bl);
}

__device__ __forceinline__ bool le_pair(uint32_t ah, uint32_t al,
                                        uint32_t bh, uint32_t bl) {
  return (ah < bh) || (ah == bh && al <= bl);
}

}  // namespace ctpu
