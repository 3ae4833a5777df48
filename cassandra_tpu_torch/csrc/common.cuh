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

// Device-wide prefix scans over int32 (scan.cu), shared by the sort's
// digit offsets (K1), the reconcile's segment starts (K2) and the
// kept-first compaction (K3). Three phases: each block scans its tile
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
