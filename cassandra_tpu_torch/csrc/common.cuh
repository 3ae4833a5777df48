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

// Device-wide prefix scans over int32 (scan.cu), shared by K10's
// select path, the round sort's live/pad split (K1, K6, K7, K8), K7's
// segment starts and the kept-first compaction (K3). Three phases: each block scans its tile
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

// One plane of a sort key: `width` bytes per element (1, 2 or 4) at
// p + row * stride elements, xor'd with `xmask` before its bytes are
// taken (a descending key flips at its own width: xmask = its max).
struct KeyPlane {
  const void* p;
  int stride;
  int width;
  uint32_t xmask;
};

// The key of the round sort (sort.cu), shared by K1, the mesh step K8
// (mesh.cu), the plane programs K6 and K7 (planes.cu) and K10's select
// path (ann.cu): up to
// MAX_KEY_PLANES planes, most significant first. Its `bytes` bytes,
// most significant first, are plane 0's (high to low), then plane 1's,
// and so on: byte b is plane byte_at[b] >> 5, shifted right by
// byte_at[b] & 31. A row is live when plane 0's value (after its xmask)
// is below live_below, else padding: K1's and K8's plane 0 is `valid`
// (live iff 0: live_below = 1), K6's and K7's the partition rank, whose
// padding rows hold the all-ones sentinel of its width (live_below =
// the sentinel). Plane 0 is the most significant key, so every padding
// row sorts after every live row. Passed to the kernels by value.
constexpr int MAX_KEY_PLANES = 68;
constexpr int MAX_KEY_BYTES = 4 * MAX_KEY_PLANES;
struct RoundKey {
  KeyPlane pl[MAX_KEY_PLANES];
  int np;
  int bytes;
  uint32_t live_below;
  uint16_t byte_at[MAX_KEY_BYTES];
  uint16_t first_byte[MAX_KEY_PLANES];
};
// An empty key with the given group threshold; round_key_add appends a
// plane (the caller keeps to MAX_KEY_PLANES).
RoundKey round_key(uint32_t live_below);
void round_key_add(RoundKey& key, const void* p, int stride, int width,
                   uint32_t xmask);
// K1's and K8's key over S * N rows: (valid, lanes[0..K-1], ~ts_h,
// ~ts_l), lanes row-major [S * N, K].
RoundKey lanes_key(const uint32_t* lanes, int K, const uint32_t* valid,
                   const uint32_t* ts_h, const uint32_t* ts_l);

// The round sort: the stable lexicographic sort of S segments of N rows
// each (operands in row-major [S * N] order), every segment sorted
// inside its own rows [s N, (s + 1) N). It runs one pass per key byte
// that varies among a segment's live rows or among its pad rows, and no
// pass for a byte that does not. Bytes of scratch for a key of B bytes
// (the packed varying bytes of a row can reach all B):
long round_sort_scratch_bytes(int S, int N, int B);
// perm (int32[S * N]) receives row indices of the whole array. The
// whole sort is enqueued on `stream` and nothing waits for the device:
// the plan, the table of passes and each pass's extent stay on the
// card, and the host launches `key.bytes` passes (one CUDA graph), of
// which those past the plan's count exit at once. passes (device
// int32[1]) receives the passes run: the most varying bytes of any
// (segment, group).
cudaError_t round_sort_perm(const RoundKey& key, int S, int N, int* perm,
                            void* scratch, cudaStream_t stream,
                            int* passes);

// The reconcile of K2 (reconcile.cu) over a sort permutation of n rows
// in segments of seg_len rows: a segment's first row starts a
// partition whatever its lanes (seg_len = n for one round; the mesh
// step's shards for K8). packed (u8[n]) receives the masks in sorted
// order. One memset of the scratch's head and one kernel; the scratch
// (reconcile_scratch_bytes) belongs to the call.
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
