// K4: the META-block serializer of one full output segment.
//
// Replaces cassandra_tpu/ops/device_write.py `_meta_block_kernel`: the
// "ce" ts-delta over the biased (hi, lo) timestamp pairs (borrow from
// lo to hi; the first cell's "previous" is (2^31, 0), so its delta is
// its absolute stamp), the 25 B/cell META layout (sections in order:
// ts delta 8, ldt 4, ttl 4, flags 1, frame length 4, value offset 4,
// little-endian), and the segment stats: lexicographic min/max ts,
// min/max ldt and the tombstone count. The bytes must equal
// storage/sstable/writer.py `build_meta_block`.
//
// Bound on this card: bytes. Read once, the seven columns are 25 B/cell
// and the block is 25 B/cell: at n = 65,536 about 3.3 MB, 1 us at
// 3.35 TB/s. Design: one thread per cell writes its bytes into the six
// sections (word stores where the section is aligned, byte stores in the
// u32 sections after the flags when n is not a multiple of 4); the
// stats are warp reductions with one 64-bit atomic per warp into
// sentinels the caller filled (ts packed as (h << 32) | l, compared
// unsigned; ldt as signed 64-bit).
#include "common.cuh"

namespace ctpu {
namespace {

constexpr uint32_t BIAS_H = 0x80000000u;

__device__ __forceinline__ void put_u32(uint8_t* p, uint32_t v,
                                        bool aligned) {
  if (aligned) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    p[2] = (uint8_t)(v >> 16);
    p[3] = (uint8_t)(v >> 24);
  }
}

__global__ void meta_block(const uint32_t* ts_h, const uint32_t* ts_l,
                           const int* ldt, const int* ttl,
                           const uint8_t* flags, const uint32_t* fl,
                           const uint32_t* vr, int n, int death_mask,
                           uint8_t* out, unsigned long long* st) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  unsigned long long mn = ~0ull, mx = 0ull;
  long long lmn = 0x7fffffffffffffffll, lmx = -0x7fffffffffffffffll - 1;
  bool tomb = false;
  if (in) {
    const uint32_t h = ts_h[i], l = ts_l[i];
    const uint32_t ph = i ? ts_h[i - 1] : BIAS_H;
    const uint32_t pl = i ? ts_l[i - 1] : 0u;
    const uint32_t dl = l - pl;
    const uint32_t dh = h - ph - (l < pl ? 1u : 0u);
    const long ln = n;
    *reinterpret_cast<uint2*>(out + 8L * i) = make_uint2(dl, dh);
    const int ld = ldt[i];
    *reinterpret_cast<int*>(out + 8L * ln + 4L * i) = ld;
    *reinterpret_cast<int*>(out + 12L * ln + 4L * i) = ttl[i];
    const uint8_t f = flags[i];
    out[16L * ln + i] = f;
    const bool aligned = (n & 3) == 0;
    put_u32(out + 17L * ln + 4L * i, fl[i], aligned);
    put_u32(out + 21L * ln + 4L * i, vr[i], aligned);
    mn = mx = ((unsigned long long)h << 32) | l;
    lmn = lmx = ld;
    tomb = (f & death_mask) != 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_down_sync(0xffffffffu, mn, o);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, mx, o);
    const long long c = __shfl_down_sync(0xffffffffu, lmn, o);
    const long long d = __shfl_down_sync(0xffffffffu, lmx, o);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
    lmn = c < lmn ? c : lmn;
    lmx = d > lmx ? d : lmx;
  }
  const unsigned tombs = __popc(__ballot_sync(0xffffffffu, tomb));
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&st[0], mn);
    atomicMax(&st[1], mx);
    atomicMin(reinterpret_cast<long long*>(&st[2]), lmn);
    atomicMax(reinterpret_cast<long long*>(&st[3]), lmx);
    if (tombs) atomicAdd(&st[4], (unsigned long long)tombs);
  }
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

// out (u8[25 n]) receives the block; st (int64[5]) must hold the
// sentinels (u64 max, 0, i64 max, i64 min, 0) and receives min ts,
// max ts (packed (h << 32) | l), min ldt, max ldt, tombstones.
extern "C" int ctpu_meta_block(const uint32_t* ts_h, const uint32_t* ts_l,
                               const int* ldt, const int* ttl,
                               const uint8_t* flags, const uint32_t* fl,
                               const uint32_t* vr, int n, int death_mask,
                               uint8_t* out, unsigned long long* st,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  meta_block<<<grid_for(n, 256), 256, 0, s>>>(ts_h, ts_l, ldt, ttl, flags,
                                              fl, vr, n, death_mask, out,
                                              st);
  return (int)cudaGetLastError();
}
