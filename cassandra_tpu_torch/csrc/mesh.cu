// K8: the token-range-sharded merge step of a mesh, all shards of one
// card in one launch sequence.
//
// Replaces cassandra_tpu/parallel/mesh.py `sharded_merge_step` (the
// `jax.jit(jax.shard_map(...))` at mesh.py:179, its `psum` at :167) and
// the per-shard program `_shard_merge_program` (:194). The operands are
// shard_batch's [S, N] arrays: S token-range shards, each padded to the
// same power-of-two N (padding rows: valid = 1, lanes 0xFFFFFFFF). Per
// shard, K1's stable lexicographic sort over (valid, lanes, ~ts_h,
// ~ts_l), then K2's reconcile; then the (kept, dropped) stats of every
// shard and their sum over the shards, where kept = sum(packed & 1) and
// dropped = sum(valid == 0) - kept.
//
// Bound on this card: bytes. Read once, the operands are (4 K + 36) B
// per row and perm and packed 5 B written: at S = 4, N = 2^22 and
// K = 13 about 1.5 GB, 0.46 ms at 3.35 TB/s. The sort held the first
// design far above it: all 4 (K + 3) key bytes were radix passes
// of three launches each, every pass reading its byte through the
// permutation twice. The sort is now sort.cu's round sort (the note
// there), which runs one single-kernel pass per key byte that varies
// among a shard's live rows, and none for its padding rows, and never
// waits for the device.
//
// Design: one sort and one reconcile over the flat S * N rows, with the
// shards as segments, so a card runs its shards in the launches one
// round takes and not S times as many.
//   - Sort: round_sort_perm with the shards as segments. Its ranges are
//     (shard, live or pad), with the lengths its plan returned, so tiles
//     never cross a range's edge, and each range's rows land inside
//     [s N, (s + 1) N). No pass is spent on a shard id.
//   - Reconcile: reconcile.cu's one tiled kernel (after its memset) with
//     a partition start forced at every s N. A full shard (N live rows)
//     has no padding row after it, so its first row must not be compared
//     with the previous shard's last: the segment start is forced, not
//     read from lane differences.
//   - Stats: one pass over each shard's rows turns the sort's row
//     indices into shard-local ones and counts kept and live rows
//     (block reduction, one int64 atomic per block into [S, 2]); a
//     second, one-thread pass turns live into dropped and sums the
//     shards into int64[2]. Several cards each run their own shards;
//     the host sums their pairs (the psum).
#include "common.cuh"

namespace ctpu {
namespace {

constexpr int STAT_THREADS = 256;

__global__ void __launch_bounds__(STAT_THREADS)
shard_stats(const int* gperm, const uint8_t* packed, const uint32_t* valid,
            int N, int* perm_out, unsigned long long* stats_s) {
  __shared__ unsigned long long warp_kept[STAT_THREADS / 32];
  __shared__ unsigned long long warp_live[STAT_THREADS / 32];
  const int s = blockIdx.y;
  const long base = (long)s * N;
  unsigned long long kept = 0, live = 0;
  for (long r = (long)blockIdx.x * STAT_THREADS + threadIdx.x; r < N;
       r += (long)gridDim.x * STAT_THREADS) {
    const long i = base + r;
    perm_out[i] = (int)(gperm[i] - base);
    kept += packed[i] & 1;
    live += valid[i] == 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kept += __shfl_down_sync(0xffffffffu, kept, o);
    live += __shfl_down_sync(0xffffffffu, live, o);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    warp_kept[w] = kept;
    warp_live[w] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long k = 0, l = 0;
    for (int j = 0; j < STAT_THREADS / 32; ++j) {
      k += warp_kept[j];
      l += warp_live[j];
    }
    atomicAdd(&stats_s[2 * s], k);
    atomicAdd(&stats_s[2 * s + 1], l);
  }
}

// [S, 2] (kept, live) -> (kept, dropped) in place, and their sum.
__global__ void sum_stats(long long* stats_s, int S, long long* stats) {
  long long kept = 0, dropped = 0;
  for (int s = 0; s < S; ++s) {
    stats_s[2 * s + 1] -= stats_s[2 * s];
    kept += stats_s[2 * s];
    dropped += stats_s[2 * s + 1];
  }
  stats[0] = kept;
  stats[1] = dropped;
}

long sort_part_bytes(int S, int N, int K) {
  const long a = round_sort_scratch_bytes(S, N, 4 * (K + 3));
  const long b = reconcile_scratch_bytes(S * N);
  return ((a > b ? a : b) + 15) / 16 * 16;
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

// The global permutation (int32[S * N]), then the sort's or the
// reconcile's scratch (one after the other, so they share it).
extern "C" long ctpu_mesh_scratch_bytes(int S, int N, int K) {
  return ((long)S * N * (long)sizeof(int) + 15) / 16 * 16
         + sort_part_bytes(S, N, K);
}

// Operands are [S, N] (lanes [S, N, K]) in row-major order. perm
// (int32[S, N]) receives shard-local sort permutations, packed
// (u8[S, N]) the masks in each shard's sorted order, stats_s
// (int64[S, 2]) each shard's (kept, dropped) and stats (int64[2]) their
// sum. passes (device int32[1]) receives the sort's passes run. Returns
// without waiting for the device.
extern "C" int ctpu_mesh_step(const uint32_t* lanes, int K,
                              const uint32_t* valid, const uint32_t* ts_h,
                              const uint32_t* ts_l, const int* ldt,
                              const uint32_t* expiring,
                              const uint32_t* cdel, const uint32_t* death,
                              const uint32_t* purge_h,
                              const uint32_t* purge_l, int now,
                              int gc_before, int S, int N, int* perm,
                              uint8_t* packed, long long* stats_s,
                              long long* stats, void* scratch,
                              void* stream, int* passes) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = S * N;
  int* gperm = (int*)scratch;
  void* work = (char*)scratch + ((long)n * sizeof(int) + 15) / 16 * 16;
  const RoundKey key = lanes_key(lanes, K, valid, ts_h, ts_l);
  const cudaError_t err = round_sort_perm(key, S, N, gperm, work, s, passes);
  if (err != cudaSuccess) return (int)err;
  RecIn in{lanes, ts_h, ts_l, valid, ldt, expiring, cdel, death,
           purge_h, purge_l};
  reconcile_seg(in, K, gperm, n, N, now, gc_before, packed, work, s);
  cudaMemsetAsync(stats_s, 0, 2L * S * sizeof(long long), s);
  const int per_shard = (int)((N + STAT_THREADS * 8L - 1)
                              / (STAT_THREADS * 8L));
  const dim3 grid(per_shard < 1024 ? per_shard : 1024, S);
  shard_stats<<<grid, STAT_THREADS, 0, s>>>(
      gperm, packed, valid, N, perm, (unsigned long long*)stats_s);
  sum_stats<<<1, 1, 0, s>>>(stats_s, S, stats);
  return (int)cudaGetLastError();
}
