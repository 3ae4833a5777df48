// K10: exact vector search, the scores of every row and their top k.
//
// Replaces cassandra_tpu/index/manager.py `VectorIndex.ann`: one
// matrix-vector product (cosine over normalised rows, dot, or the
// negative squared L2 distance) and `lax.top_k`, which orders by score,
// higher first, and puts the lower index first among equal scores.
//
// Bound on this card: bytes. The matrix is read once, n * d * 4 B: at
// 1,000,000 x 128 that is 512 MB, 153 us at 3.35 TB/s, against 2 n d
// floating-point operations (4 us at 67 TFLOP/s).
//
// Scores. One warp per row: lane j takes the row's float4 chunks j, j +
// 32, ... (floats when d is not a multiple of 4 or a pointer is not
// 16-byte aligned), sums them in order, and the lanes' sums meet in an
// xor-shuffle tree (`lane_add4`, `lane_add1`, `row_finish`: one
// definition serves both paths below, with every rounding explicit, so
// the two paths' scores are bit-equal). Cosine takes the row's norm from
// the same read (the JAX package normalises the whole matrix on the
// host first); the caller divides q by its norm, as the JAX package
// does. Euclidean is -sum((x - q)^2). -0.0 becomes +0.0.
//
// Order. A row's score and index pack into one 64-bit composite,
// (order_key(score) << 32) | (0xFFFFFFFF - row): order_key maps float
// order onto unsigned order, so composites in descending order are
// exactly "higher score first, lower index first on equal scores", and
// no two rows share one.
//
// The fused path (k <= K_FUSED), two launches:
//   1. ann_fused: a persistent grid of three blocks per SM, each streaming
//      one contiguous range of rows. A warp scores FUSED_ROWS rows a
//      round; for d <= 128 with float4 loads it holds the next round's
//      rows in registers while it scores this round's (96 KB in flight
//      per SM covers the memory's latency). Each block keeps its best
//      composites sorted in shared memory; a row at or below the
//      block's k-th best is dropped with one compare, the others go to
//      a buffer that a bitonic sort merges into the best when it fills.
//      No score and no key goes to device memory: the block writes its
//      k best composites.
//   2. ann_final: one block selects the k largest of the blocks' lists
//      (at most 396 x K_FUSED composites) by an 8-bit radix select that
//      stops at the first byte where every entry left is a winner,
//      sorts the k winners and writes their scores (decoded from the
//      order key: bit-exact) and indices.
//
// The select path (any k; the wrapper takes it for k > K_FUSED):
//   1. ann_score writes every score and its order key;
//   2. an 8-bit radix select over the order keys finds the k-th largest
//      value T and how many of the values equal to T the top k takes:
//      four passes of a shared-memory histogram over the rows that match
//      the digits fixed so far, each followed by a one-thread pick;
//   3. rows above T, and the first `need` rows equal to T in index order
//      (an exclusive scan of the equal flags), are placed in index order
//      by a second exclusive scan: exactly k winners;
//   4. the round sort (sort.cu, one 4-byte plane flipped for descending
//      order) orders the winners; it is stable, so the lower index stays
//      first among equal scores;
//   5. gather the k indices and scores.
#include "common.cuh"

namespace ctpu {
namespace {

typedef unsigned long long u64;

// similarity codes: ops/ann.py SIMILARITIES
enum Sim { SIM_COSINE = 0, SIM_DOT = 1, SIM_EUCLIDEAN = 2 };

constexpr int SCORE_THREADS = 256;
constexpr int HIST_THREADS = 256;
constexpr int HIST_BLOCKS = 528;  // four per SM
constexpr int RADIX = 256;

// the fused path; K_FUSED is ops/ann.py K_FUSED
constexpr int K_FUSED = 256;
constexpr int FUSED_THREADS = 256;
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_ROWS = 8;                          // per warp, a round
constexpr int ROUND_ROWS = FUSED_WARPS * FUSED_ROWS;   // per block, a round
constexpr int SLOTS = 2 * K_FUSED;  // the block's best, then the buffer
constexpr int FLUSH_AT = K_FUSED - ROUND_ROWS;  // merge above this
constexpr int FUSED_PER_SM = 3;
constexpr int FINAL_THREADS = 1024;
constexpr int FINAL_WARPS = FINAL_THREADS / 32;
constexpr int FINAL_UNROLL = 8;  // entries a thread loads at once

__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ u64 composite(float s, long row) {
  return ((u64)order_key(s) << 32) | (u64)(0xffffffffu - (uint32_t)row);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One float4 chunk of a lane's part of a row: acc gathers the products
// (or squared differences), nrm the squares of x (read for cosine only).
__device__ __forceinline__ void lane_add4(float& acc, float& nrm, float4 a,
                                          float4 b, int sim) {
  if (sim == SIM_EUCLIDEAN) {
    const float t0 = __fsub_rn(a.x, b.x), t1 = __fsub_rn(a.y, b.y),
                t2 = __fsub_rn(a.z, b.z), t3 = __fsub_rn(a.w, b.w);
    acc = __fadd_rn(acc, __fmaf_rn(t3, t3, __fmaf_rn(t2, t2,
                             __fmaf_rn(t1, t1, __fmul_rn(t0, t0)))));
  } else {
    acc = __fadd_rn(acc, __fmaf_rn(a.w, b.w, __fmaf_rn(a.z, b.z,
                             __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)))));
    nrm = __fadd_rn(nrm, __fmaf_rn(a.w, a.w, __fmaf_rn(a.z, a.z,
                             __fmaf_rn(a.y, a.y, __fmul_rn(a.x, a.x)))));
  }
}

__device__ __forceinline__ void lane_add1(float& acc, float& nrm, float a,
                                          float b, int sim) {
  if (sim == SIM_EUCLIDEAN) {
    const float t = __fsub_rn(a, b);
    acc = __fmaf_rn(t, t, acc);
  } else {
    acc = __fmaf_rn(a, b, acc);
    nrm = __fmaf_rn(a, a, nrm);
  }
}

// The warp's lanes' parts summed into the row's score (every lane gets
// it).
__device__ __forceinline__ float row_finish(float acc, float nrm, int sim) {
  acc = warp_sum(acc);
  if (sim == SIM_COSINE) nrm = warp_sum(nrm);
  float s = sim == SIM_COSINE
                ? __fdiv_rn(acc, fmaxf(__fsqrt_rn(nrm), 1e-9f))
            : sim == SIM_DOT ? acc
                             : -acc;
  if (s == 0.f) s = 0.f;  // -0.0 ties +0.0, as in a float compare
  return s;
}

// The score of row x, computed by the whole warp.
__device__ __forceinline__ float row_score(const float* x, int d,
                                           const float* q, int sim,
                                           int vec4, int lane) {
  float acc = 0.f, nrm = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < (d >> 2); j += 32)
      lane_add4(acc, nrm, x4[j], __ldg(q4 + j), sim);
  } else {
    for (int j = lane; j < d; j += 32)
      lane_add1(acc, nrm, x[j], __ldg(q + j), sim);
  }
  return row_finish(acc, nrm, sim);
}

// ------------------------------------------------------- the fused path

// Sorts s[0, SLOTS) descending (bitonic), all threads of the block.
__device__ __forceinline__ void sort_slots_desc(u64* s) {
  for (int size = 2; size <= SLOTS; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < SLOTS / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const bool desc = (i & size) == 0;
        const u64 a = s[i], b = s[j];
        if ((a < b) == desc) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
}

// The buffer s[K_FUSED, K_FUSED + cnt) merged into the best
// s[0, K_FUSED); returns the k-th best. Called by every thread after a
// barrier.
__device__ u64 merge_buffer(u64* s, int* cnt, int k) {
  for (int j = K_FUSED + *cnt + threadIdx.x; j < SLOTS; j += blockDim.x)
    s[j] = 0ull;
  __syncthreads();
  sort_slots_desc(s);
  const u64 kth = s[k - 1];
  if (threadIdx.x == 0) *cnt = 0;
  __syncthreads();
  return kth;
}

// Lane `lane`'s float4 of row `row` (zeros past the range or the row).
__device__ __forceinline__ float4 hold_row(const float* m, int d, long row,
                                           long r1, int lane, int d4) {
  return row < r1 && lane < d4
             ? __ldcs(reinterpret_cast<const float4*>(m + row * d) + lane)
             : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool HOLD>
__global__ void __launch_bounds__(FUSED_THREADS, FUSED_PER_SM)
ann_fused(const float* m, int n, int d, const float* q, int sim, int vec4,
          int k, int rows_per_block, u64* part) {
  __shared__ u64 s[SLOTS];
  __shared__ int cnt;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < SLOTS; j += FUSED_THREADS) s[j] = 0ull;
  if (threadIdx.x == 0) cnt = 0;
  __syncthreads();
  const long r0 = (long)blockIdx.x * rows_per_block;
  const long r1 = min(r0 + rows_per_block, (long)n);
  u64 kth = 0ull;  // the block's k-th best so far (0: fewer than k yet)
  // HOLD: d <= 128 and float4 loads; lane j < d / 4 holds chunk j of q
  // and of this warp's rows, the next round's loaded ahead.
  const int d4 = d >> 2;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nxt[FUSED_ROWS];
  if (HOLD) {
    if (lane < d4) qv = __ldg(reinterpret_cast<const float4*>(q) + lane);
#pragma unroll
    for (int r = 0; r < FUSED_ROWS; ++r)
      nxt[r] = hold_row(m, d, r0 + w * FUSED_ROWS + r, r1, lane, d4);
  }
  for (long base = r0; base < r1; base += ROUND_ROWS) {
    u64 mine = 0ull;  // lane r: the composite of the warp's row r
    if (HOLD) {
      float4 cur[FUSED_ROWS];
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) cur[r] = nxt[r];
      if (base + ROUND_ROWS < r1) {
#pragma unroll
        for (int r = 0; r < FUSED_ROWS; ++r)
          nxt[r] = hold_row(m, d, base + ROUND_ROWS + w * FUSED_ROWS + r,
                            r1, lane, d4);
      }
#pragma unroll
      for (int r = 0; r < FUSED_ROWS; ++r) {
        float acc = 0.f, nrm = 0.f;
        if (lane < d4) lane_add4(acc, nrm, cur[r], qv, sim);
        const float sc = row_finish(acc, nrm, sim);
        const long row = base + w * FUSED_ROWS + r;
        if (lane == r && row < r1) mine = composite(sc, row);
      }
    } else {
      for (int r = 0; r < FUSED_ROWS; ++r) {
        const long row = base + w * FUSED_ROWS + r;
        if (row >= r1) break;  // the same for the whole warp
        const float sc = row_score(m + row * d, d, q, sim, vec4, lane);
        if (lane == r) mine = composite(sc, row);
      }
    }
    const bool keep = mine > kth;
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    int after = 0;
    if (b) {
      int at = 0;
      if (lane == 0) at = atomicAdd(&cnt, __popc(b));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (keep) s[K_FUSED + at + __popc(b & ((1u << lane) - 1u))] = mine;
      after = at + __popc(b);
    }
    // the buffer only grows until it is merged, so some warp saw it
    // above FLUSH_AT exactly when it is
    if (__syncthreads_or(after > FLUSH_AT)) kth = merge_buffer(s, &cnt, k);
  }
  __syncthreads();
  if (cnt > 0) merge_buffer(s, &cnt, k);
  for (int j = threadIdx.x; j < k; j += FUSED_THREADS)
    part[(long)blockIdx.x * k + j] = s[j];
}

// The k largest of part[0, total) (distinct, except empty 0 slots, of
// blocks with fewer than k rows), in order, decoded into out_score /
// out_idx. One block.
__global__ void __launch_bounds__(FINAL_THREADS)
ann_final(const u64* part, int total, int k, float* out_score,
          int* out_idx) {
  __shared__ int hist[FINAL_WARPS][RADIX];
  __shared__ u64 win[SLOTS];
  __shared__ u64 prefix;
  __shared__ int shift_s, krem, done, nwin;
  __shared__ int wsum[RADIX / 32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) {
    prefix = 0ull;
    krem = k;
    done = 0;
    nwin = 0;
    shift_s = 64;
  }
  for (int j = tid; j < SLOTS; j += FINAL_THREADS) win[j] = 0ull;
  __syncthreads();
  // radix select: after a pass, the entries whose bits above `shift`
  // equal prefix's hold the krem largest still to be found
  for (int shift = 56; shift >= 0 && !done; shift -= 8) {
    for (int j = tid; j < FINAL_WARPS * RADIX; j += FINAL_THREADS)
      (&hist[0][0])[j] = 0;
    __syncthreads();
    const u64 hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    const u64 pre = prefix;
    for (int base = 0; base < total; base += FINAL_THREADS * FINAL_UNROLL) {
      u64 v[FINAL_UNROLL];  // the loads first, so that they overlap
#pragma unroll
      for (int u = 0; u < FINAL_UNROLL; ++u) {
        const int i = base + u * FINAL_THREADS + tid;
        v[u] = i < total ? part[i] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < FINAL_UNROLL; ++u) {
        // 0 is an empty slot, never a winner
        const bool in = v[u] != 0ull && (v[u] & hi) == pre;
        if (__ballot_sync(0xffffffffu, in) == 0u) continue;
        const int dgt = in ? (int)((v[u] >> shift) & 255u) : RADIX;
        const unsigned peers = __match_any_sync(0xffffffffu, dgt);
        if (in && lane == __ffs(peers) - 1) hist[w][dgt] += __popc(peers);
      }
    }
    __syncthreads();
    // the digit: thread d < RADIX takes digit d's count c and the count
    // above it (a suffix sum: within the warp by shuffles, then the
    // warps above); the one digit with above < krem <= above + c is
    // the k-th's
    int c = 0, incl = 0;
    const int need = krem;  // read before the pick below rewrites it
    if (tid < RADIX) {
      for (int j = 0; j < FINAL_WARPS; ++j) c += hist[j][tid];
      incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      if (lane == 0) wsum[w] = incl;
    }
    __syncthreads();
    if (tid < RADIX) {
      int above = incl - c;
      for (int j = w + 1; j < RADIX / 32; ++j) above += wsum[j];
      if (above < need && need <= above + c) {
        prefix = pre | ((u64)tid << shift);
        done = c == need - above;  // every entry left is a winner
        krem = need - above;
        shift_s = shift;
      }
    }
    __syncthreads();
  }
  // the winners: the entries whose bits from shift_s up are at least
  // prefix's (exactly k: the entries are distinct)
  const int sh = shift_s;
  const u64 lim = prefix >> sh;
  for (int base = 0; base < total; base += FINAL_THREADS * FINAL_UNROLL) {
    u64 v[FINAL_UNROLL];
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u) {
      const int i = base + u * FINAL_THREADS + tid;
      v[u] = i < total ? part[i] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < FINAL_UNROLL; ++u)
      if (v[u] != 0ull && (v[u] >> sh) >= lim)
        win[atomicAdd(&nwin, 1)] = v[u];
  }
  __syncthreads();
  sort_slots_desc(win);
  for (int j = tid; j < k; j += FINAL_THREADS) {
    const u64 v = win[j];
    out_score[j] = key_score((uint32_t)(v >> 32));
    out_idx[j] = (int)(0xffffffffu - (uint32_t)v);
  }
}

int fused_grid(int n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, c = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    sms = c > 0 ? c : 1;
  }
  const long want = ((long)n + ROUND_ROWS - 1) / ROUND_ROWS;
  const long g = (long)FUSED_PER_SM * sms;
  return (int)(want < g ? want : g);
}

// ------------------------------------------------------ the select path

__global__ void __launch_bounds__(SCORE_THREADS)
ann_score(const float* m, int n, int d, const float* q, int sim, int vec4,
          float* score, uint32_t* key) {
  const long row = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  const float s = row_score(m + row * d, d, q, sim, vec4, lane);
  if (lane == 0) {
    score[row] = s;
    key[row] = order_key(s);
  }
}

// state[0]: the digits of T fixed so far; state[1]: how many of the rows
// that match them the top k still takes.
__global__ void select_init(int* hist, uint32_t* state, int k) {
  for (int j = threadIdx.x; j < 4 * RADIX; j += blockDim.x) hist[j] = 0;
  if (threadIdx.x == 0) {
    state[0] = 0u;
    state[1] = (uint32_t)k;
  }
}

__global__ void __launch_bounds__(HIST_THREADS)
select_hist(const uint32_t* key, int n, const uint32_t* state,
            uint32_t hi_mask, int shift, int* hist) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t prefix = state[0] & hi_mask;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const uint32_t v = key[i];
    if ((v & hi_mask) == prefix) atomicAdd(&h[(v >> shift) & 255u], 1);
  }
  __syncthreads();
  if (h[threadIdx.x]) atomicAdd(&hist[threadIdx.x], h[threadIdx.x]);
}

__global__ void select_pick(const int* hist, int shift, uint32_t* state) {
  const int krem = (int)state[1];
  int above = 0;
  for (int dgt = RADIX - 1; dgt >= 0; --dgt) {
    const int c = hist[dgt];
    if (above + c >= krem) {
      state[0] |= (uint32_t)dgt << shift;
      state[1] = (uint32_t)(krem - above);
      return;
    }
    above += c;
  }
}

__global__ void eq_flags(const uint32_t* key, int n, const uint32_t* state,
                         int* eq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) eq[i] = key[i] == state[0];
}

__global__ void sel_flags(const uint32_t* key, const int* eq_rank, int n,
                          const uint32_t* state, int* sel) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = key[i], t = state[0];
  sel[i] = v > t || (v == t && eq_rank[i] < (int)state[1]);
}

__global__ void sel_scatter(const uint32_t* key, const int* eq_rank,
                            const int* pos, int n, const uint32_t* state,
                            uint32_t* win_key, int* win_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = key[i], t = state[0];
  if (v > t || (v == t && eq_rank[i] < (int)state[1])) {
    win_key[pos[i]] = v;
    win_idx[pos[i]] = i;
  }
}

__global__ void gather_top(const int* perm, const int* win_idx,
                           const float* score, int k, float* out_score,
                           int* out_idx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const int i = win_idx[perm[j]];
  out_idx[j] = i;
  out_score[j] = score[i];
}

struct Scratch {
  float* score;
  uint32_t* key;
  int* a;
  int* b;
  int* scan;
  int* hist;
  uint32_t* state;
  uint32_t* win_key;
  int* win_idx;
  int* perm;
  int* passes;
  void* sort;
  long bytes;
};

long align256(long b) { return (b + 255) & ~255L; }

// The winners' order key, flipped (descending), as the round sort's one
// plane; every winner is live but a key of 0 (a NaN bit pattern), which
// sorts last either way.
RoundKey winners_key(const uint32_t* win_key) {
  RoundKey key = round_key(0xffffffffu);
  round_key_add(key, win_key, 1, 4, 0xffffffffu);
  return key;
}

Scratch carve(void* base, int n, int k) {
  Scratch s{};
  char* p = (char*)base;
  long off = 0;
  auto take = [&](long bytes) {
    char* at = p ? p + off : nullptr;
    off += align256(bytes);
    return at;
  };
  s.score = (float*)take(4L * n);
  s.key = (uint32_t*)take(4L * n);
  s.a = (int*)take(4L * n);
  s.b = (int*)take(4L * n);
  s.scan = (int*)take(4L * scan_scratch_elems(n));
  s.hist = (int*)take(4L * 4 * RADIX);
  s.state = (uint32_t*)take(8);
  s.win_key = (uint32_t*)take(4L * k);
  s.win_idx = (int*)take(4L * k);
  s.perm = (int*)take(4L * k);
  s.passes = (int*)take(4);
  s.sort = take(round_sort_scratch_bytes(1, k, 4));
  s.bytes = off;
  return s;
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

extern "C" int ctpu_ann_k_fused() { return K_FUSED; }

extern "C" long ctpu_ann_fused_scratch_bytes(int n, int k) {
  return (long)fused_grid(n) * k * (long)sizeof(u64);
}

// m: f32[n, d] row-major; q: f32[d] (unit length for cosine);
// 1 <= k <= min(n, K_FUSED). out_score (f32[k]) and out_idx (int32[k])
// receive the top k, by score descending, lower index first on equal
// scores. vec4: d % 4 == 0 and m, q 16-byte aligned (float4 loads).
// scratch: ctpu_ann_fused_scratch_bytes(n, k) bytes. Two launches.
extern "C" int ctpu_ann_topk(const float* m, int n, int d, const float* q,
                             int sim, int vec4, int k, float* out_score,
                             int* out_idx, void* scratch, void* stream) {
  if (k < 1 || k > K_FUSED || k > n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = fused_grid(n);
  const int rows = (int)(((long)n + g - 1) / g);
  u64* part = (u64*)scratch;
  if (vec4 && d <= 128)
    ann_fused<true><<<g, FUSED_THREADS, 0, s>>>(m, n, d, q, sim, vec4, k,
                                                rows, part);
  else
    ann_fused<false><<<g, FUSED_THREADS, 0, s>>>(m, n, d, q, sim, vec4, k,
                                                 rows, part);
  ann_final<<<1, FINAL_THREADS, 0, s>>>(part, g * k, k, out_score, out_idx);
  return (int)cudaGetLastError();
}

extern "C" long ctpu_ann_select_scratch_bytes(int n, int k) {
  return carve(nullptr, n, k).bytes;
}

// The select path: the same function for any 1 <= k <= n; scratch:
// ctpu_ann_select_scratch_bytes(n, k) bytes.
extern "C" int ctpu_ann_topk_select(const float* m, int n, int d,
                                    const float* q, int sim, int vec4,
                                    int k, float* out_score, int* out_idx,
                                    void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Scratch w = carve(scratch, n, k);
  ann_score<<<grid_for(32L * n, SCORE_THREADS), SCORE_THREADS, 0, s>>>(
      m, n, d, q, sim, vec4, w.score, w.key);
  select_init<<<1, 256, 0, s>>>(w.hist, w.state, k);
  int hb = (int)grid_for(n, HIST_THREADS);
  hb = hb > HIST_BLOCKS ? HIST_BLOCKS : hb;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : 0xffffffffu << (shift + 8);
    int* hist = w.hist + pass * RADIX;
    select_hist<<<hb, HIST_THREADS, 0, s>>>(w.key, n, w.state, hi_mask,
                                             shift, hist);
    select_pick<<<1, 1, 0, s>>>(hist, shift, w.state);
  }
  const unsigned g = grid_for(n, 256);
  eq_flags<<<g, 256, 0, s>>>(w.key, n, w.state, w.a);
  scan_add_exclusive(w.a, w.a, n, w.scan, s);
  sel_flags<<<g, 256, 0, s>>>(w.key, w.a, n, w.state, w.b);
  scan_add_exclusive(w.b, w.b, n, w.scan, s);
  sel_scatter<<<g, 256, 0, s>>>(w.key, w.a, w.b, n, w.state, w.win_key,
                                w.win_idx);
  const cudaError_t err = round_sort_perm(winners_key(w.win_key), 1, k,
                                          w.perm, w.sort, s, w.passes);
  if (err != cudaSuccess) return (int)err;
  gather_top<<<grid_for(k, 256), 256, 0, s>>>(w.perm, w.win_idx, w.score, k,
                                              out_score, out_idx);
  return (int)cudaGetLastError();
}
