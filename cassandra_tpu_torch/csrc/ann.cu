// K10: exact vector search, the scores of every row and their top k.
//
// Replaces cassandra_tpu/index/manager.py `VectorIndex.ann`: one
// matrix-vector product (cosine over normalised rows, dot, or the
// negative squared L2 distance) and `lax.top_k`, which orders by score,
// higher first, and puts the lower index first among equal scores.
//
// Bound on this card: bytes. The matrix is read once, n * d * 4 B: at
// 1,000,000 x 128 that is 512 MB, 153 us at 3.35 TB/s, against 2 n d
// floating-point operations (4 us at 67 TFLOP/s). Design:
//   1. score: one warp per row, float4 loads when d is a multiple of 4
//      and the rows are 16-byte aligned, a warp-shuffle sum. Cosine
//      takes the row's norm from the same read (the JAX package
//      normalises the whole matrix on the host first); the caller
//      divides q by its norm, as the JAX package does. Euclidean is -sum((x - q)^2), written as the JAX package
//      writes it. -0.0 becomes +0.0. Each score is also stored as its
//      order-preserving u32 image (sign flipped for >= 0, all bits for
//      < 0), so unsigned order is float order.
//   2. select: an 8-bit radix select over the u32 images finds the k-th
//      largest value T and how many of the values equal to T the top k
//      takes ("need"): four passes of a shared-memory histogram of the
//      rows that match the digits fixed so far, each followed by a
//      one-thread pick. The state stays on the card (no host sync).
//   3. compact: rows above T, and the first `need` rows equal to T in
//      index order (an exclusive scan of the equal flags), are placed
//      in index order by a second exclusive scan: exactly k winners.
//   4. order: sort.cu's stable radix passes over the winners' images,
//      descending; stability keeps the lower index first on ties.
//   5. gather the k indices and scores.
#include "common.cuh"

namespace ctpu {
namespace {

// similarity codes: ops/ann.py SIMILARITIES
enum Sim { SIM_COSINE = 0, SIM_DOT = 1, SIM_EUCLIDEAN = 2 };

constexpr int SCORE_THREADS = 256;
constexpr int HIST_THREADS = 256;
constexpr int HIST_BLOCKS = 528;  // four per SM
constexpr int RADIX = 256;

__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(SCORE_THREADS)
ann_score(const float* m, int n, int d, const float* q, int sim, int vec4,
          float* score, uint32_t* key) {
  const long row = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  const float* x = m + row * d;
  float acc = 0.f, nrm = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = lane; j < (d >> 2); j += 32) {
      const float4 a = x4[j];
      const float4 b = __ldg(q4 + j);
      if (sim == SIM_EUCLIDEAN) {
        const float t0 = a.x - b.x, t1 = a.y - b.y, t2 = a.z - b.z,
                    t3 = a.w - b.w;
        acc += t0 * t0 + t1 * t1 + t2 * t2 + t3 * t3;
      } else {
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        nrm += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
      }
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float a = x[j], b = __ldg(q + j);
      if (sim == SIM_EUCLIDEAN) {
        const float t = a - b;
        acc += t * t;
      } else {
        acc += a * b;
        nrm += a * a;
      }
    }
  }
  acc = warp_sum(acc);
  if (sim == SIM_COSINE) nrm = warp_sum(nrm);
  if (lane == 0) {
    float s = sim == SIM_COSINE ? acc / fmaxf(sqrtf(nrm), 1e-9f)
              : sim == SIM_DOT  ? acc
                                : -acc;
    if (s == 0.f) s = 0.f;  // -0.0 ties +0.0, as in a float compare
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
  int* perm_tmp;
  void* radix;
  long bytes;
};

long align256(long b) { return (b + 255) & ~255L; }

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
  s.perm_tmp = (int*)take(4L * k);
  s.radix = take(radix_scratch_bytes(k));
  s.bytes = off;
  return s;
}

}  // namespace
}  // namespace ctpu

using namespace ctpu;

extern "C" long ctpu_ann_scratch_bytes(int n, int k) {
  return carve(nullptr, n, k).bytes;
}

// m: f32[n, d] row-major; q: f32[d] (unit length for cosine); 1 <= k <= n.
// out_score (f32[k]) and out_idx (int32[k]) receive the top k, by score
// descending, lower index first on equal scores.
// vec4: d % 4 == 0 and m, q 16-byte aligned (float4 loads).
extern "C" int ctpu_ann_topk(const float* m, int n, int d, const float* q,
                             int sim, int vec4, int k, float* out_score,
                             int* out_idx, void* scratch, void* stream) {
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
  SortKey desc{w.win_key, 1, 4, 0xffffffffu};
  radix_sort_perm(&desc, 1, k, w.perm, w.perm_tmp, w.radix, s);
  gather_top<<<grid_for(k, 256), 256, 0, s>>>(w.perm, w.win_idx, w.score, k,
                                              out_score, out_idx);
  return (int)cudaGetLastError();
}
