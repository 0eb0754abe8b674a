// Hand-written Hopper (sm_90a) kernels of the fixed-nprobe search path.
//
// All three share one selection scheme, taken over from the JAX package's
// Pallas kernels: a candidate is a "packed" f32 value
//     packed = key * mult + lane        (an integer below 2^24, exact in f32)
// or -1 for no candidate. The lanes of a row are folded into 128 columns
// (column = lane % 128); a streaming top-2 (m1, m2) per column keeps the two
// largest packed values, and each of the k selection rounds emits the row
// maximum of m1 and demotes the columns that hold it (m1 <- m2, m2 <- -1).
// A column therefore yields at most two winners: the approximation is part of
// the contract and is reproduced here, not replaced by an exact top-k.
//
// Thread layout shared by the kernels: a warp owns whole rows, and lane l of
// a warp owns the four fold columns {l, l+32, l+64, l+96}, so a round's row
// maximum is a local max over four registers plus a 5-step shuffle reduction.
// All arithmetic is f32 on the CUDA cores (no TF32, no tensor cores).
//
// Each launcher returns cudaGetLastError() so the Python wrapper can raise.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: grouped scan.
//
// Replaces quake_tpu/ops/pallas_grouped.py::_v9_kernel (launched from
// grouped_scan_pallas_v9/_v11) and _v8_kernel (grouped_scan_pallas_v8),
// which computes the same function with per-group rounds and leaves ghost
// groups to its epilogue's mask. Group g is one partition gp[g] and qt = 8 R
// query rows (queries pre-scaled by q_coef, norms pre-shifted to normsT, so
// key = clip(floor(<q, x> - normsT), 0, levels) is the global-scale
// quantized score). Per row: packed = key * slot_mult + lane (-1 at
// lane >= size), fold-128 top-2, then kk rounds. Ghost groups (size <= 0)
// write -1.
//
// Bound on the H100: f32 operations. A group does 2 qt C D flops against
// C D 4 bytes of slab, i.e. qt / 2 = 32 flops per byte at qt = 64, above
// the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte.
//
// Design (simple first): one block per group. The [qt, D] query tile stays
// in shared memory; the slab streams through shared memory one 128-row
// segment at a time, and only the ceil(size / 128) segments that hold
// vectors are read (later segments are all -1 and cannot change (m1, m2)).
// Each thread keeps R x 4 dot products and (m1, m2) pairs in registers.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                    const float* __restrict__ qg, const float* __restrict__ codes,
                    const float* __restrict__ normsT, float* __restrict__ out,
                    int D, int Dp, int C, int kk, float slot_mult, float levels) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [qt][Dp]
  float* seg = smem + qt * Dp;  // [128][Dp + 1]
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int size = min(gsize[g], C);
  float* og = out + (size_t)g * qt * kk;
  if (size <= 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) og[i] = -1.0f;
    return;
  }
  const int p = gp[g];
  const float* qsrc = qg + (size_t)g * qt * D;
  for (int i = threadIdx.x; i < qt * Dp; i += kThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    qs[i] = d < D ? qsrc[(size_t)r * D + d] : 0.0f;
  }
  const float* slab = codes + (size_t)p * C * D;
  const float* nrm = normsT + (size_t)p * C;

  float m1[R][4], m2[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;

  const int nseg = (size + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    __syncthreads();  // previous segment fully consumed (and q tile written)
    load_segment(seg, slab, s * kFold, C, D, Dp);
    __syncthreads();
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      const bool ok = ln < size;
      const float nv = nrm[ln];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float key = fminf(fmaxf(floorf(acc[r][j] - nv), 0.0f), levels);
        fold2(m1[r][j], m2[r][j], ok ? key * slot_mult + (float)ln : -1.0f);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    for (int i = 0; i < kk; ++i) {
      const float b = select_round(m1[r], m2[r]);
      if (lane == 0) og[row * kk + i] = b;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: pool merge.
//
// Replaces quake_tpu/ops/pallas_grouped.py::_merge_positions_kernel (wrapper
// _merge_positions_pallas, called from _pool_tail). keys [B, poolp] hold
// integer quantized keys (-1 = empty); packed = key * lane_mult + lane,
// fold-128 top-2, kfin rounds; out [B, kfin] = winning lane (pool position),
// -1 for none.
//
// Bound on the H100: bytes (B poolp 4 read, B kfin 4 written; a handful of
// compares per element).
//
// Design: one warp per query row, reading the row in coalesced 128-lane
// segments; no shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
merge_positions_kernel(const float* __restrict__ keys, int* __restrict__ out, int B,
                       int poolp, int kfin, int lane_mult) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  const float* kr = keys + (size_t)b * poolp;
  const float lm = (float)lane_mult;
  float m1[4], m2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m1[j] = m2[j] = -1.0f;
  for (int s = 0; s < poolp; s += kFold) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = s + lane + 32 * j;
      const float kv = kr[c];
      fold2(m1[j], m2[j], kv >= 0.0f ? kv * lm + (float)c : -1.0f);
    }
  }
  for (int i = 0; i < kfin; ++i) {
    const float best = select_round(m1, m2);
    if (lane == 0) {
      const int v = (int)best;
      out[(size_t)b * kfin + i] = best >= 0.0f ? v % lane_mult : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: parent ranking (flat top-k).
//
// Replaces quake_tpu/ops/pallas_flat.py::_flat_topk_kernel (with
// pallas_grouped.py::_v7_select and _v7_fold_rounds), launched from
// flat_topk_pallas / parent_rank_pallas. scores = 2 <q, x> + bias (l2) or
// <q, x> + bias (ip); valid = score > -inf. Each row is range-quantized over
// its valid lanes, key = floor((s - rowmin) * (levels / rng)) with
// rng = max(rowmax - rowmin, 1e-20); packed = key * slot_mult + lane; fold
// 128 top-2; k rounds; out [B, k] = winning slot, -1 for none.
//
// Bound on the H100: f32 operations (2 B N D flops against (B + N) D 4
// bytes; at the main path's N = 256 that is 2 N / 4 = 128 flops per byte of
// queries).
//
// Design: one block per 32 queries (4 rows per warp), the query tile in
// shared memory, the codes streamed through shared memory in 128-row
// segments twice: pass 1 takes the row min/max, pass 2 recomputes the same
// scores (bit-identical: same code, same order) and folds the packed keys.
// ---------------------------------------------------------------------------
constexpr int kFlatRows = 4;  // rows per warp
constexpr int kFlatQB = kWarps * kFlatRows;

template <bool L2>
__device__ __forceinline__ float flat_score(float dot, float bias) {
  return L2 ? 2.0f * dot + bias : dot + bias;
}

template <bool L2>
__global__ void __launch_bounds__(kThreads)
flat_topk_kernel(const float* __restrict__ q, const float* __restrict__ codes,
                 const float* __restrict__ bias, int* __restrict__ out, int B, int N,
                 int D, int Dp, int k, int slot_mult, float levels) {
  constexpr int R = kFlatRows;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [32][Dp]
  float* seg = smem + kFlatQB * Dp;  // [128][Dp + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kFlatQB;
  for (int i = threadIdx.x; i < kFlatQB * Dp; i += kThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    const int b = b0 + r;
    qs[i] = (d < D && b < B) ? q[(size_t)b * D + d] : 0.0f;
  }
  const int nseg = N / kFold;

  float mn[R], mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = INFINITY;
    mx[r] = -INFINITY;
  }
  for (int s = 0; s < nseg; ++s) {  // pass 1: row min / max over valid lanes
    __syncthreads();
    load_segment(seg, codes, s * kFold, N, D, Dp);
    __syncthreads();
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = bias[s * kFold + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sc = flat_score<L2>(acc[r][j], bv);
        if (sc > -INFINITY) {
          mn[r] = fminf(mn[r], sc);
          mx[r] = fmaxf(mx[r], sc);
        }
      }
    }
  }
  float scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = warp_min(mn[r]);
    mx[r] = warp_max(mx[r]);
    scale[r] = levels / fmaxf(mx[r] - mn[r], 1e-20f);
  }

  float m1[R][4], m2[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
  const float sm = (float)slot_mult;
  for (int s = 0; s < nseg; ++s) {  // pass 2: quantize, pack, fold
    __syncthreads();
    load_segment(seg, codes, s * kFold, N, D, Dp);
    __syncthreads();
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      const float bv = bias[ln];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sc = flat_score<L2>(acc[r][j], bv);
        const float key = floorf((sc - mn[r]) * scale[r]);
        fold2(m1[r][j], m2[r][j], sc > -INFINITY ? key * sm + (float)ln : -1.0f);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + warp + kWarps * r;
    for (int i = 0; i < k; ++i) {
      const float best = select_round(m1[r], m2[r]);
      if (lane == 0 && b < B) {
        const int v = (int)best;
        out[(size_t)b * k + i] = best >= 0.0f ? v % slot_mult : -1;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* qk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int qk_grouped_scan(const void* gp, const void* gsize, const void* qg, const void* codes,
                    const void* normsT, void* out, int Gn, int qt, int D, int C, int kk,
                    float slot_mult, float levels, void* stream) {
  const int Dp = padded_dim(D);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1)) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (Gn <= 0) return (int)cudaGetLastError();
#define QK_GROUPED(R)                                                                   \
  case 8 * R: {                                                                         \
    cudaError_t e = allow_smem(grouped_scan_kernel<R>, smem);             \
    if (e != cudaSuccess) return (int)e;                                                \
    grouped_scan_kernel<R><<<Gn, kThreads, smem, st>>>(                                 \
        (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)codes,       \
        (const float*)normsT, (float*)out, D, Dp, C, kk, slot_mult, levels);            \
    break;                                                                              \
  }
  switch (qt) {
    QK_GROUPED(1)
    QK_GROUPED(2)
    QK_GROUPED(4)
    QK_GROUPED(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_GROUPED
  return (int)cudaGetLastError();
}

int qk_merge_positions(const void* keys, void* out, int B, int poolp, int kfin,
                       int lane_mult, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int grid = (B + kWarps - 1) / kWarps;
  merge_positions_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)keys, (int*)out, B, poolp, kfin, lane_mult);
  return (int)cudaGetLastError();
}

int qk_flat_topk(const void* q, const void* codes, const void* bias, void* out, int B,
                 int N, int D, int k, int is_l2, int slot_mult, float levels, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const size_t smem = (size_t)(kFlatQB * Dp + kFold * (Dp + 1)) * sizeof(float);
  const int grid = (B + kFlatQB - 1) / kFlatQB;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (is_l2) {
    e = allow_smem(flat_topk_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    flat_topk_kernel<true><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)codes, (const float*)bias, (int*)out, B, N, D, Dp, k,
        slot_mult, levels);
  } else {
    e = allow_smem(flat_topk_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    flat_topk_kernel<false><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)codes, (const float*)bias, (int*)out, B, N, D, Dp, k,
        slot_mult, levels);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
