// Hand-written Hopper (sm_90a) kernels of the per-row-scale grouped scans
// (the v3p, v3pN and v7 generations of the JAX package).
//
// Both kernels compute, for group g (partition p = gp[g], qt query rows of
// unscaled queries), the scores
//     s = 2 <q, x> - |x|^2   (l2)        s = <q, x>   (ip)
// over the valid lanes (lane < size), each row's range over them
//     rowmin, rowmax, rng = max(rowmax - rowmin, 1e-20)
// and the packed per-row key
//     packed = floor((s - rowmin) * (levels / rng)) * slot_mult + lane
// (-1 at invalid lanes). They write out [Gn, qt, kk] packed f32, descending,
// -1 for none, and stats [Gn, qt, 2] = (isfinite(rowmin) ? rowmin : 0, rng),
// which the epilogue uses to dequantize for the cross-group merge. Ghost
// groups (size <= 0) write -1 and stats (0, 1e-20), what the TPU kernels
// compute for a group with no valid lane.
//
// They differ only in the selection:
//   K4 (rowscale_topk) — the exact top-kk of each row's packed values. The
//      values are unique (distinct lanes), so this equals the TPU kernel's kk
//      rounds of max-and-clear over the full row.
//   K5 (rowscale_fold) — fold-128 top-2 then kk rounds, as kernel K1.
//
// Bound on the H100: f32 operations. Each pass does 2 qt C D flops against
// C D 4 bytes of slab (qt / 2 = 32 flops per byte at qt = 64, above the f32
// ridge of 20); the row range needs a first pass over the scores before any
// key exists, so the work is two passes.
//
// Design (simple first): one block per group, the [qt, D] query tile in
// shared memory, the slab streamed through shared memory in 128-row
// segments twice (only the ceil(size / 128) segments that hold vectors).
// Pass 1 takes each row's min and max; pass 2 recomputes the same scores
// with the same code in the same order (bit-identical, so a winner's key
// comes from the same float as the stats) and selects. There is no C % 128
// requirement: the last segment may be partial and slot_mult is
// next_pow2(C). Build without --use_fast_math: levels / rng must be an IEEE
// division, as in XLA.
//
// K4's exact top-kk keeps, per row, a candidate buffer in shared memory of
// cap = round_up(kk, 32) + 128 values and a threshold (initially -1): a value
// above the threshold is appended (ballot + prefix count); when 32 more
// might not fit, the buffer is cut to its kk largest values and the
// threshold becomes the kk-th largest. The output is kk descending rounds of
// "largest value below the previous one" over the buffer.

#include "common.cuh"

namespace {

constexpr float kMinRange = 1e-20f;

// Exact kk-th largest of a row's buffer b[0, cnt) (cnt > kk, values unique),
// then the buffer is cut to the kk values at or above it. Returns it.
__device__ __noinline__ float cut_row(float* b, int cnt, int kk) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float prev = INFINITY;
  for (int i = 0; i < kk; ++i) {
    float lm = -1.0f;
    for (int e = lane; e < cnt; e += 32) {
      const float x = b[e];
      if (x < prev) lm = fmaxf(lm, x);
    }
    prev = warp_max(lm);
  }
  int w = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    const float x = e < cnt ? b[e] : -1.0f;
    const bool keep = e < cnt && x >= prev;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    __syncwarp();  // every lane has read its entry before any is overwritten
    if (keep) b[w + __popc(m & ((1u << lane) - 1u))] = x;
    w += __popc(m);
  }
  __syncwarp();
  return prev;
}

// kk descending values of a row's buffer b[0, cnt) into o[0, kk), -1 after
// the buffer runs out.
__device__ __noinline__ void emit_row(const float* b, int cnt, int kk, float* o) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float prev = INFINITY;
  for (int i = 0; i < kk; ++i) {
    float lm = -1.0f;
    for (int e = lane; e < cnt; e += 32) {
      const float x = b[e];
      if (x < prev) lm = fmaxf(lm, x);
    }
    prev = warp_max(lm);
    if (lane == 0) o[i] = prev;
  }
}

// One pass over the group's segments: acc = <q, x> for the R x 4 (row,
// column) pairs this thread owns, then f(s, j, ln, ok) with the score.
template <int R, typename F>
__device__ __forceinline__ void score_pass(const float* qs, float* seg, const float* slab,
                                           const float* nrm, int size, int D, int Dp,
                                           bool l2, F&& f) {
  const int lane = threadIdx.x & 31;
  const int nseg = (size + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    __syncthreads();  // previous segment fully consumed (and q tile written)
    load_segment(seg, slab, s * kFold, size, D, Dp);
    __syncthreads();
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      const bool ok = ln < size;
      const float nv = (l2 && ok) ? nrm[ln] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // 2 dot is exact, so a contraction into fmaf changes nothing.
        const float sc = l2 ? 2.0f * acc[r][j] - nv : acc[r][j];
        f(r, j, ln, ok, sc);
      }
    }
  }
}

template <int R, bool kFoldSelect>
__global__ void __launch_bounds__(kThreads)
rowscale_scan_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                     const float* __restrict__ qg, const float* __restrict__ codes,
                     const float* __restrict__ norms, float* __restrict__ out,
                     float* __restrict__ stats, int D, int Dp, int C, int kk, int cap,
                     int is_l2, float slot_mult, float levels) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [qt][Dp]
  float* seg = qs + qt * Dp;                // [128][Dp + 1]
  float* buf = seg + kFold * (Dp + 1);      // [qt][cap] (K4 only)
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int size = min(gsize[g], C);
  float* og = out + (size_t)g * qt * kk;
  float* sg = stats + (size_t)g * qt * 2;
  if (size <= 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) og[i] = -1.0f;
    for (int i = threadIdx.x; i < qt; i += kThreads) {
      sg[2 * i] = 0.0f;
      sg[2 * i + 1] = kMinRange;
    }
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
  const float* nrm = norms + (size_t)p * C;
  const bool l2 = is_l2 != 0;

  // Pass 1: each row's min and max over its valid lanes.
  float mn[R], mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = INFINITY;
    mx[r] = -INFINITY;
  }
  score_pass<R>(qs, seg, slab, nrm, size, D, Dp, l2,
                [&](int r, int, int, bool ok, float sc) {
                  if (ok) {
                    mn[r] = fminf(mn[r], sc);
                    mx[r] = fmaxf(mx[r], sc);
                  }
                });
  float scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = warp_min(mn[r]);
    mx[r] = warp_max(mx[r]);
    const float rng = fmaxf(mx[r] - mn[r], kMinRange);
    scale[r] = levels / rng;
    if (lane == 0) {
      const int row = warp + kWarps * r;
      sg[2 * row] = isfinite(mn[r]) ? mn[r] : 0.0f;
      sg[2 * row + 1] = rng;
    }
  }

  // Pass 2: the same scores, quantized with the row's range, packed, selected.
  if constexpr (kFoldSelect) {
    float m1[R][4], m2[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
    score_pass<R>(qs, seg, slab, nrm, size, D, Dp, l2,
                  [&](int r, int j, int ln, bool ok, float sc) {
                    const float key = floorf((sc - mn[r]) * scale[r]);
                    fold2(m1[r][j], m2[r][j], ok ? key * slot_mult + (float)ln : -1.0f);
                  });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int i = 0; i < kk; ++i) {
        const float b = select_round(m1[r], m2[r]);
        if (lane == 0) og[row * kk + i] = b;
      }
    }
  } else {
    int cnt[R];
    float thr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cnt[r] = 0;
      thr[r] = -1.0f;
    }
    score_pass<R>(qs, seg, slab, nrm, size, D, Dp, l2,
                  [&](int r, int, int ln, bool ok, float sc) {
                    float* b = buf + (size_t)(warp + kWarps * r) * cap;
                    if (cnt[r] + 32 > cap) {  // warp-uniform
                      thr[r] = cut_row(b, cnt[r], kk);
                      cnt[r] = kk;
                    }
                    const float key = floorf((sc - mn[r]) * scale[r]);
                    const float v = ok ? key * slot_mult + (float)ln : -1.0f;
                    const bool take = v > thr[r];
                    const unsigned m = __ballot_sync(0xffffffffu, take);
                    if (take) b[cnt[r] + __popc(m & ((1u << lane) - 1u))] = v;
                    cnt[r] += __popc(m);
                  });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      emit_row(buf + (size_t)row * cap, cnt[r], kk, og + row * kk);
    }
  }
}

// cap of K4's per-row candidate buffer (the wrapper checks the same formula
// against the shared memory a block may use).
inline int topk_cap(int kk) { return (kk + 31) / 32 * 32 + 128; }

template <bool kFoldSelect>
int launch_rowscale(const void* gp, const void* gsize, const void* qg, const void* codes,
                    const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                    int kk, int is_l2, float slot_mult, float levels, void* stream) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = kFoldSelect ? 0 : topk_cap(kk);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1) + qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_ROWSCALE(R)                                                                    \
  case 8 * R: {                                                                           \
    cudaError_t e = allow_smem(rowscale_scan_kernel<R, kFoldSelect>, smem);               \
    if (e != cudaSuccess) return (int)e;                                                  \
    rowscale_scan_kernel<R, kFoldSelect><<<Gn, kThreads, smem, st>>>(                     \
        (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)codes,         \
        (const float*)norms, (float*)out, (float*)stats, D, Dp, C, kk, cap, is_l2,        \
        slot_mult, levels);                                                               \
    break;                                                                                \
  }
  switch (qt) {
    QK_ROWSCALE(1)
    QK_ROWSCALE(2)
    QK_ROWSCALE(4)
    QK_ROWSCALE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_ROWSCALE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: replaces quake_tpu/ops/pallas_grouped.py::_v3p_kernel and _v3pn_kernel
// (_v3p_group_body + _v3p_select).
int qk_rowscale_topk(const void* gp, const void* gsize, const void* qg, const void* codes,
                     const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                     int kk, int is_l2, float slot_mult, float levels, void* stream) {
  return launch_rowscale<false>(gp, gsize, qg, codes, norms, out, stats, Gn, qt, D, C, kk,
                                is_l2, slot_mult, levels, stream);
}

// K5: replaces quake_tpu/ops/pallas_grouped.py::_v7_kernel (_v7_select +
// _v7_fold_rounds).
int qk_rowscale_fold(const void* gp, const void* gsize, const void* qg, const void* codes,
                     const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                     int kk, int is_l2, float slot_mult, float levels, void* stream) {
  return launch_rowscale<true>(gp, gsize, qg, codes, norms, out, stats, Gn, qt, D, C, kk,
                               is_l2, slot_mult, levels, stream);
}

}  // extern "C"
