// Hand-written Hopper (sm_90a) kernel of the exact-score grouped scans (the
// v3 and v2 generations of the JAX package).
//
// K6 (exact_topk) computes, for group g (partition p = gp[g], qt query rows),
// the f32 scores of every valid lane and the kk best (score, index) pairs of
// each row, in the TPU kernels' total order: score descending, then index
// descending among equal scores (equal scores are real here: duplicate
// vectors). Two modes:
//   slot (replaces _v3_kernel):      s = 2 <q, x> - norms[lane]  (l2)  or
//        <q, x> (ip); valid lanes are lane < size; the index is the slot.
//   id   (replaces _grouped_kernel): s = 2 <q, x> - |q|^2 - |x|^2 (l2), both
//        norms summed here from the query tile and the slab, or <q, x> (ip);
//        valid lanes are ids[lane] >= 0 over the whole slab (there are no
//        sizes); the index is the vector id.
// It writes scores [Gn, qt, kk] f32 (-inf = none) and indices [Gn, qt, kk]
// int32 (-1 = none). Ghost groups (p < 0, or size <= 0 in mode slot) write
// -inf and -1.
//
// Bound on the H100: operations (2 qt C D flops against C D 4 bytes of
// slab, qt / 2 = 32 flops per byte at qt = 64). The TPU kernel holds the whole
// [qt, C] score tile in its fast memory and runs kk rounds over it; that tile
// (1.9 MB at qt = 64, C = 7552) does not fit a block's shared memory. No row
// range is needed before selecting, so one pass over the slab is enough.
//
// K6 has two bodies, chosen by shape in the launcher (qk_exact_topk_body
// names them), never after a failure.
//
// The tensor-core body (D % 4 == 0, and lists that fit beside the ring) is
// multi_topk's, pair_topk_mma.cuh in mode kBySlot or kById: persistent
// blocks, a TMA ring a segment ahead across group borders, one 3xTF32
// product a segment (3 x flops / 495 TFLOP/s), segments without an id skipped
// (mode id) or only those below the size loaded (mode slot), and each row's
// best kk as a sorted list merged a segment at a time.
//
// exact_topk_kernel, the CUDA-core body (f32, flops / 67 TFLOP/s), simple:
// one block per group, the [qt, D] query tile in shared memory, the slab
// streamed once through shared memory in 128-row segments (mode slot reads
// only the ceil(size / 128) segments that hold vectors). Each row keeps a
// candidate buffer in shared memory of cap = round_up(kk, 32) + 128 pairs
// and a threshold pair (initially below everything): a pair above the
// threshold is appended (ballot + prefix count); when 32 more might not fit,
// the buffer is cut to its kk largest pairs and the threshold becomes the
// kk-th largest. The output is kk descending rounds of "largest pair below
// the previous one" over the buffer. What bounded it on the H100 (20.5 ms on
// the v3 path, 25.1 on v2): the f32 product on synchronous loads, one
// short-lived block a group, the whole slab scanned in mode id, and the
// serial rounds over the buffer.
//
// Pairs of valid lanes are distinct (slots are, and so are the ids of one
// partition), so both bodies select exactly the TPU kernel's kk rounds of
// max-and-clear. Should a partition hold one id twice with equal scores, the
// CUDA-core body emits the pair once and the tensor-core body twice.
//
// bf16 codes (the _bf16 entries; the queries rounded to bf16 as the JAX wrappers
// round them): the same two bodies on bf16 operands. The tensor-core body
// takes one bf16 product a depth-16 step (pair_topk_mma.cuh, kBf16) where
// D % 8 == 0 and its lists fit; the CUDA-core body converts the bf16 values
// to f32 as it loads them (exact) and runs the f32 arithmetic unchanged. In
// mode id |q|^2 comes from the rounded tile; in mode slot the wrapper's
// epilogue subtracts |q|^2 of the unrounded query, as the JAX package's does.

#include <limits.h>

#include "common.cuh"
#include "pair_topk_mma.cuh"

namespace {

// kk descending pairs of a row's buffer into (os, oi)[0, kk); (-inf, -1)
// after the buffer runs out.
__device__ __noinline__ void emit_row(const float* bs, const int* bi, int cnt, int kk,
                                      float* os, int* oi) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float ps = INFINITY;
  int pi = INT_MAX;
  for (int i = 0; i < kk; ++i) {
    next_below(bs, bi, cnt, ps, pi, ps, pi);
    if (lane == 0) {
      os[i] = ps;
      oi[i] = pi;
    }
  }
}

template <int R, bool kIdMode, typename T>
__global__ void __launch_bounds__(kThreads)
exact_topk_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                  const T* __restrict__ qg, const T* __restrict__ codes,
                  const float* __restrict__ norms, const int* __restrict__ ids,
                  float* __restrict__ out_s, int* __restrict__ out_i, int D, int Dp, int C,
                  int kk, int cap, int is_l2) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [qt][Dp]
  float* seg = qs + qt * Dp;                     // [128][Dp + 1]
  float* ssq = seg + kFold * (Dp + 1);           // [128] |x|^2 of the segment (mode id)
  float* bs = ssq + kFold;                       // [qt][cap] candidate scores
  int* bi = reinterpret_cast<int*>(bs + qt * cap);  // [qt][cap] candidate indices
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = gp[g];
  int n = 0;  // lanes to scan
  if (p >= 0) n = kIdMode ? C : min(gsize[g], C);
  float* osg = out_s + (size_t)g * qt * kk;
  int* oig = out_i + (size_t)g * qt * kk;
  if (n <= 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) {
      osg[i] = -INFINITY;
      oig[i] = -1;
    }
    return;
  }
  load_query_tile(qs, qg + (size_t)g * qt * D, qt, D, Dp);
  const T* slab = codes + (size_t)p * C * D;
  const bool l2 = is_l2 != 0;
  const int ss = Dp + 1;

  float qsq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) qsq[r] = 0.0f;
  if (kIdMode && l2) {
    __syncthreads();  // the query tile is written
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* qrow = qs + (warp + kWarps * r) * Dp;
      float a = 0.0f;
      for (int d = lane; d < Dp; d += 32) a = fmaf(qrow[d], qrow[d], a);
      qsq[r] = warp_sum(a);
    }
  }

  int cnt[R], thi[R];
  float ths[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cnt[r] = 0;
    ths[r] = -INFINITY;
    thi[r] = -1;
  }

  const int nseg = (n + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    __syncthreads();  // previous segment fully consumed (and q tile written)
    load_segment(seg, slab, s * kFold, n, D, Dp);
    __syncthreads();
    if (kIdMode && l2) {
      if (threadIdx.x < kFold) {
        const float* row = seg + threadIdx.x * ss;
        float a = 0.0f;
        for (int d = 0; d < Dp; ++d) a = fmaf(row[d], row[d], a);
        ssq[threadIdx.x] = a;
      }
      __syncthreads();
    }
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      int idx;
      bool ok;
      float nv = 0.0f;
      if (kIdMode) {
        idx = ln < C ? ids[(size_t)p * C + ln] : -1;
        ok = idx >= 0;
        if (l2) nv = ssq[lane + 32 * j];
      } else {
        idx = ln;
        ok = ln < n;
        if (l2 && ok) nv = norms[(size_t)p * C + ln];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // 2 dot is exact, so a contraction into fmaf changes nothing.
        float sc = acc[r][j];
        if (l2) sc = kIdMode ? 2.0f * sc - qsq[r] - nv : 2.0f * sc - nv;
        const int row = warp + kWarps * r;
        float* rbs = bs + (size_t)row * cap;
        int* rbi = bi + (size_t)row * cap;
        if (cnt[r] + 32 > cap) cnt[r] = cut_row(rbs, rbi, cnt[r], kk, ths[r], thi[r]);  // warp-uniform
        const bool take = ok && pair_above(sc, idx, ths[r], thi[r]);
        const unsigned m = __ballot_sync(0xffffffffu, take);
        const int pos = cnt[r] + __popc(m & ((1u << lane) - 1u));
        if (take && pos < cap) {
          rbs[pos] = sc;
          rbi[pos] = idx;
        }
        cnt[r] = min(cnt[r] + __popc(m), cap);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    emit_row(bs + (size_t)row * cap, bi + (size_t)row * cap, cnt[r], kk, osg + row * kk,
             oig + row * kk);
  }
}

template <bool kIdMode, typename T>
int launch_exact(const void* gp, const void* gsize, const void* qg, const void* codes,
                 const void* norms, const void* ids, void* out_s, void* out_i, int Gn, int qt,
                 int D, int C, int kk, int is_l2, void* stream) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = exact_cap(kk);
  const size_t smem =
      (size_t)(qt * Dp + kFold * (Dp + 1) + kFold + 2 * qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_EXACT(R)                                                                        \
  case 8 * R: {                                                                            \
    cudaError_t e = allow_smem(exact_topk_kernel<R, kIdMode, T>, smem);                    \
    if (e != cudaSuccess) return (int)e;                                                   \
    exact_topk_kernel<R, kIdMode, T><<<Gn, kThreads, smem, st>>>(                          \
        (const int*)gp, (const int*)gsize, (const T*)qg, (const T*)codes,                  \
        (const float*)norms, (const int*)ids, (float*)out_s, (int*)out_i, D, Dp, C, kk,    \
        cap, is_l2);                                                                       \
    break;                                                                                 \
  }
  switch (qt) {
    QK_EXACT(1)
    QK_EXACT(2)
    QK_EXACT(4)
    QK_EXACT(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_EXACT
  return (int)cudaGetLastError();
}

// K6 on operands of type T (f32 or bf16).
template <typename T>
int exact_topk(const void* gp, const void* gsize, const void* qg, const void* codes,
               const void* norms, const void* ids, void* out_s, void* out_i, int Gn, int qt,
               int D, int P, int C, int kk, int is_l2, int id_mode, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (pair_topk_mma_serves(qt, D, kk, kBf16)) {
    if (id_mode)
      return launch_pair_topk_mma<PairMode::kById, kBf16>(gp, nullptr, qg, codes, nullptr, ids,
                                                          out_s, out_i, Gn, qt, D, P, C, kk,
                                                          is_l2, stream);
    return launch_pair_topk_mma<PairMode::kBySlot, kBf16>(gp, gsize, qg, codes, norms, nullptr,
                                                          out_s, out_i, Gn, qt, D, P, C, kk,
                                                          is_l2, stream);
  }
  if (id_mode)
    return launch_exact<true, T>(gp, gsize, qg, codes, norms, ids, out_s, out_i, Gn, qt, D, C,
                                 kk, is_l2, stream);
  return launch_exact<false, T>(gp, gsize, qg, codes, norms, ids, out_s, out_i, Gn, qt, D, C,
                                kk, is_l2, stream);
}

}  // namespace

// The launchers: qk_exact_topk on f32 qg and codes, qk_exact_topk_bf16 on
// bf16 (the same arguments). This file defines the f32 one;
// grouped_exact_bf16.cu includes it with QK_BF16_UNIT defined, which makes
// QK_T bf16 and names the entry with _bf16, so that the two instantiations
// compile in parallel.
#ifdef QK_BF16_UNIT
#define QK_T __nv_bfloat16
#define QK_ENTRY(name) name##_bf16
#else
#define QK_T float
#define QK_ENTRY(name) name
#endif

extern "C" {

// K6: replaces quake_tpu/ops/pallas_grouped.py::_v3_kernel (id_mode = 0:
// gsize and norms given, ids unused) and _grouped_kernel (id_mode = 1: ids
// given, gsize and norms unused). P: partitions of codes, for the tensor map
// over [P C, D].
int QK_ENTRY(qk_exact_topk)(const void* gp, const void* gsize, const void* qg,
                            const void* codes, const void* norms, const void* ids, void* out_s,
                            void* out_i, int Gn, int qt, int D, int P, int C, int kk, int is_l2,
                            int id_mode, void* stream) {
  return exact_topk<QK_T>(gp, gsize, qg, codes, norms, ids, out_s, out_i, Gn, qt, D, P, C, kk,
                          is_l2, id_mode, stream);
}

#ifndef QK_BF16_UNIT
// The body qk_exact_topk (elem_bytes 4) or qk_exact_topk_bf16 (elem_bytes 2)
// runs at this shape (either mode): 1 the tensor-core body, 0 the CUDA-core
// body of one block a group.
int qk_exact_topk_body(int qt, int D, int kk, int elem_bytes) {
  return pair_topk_mma_serves(qt, D, kk, elem_bytes == 2) ? 1 : 0;
}
#endif

}  // extern "C"
