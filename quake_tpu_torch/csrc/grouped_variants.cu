// Hand-written Hopper (sm_90a) kernels of the four grouped-scan variants of
// the JAX package that are reached through entry points of their own
// (grouped_scan_pallas_approx, _sized, _packed and _multi).
//
// All four score a group's qt query rows against the rows of its partition
// (p = gp[g]) in f32: <q, x> (ip) or 2 <q, x> - |q|^2 - |x|^2 (l2), with both
// norms summed here from the query tile and the slab, in the TPU kernels'
// order. They differ in what they keep:
//   K8  raw_scores  (replaces _scores_kernel): every score, [Gn, qt, C] f32;
//       -inf where ids[lane] < 0 and in ghost groups (p < 0). The selection
//       runs outside the kernel, as in the JAX package.
//   K9  packed_topk (replaces _packed_kernel): per row the kk largest packed
//       int32 = (key << slot_bits) | lane, where key is the top 31 - slot_bits
//       bits of a monotone map of the score's f32 bit pattern; lanes with
//       ids < 0 and ghost groups give -1.
//   sized_topk      (replaces _sized_kernel): per row the kk best (score,
//       slot) among the lanes below the partition's size. Only the segments
//       below the size are read: on the tensor-core body the 128-row segment
//       that holds the size-th row is loaded whole and its lanes at or past
//       the size are masked (the TPU kernel also copies whole ct-row tiles);
//       the CUDA-core body reads no row at or past the size. Equal scores
//       order by the larger slot.
//   multi_topk      (replaces _multi_kernel): per row the kk best (score,
//       slot) among the lanes with ids >= 0; equal scores order by the
//       smaller slot.
//
// Bound on the H100: operations for the three selecting kernels (2 D flops a
// (real query row, valid lane) pair against 4 D bytes of slab a lane: qt / 2
// flops per byte), 3 x flops / 495 TFLOP/s on the tensor-core body (three
// TF32 products per f32 one), flops / 67 TFLOP/s on the CUDA cores. K8 also
// writes qt C 4 bytes per group (4.6 GB at the direct path's B = 16384), which
// on the tensor cores outweighs its operations: K8 is bound by bytes there.
//
// All four have two bodies each, chosen by shape in the launcher (pair_body;
// qk_raw_scores_body, qk_packed_topk_body, qk_sized_topk_body,
// qk_multi_topk_body name them), never after a failure. Where D % 4 == 0 and
// the ring, the query tile and (K9, sized_topk, multi_topk) the rows' lists
// fit, they run the tensor-core body shared with K6 (pair_topk_mma.cuh: modes
// kRaw, kPacked, kSized, kMulti): persistent blocks, a TMA ring a segment
// ahead, one 3xTF32 product a segment, segments whose ids are all < 0 skipped
// (sized_topk: only the segments below the size loaded), a row's best kk as a
// sorted list (K9 on the pair (0, packed value)), and K8's score tile
// streamed out under the next segment's product. K8 and K9 there compute
// their scores by one code in one order, so K9's output is the top kk of K8's
// scores, packed, bit for bit. Elsewhere they run the CUDA-core bodies below
// (simple first): one block per group (multi_topk: per gb groups, one after
// the other), the [qt, D] query tile in shared memory, the slab streamed once
// through shared memory in 128-row segments by loads that nothing overlaps,
// |x|^2 summed from the segment, the f32 product on the CUDA cores
// (tile_dots). The TPU kernels hold a whole [qt, C] score tile in fast memory
// and select in kk rounds over it; here each row keeps a candidate buffer of
// round_up(kk, 32) + 128 entries and a threshold in shared memory (K6's
// buffer of (score, index) pairs for sized_topk and multi_topk, a buffer of
// int32 for K9, whose packed values are distinct), cut to its kk largest when
// full, and the output is kk descending rounds over the buffer. The TPU
// _sized_kernel's tile height ct and its tile-by-tile merge are not carried
// over: the result does not depend on them. multi_topk stores C - 1 - slot as
// the pair's index, so that the pair order (larger index first) puts the
// smaller slot first. The CUDA-core bodies of K8 and K9 sum in one order too
// (tile_dots, query_norms, segment_norms over the zero-padded depth), so K9's
// output there is the top kk of K8's CUDA-core scores, packed.
//
// bf16 codes (the _bf16 entries; the queries rounded to bf16 as the JAX wrappers
// round them): every body on bf16 operands, templated over the element type.
// The tensor-core body takes one bf16 product a depth-16 step where D % 8 ==
// 0 and its lists fit (pair_topk_mma.cuh, kBf16); the CUDA-core bodies
// convert the bf16 values to f32 as they load them (exact) and run the f32
// arithmetic unchanged. Both norms come from the rounded query tile and the
// bf16 slab, upcast. K8 and K9 still share one code and one order on either
// body, so K9 stays the top kk of K8's scores, packed, in bf16 too.

#include "common.cuh"
#include "pair_topk_mma.cuh"

namespace {

// |q|^2 of the R rows this warp owns, from the query tile in shared memory.
template <int R>
__device__ __forceinline__ void query_norms(float (&qsq)[R], const float* qs, int Dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* qrow = qs + (warp + kWarps * r) * Dp;
    float a = 0.0f;
    for (int d = lane; d < Dp; d += 32) a = fmaf(qrow[d], qrow[d], a);
    qsq[r] = warp_sum(a);
  }
}

// |x|^2 of the 128 rows of the segment in shared memory.
__device__ __forceinline__ void segment_norms(float* ssq, const float* seg, int Dp) {
  if (threadIdx.x < kFold) {
    const float* row = seg + threadIdx.x * (Dp + 1);
    float a = 0.0f;
    for (int d = 0; d < Dp; ++d) a = fmaf(row[d], row[d], a);
    ssq[threadIdx.x] = a;
  }
}

// ---------------------------------------------------------------- K8

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
raw_scores_kernel(const int* __restrict__ gp, const T* __restrict__ qg,
                  const T* __restrict__ codes, const int* __restrict__ ids,
                  float* __restrict__ out, int D, int Dp, int C, int is_l2) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [qt][Dp]
  float* seg = qs + qt * Dp;            // [128][Dp + 1]
  float* ssq = seg + kFold * (Dp + 1);  // [128] |x|^2 of the segment
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = gp[g];
  float* og = out + (size_t)g * qt * C;
  if (p < 0) {
    for (size_t i = threadIdx.x; i < (size_t)qt * C; i += kThreads) og[i] = -INFINITY;
    return;
  }
  load_query_tile(qs, qg + (size_t)g * qt * D, qt, D, Dp);
  const T* slab = codes + (size_t)p * C * D;
  const bool l2 = is_l2 != 0;
  float qsq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) qsq[r] = 0.0f;
  if (l2) {
    __syncthreads();  // the query tile is written
    query_norms<R>(qsq, qs, Dp);
  }
  const int nseg = (C + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    __syncthreads();  // previous segment fully consumed (and q tile written)
    load_segment(seg, slab, s * kFold, C, D, Dp);
    __syncthreads();
    if (l2) {
      segment_norms(ssq, seg, Dp);
      __syncthreads();
    }
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      if (ln >= C) continue;
      const bool ok = ids[(size_t)p * C + ln] >= 0;
      const float nv = l2 ? ssq[lane + 32 * j] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // 2 dot is exact, so a contraction into fmaf changes nothing.
        const float sc = l2 ? 2.0f * acc[r][j] - qsq[r] - nv : acc[r][j];
        og[(size_t)(warp + kWarps * r) * C + ln] = ok ? sc : -INFINITY;
      }
    }
  }
}

// ---------------------------------------------------------------- K9

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Largest value of the row's buffer b[0, cnt) strictly below prev; -1 when
// there is none (buffered values are >= 0). The result reaches every lane.
__device__ __forceinline__ int next_below_int(const int* b, int cnt, int prev) {
  int l = -1;
  for (int e = (threadIdx.x & 31); e < cnt; e += 32) {
    const int x = b[e];
    if (x < prev && x > l) l = x;
  }
  return warp_max_int(l);
}

// The kk-th largest value of a row's buffer becomes the threshold th and the
// buffer is cut to the values at or above it. Returns the new count.
__device__ __noinline__ int cut_row_int(int* b, int cnt, int kk, int& th) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  int p = INT_MAX;
  for (int i = 0; i < kk; ++i) p = next_below_int(b, cnt, p);
  int w = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    const int x = e < cnt ? b[e] : -1;
    const bool keep = e < cnt && x >= p;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    __syncwarp();  // every lane has read its entry before any is overwritten
    if (keep) b[w + __popc(m & ((1u << lane) - 1u))] = x;
    w += __popc(m);
  }
  __syncwarp();
  th = p;
  return w;
}

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
packed_topk_kernel(const int* __restrict__ gp, const T* __restrict__ qg,
                   const T* __restrict__ codes, const int* __restrict__ ids,
                   int* __restrict__ out, int D, int Dp, int C, int kk, int cap, int is_l2,
                   int slot_bits) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // [qt][Dp]
  float* seg = qs + qt * Dp;                         // [128][Dp + 1]
  float* ssq = seg + kFold * (Dp + 1);               // [128]
  int* buf = reinterpret_cast<int*>(ssq + kFold);    // [qt][cap] candidates
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = gp[g];
  int* og = out + (size_t)g * qt * kk;
  if (p < 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) og[i] = -1;
    return;
  }
  load_query_tile(qs, qg + (size_t)g * qt * D, qt, D, Dp);
  const T* slab = codes + (size_t)p * C * D;
  const bool l2 = is_l2 != 0;
  float qsq[R];
  int cnt[R], th[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qsq[r] = 0.0f;
    cnt[r] = 0;
    th[r] = -1;
  }
  if (l2) {
    __syncthreads();
    query_norms<R>(qsq, qs, Dp);
  }
  const int nseg = (C + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    __syncthreads();
    load_segment(seg, slab, s * kFold, C, D, Dp);
    __syncthreads();
    if (l2) {
      segment_norms(ssq, seg, Dp);
      __syncthreads();
    }
    float acc[R][4];
    tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ln = s * kFold + lane + 32 * j;
      const bool ok = ln < C && ids[(size_t)p * C + ln] >= 0;
      const float nv = l2 ? ssq[lane + 32 * j] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sc = l2 ? 2.0f * acc[r][j] - qsq[r] - nv : acc[r][j];
        const int v = pack_score(sc, ln, slot_bits);
        int* rb = buf + (size_t)(warp + kWarps * r) * cap;
        if (cnt[r] + 32 > cap) cnt[r] = cut_row_int(rb, cnt[r], kk, th[r]);  // warp-uniform
        const bool take = ok && v > th[r];
        const unsigned m = __ballot_sync(0xffffffffu, take);
        const int pos = cnt[r] + __popc(m & ((1u << lane) - 1u));
        if (take && pos < cap) rb[pos] = v;
        cnt[r] = min(cnt[r] + __popc(m), cap);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    const int* rb = buf + (size_t)row * cap;
    __syncwarp();
    int prev = INT_MAX;
    for (int i = 0; i < kk; ++i) {
      prev = next_below_int(rb, cnt[r], prev);
      if (lane == 0) og[row * kk + i] = prev;
    }
  }
}

// ------------------------------------------------- sized_topk, multi_topk

// kMulti = false: sized_topk (lanes below gsize[g], ties to the larger slot,
// none = -1, gb = 1). kMulti = true: multi_topk (lanes with ids >= 0 of the
// whole slab, ties to the smaller slot, none = C, gb groups per block).
template <int R, bool kMulti, typename T>
__global__ void __launch_bounds__(kThreads)
slot_topk_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                 const T* __restrict__ qg, const T* __restrict__ codes,
                 const int* __restrict__ ids, float* __restrict__ out_s,
                 int* __restrict__ out_i, int D, int Dp, int C, int kk, int cap, int is_l2,
                 int gb) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // [qt][Dp]
  float* seg = qs + qt * Dp;                        // [128][Dp + 1]
  float* ssq = seg + kFold * (Dp + 1);              // [128]
  float* bs = ssq + kFold;                          // [qt][cap] candidate scores
  int* bi = reinterpret_cast<int*>(bs + qt * cap);  // [qt][cap] candidate indices
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool l2 = is_l2 != 0;
  const int none = kMulti ? C : -1;
  for (int step = 0; step < gb; ++step) {
    const int g = blockIdx.x * gb + step;
    const int p = gp[g];
    int n = 0;  // lanes to scan
    if (p >= 0) n = kMulti ? C : min(gsize[g], C);
    float* osg = out_s + (size_t)g * qt * kk;
    int* oig = out_i + (size_t)g * qt * kk;
    if (n <= 0) {  // block-uniform
      for (int i = threadIdx.x; i < qt * kk; i += kThreads) {
        osg[i] = -INFINITY;
        oig[i] = none;
      }
      continue;
    }
    __syncthreads();  // the previous group's tile and buffers are consumed
    load_query_tile(qs, qg + (size_t)g * qt * D, qt, D, Dp);
    const T* slab = codes + (size_t)p * C * D;
    float qsq[R], ths[R];
    int cnt[R], thi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qsq[r] = 0.0f;
      cnt[r] = 0;
      ths[r] = -INFINITY;
      thi[r] = -1;
    }
    if (l2) {
      __syncthreads();
      query_norms<R>(qsq, qs, Dp);
    }
    const int nseg = (n + kFold - 1) / kFold;
    for (int s = 0; s < nseg; ++s) {
      __syncthreads();
      load_segment(seg, slab, s * kFold, n, D, Dp);  // rows at or past n are not read
      __syncthreads();
      if (l2) {
        segment_norms(ssq, seg, Dp);
        __syncthreads();
      }
      float acc[R][4];
      tile_dots<R>(acc, qs, seg, Dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ln = s * kFold + lane + 32 * j;
        const bool ok = ln < n && (!kMulti || ids[(size_t)p * C + ln] >= 0);
        const int idx = kMulti ? C - 1 - ln : ln;
        const float nv = l2 ? ssq[lane + 32 * j] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sc = l2 ? 2.0f * acc[r][j] - qsq[r] - nv : acc[r][j];
          const int row = warp + kWarps * r;
          float* rbs = bs + (size_t)row * cap;
          int* rbi = bi + (size_t)row * cap;
          if (cnt[r] + 32 > cap) cnt[r] = cut_row(rbs, rbi, cnt[r], kk, ths[r], thi[r]);
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
      const float* rbs = bs + (size_t)row * cap;
      const int* rbi = bi + (size_t)row * cap;
      __syncwarp();
      float ps = INFINITY;
      int pi = INT_MAX;
      for (int i = 0; i < kk; ++i) {
        next_below(rbs, rbi, cnt[r], ps, pi, ps, pi);
        if (lane == 0) {
          osg[row * kk + i] = ps;
          oig[row * kk + i] = pi < 0 ? none : (kMulti ? C - 1 - pi : pi);
        }
      }
    }
  }
}

template <bool kMulti, typename T>
int launch_slot_topk(const void* gp, const void* gsize, const void* qg, const void* codes,
                     const void* ids, void* out_s, void* out_i, int Gn, int qt, int D, int C,
                     int kk, int is_l2, int gb, void* stream) {
  if (gb <= 0 || Gn % gb) return (int)cudaErrorInvalidValue;
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = exact_cap(kk);
  const size_t smem =
      (size_t)(qt * Dp + kFold * (Dp + 1) + kFold + 2 * qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_SLOT(R)                                                                        \
  case 8 * R: {                                                                           \
    cudaError_t e = allow_smem(slot_topk_kernel<R, kMulti, T>, smem);                     \
    if (e != cudaSuccess) return (int)e;                                                  \
    slot_topk_kernel<R, kMulti, T><<<Gn / gb, kThreads, smem, st>>>(                      \
        (const int*)gp, (const int*)gsize, (const T*)qg, (const T*)codes,                 \
        (const int*)ids, (float*)out_s, (int*)out_i, D, Dp, C, kk, cap, is_l2, gb);       \
    break;                                                                                \
  }
  switch (qt) {
    QK_SLOT(1)
    QK_SLOT(2)
    QK_SLOT(4)
    QK_SLOT(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_SLOT
  return (int)cudaGetLastError();
}

// ------------------------- K8, K9, sized_topk and multi_topk on the tensor cores

// Which body serves multi_topk, sized_topk and K9 at a shape (kk: the rows'
// list length), and K8 (kk = 0: no list), on f32 or bf16 operands;
// qk_multi_topk_body, qk_sized_topk_body, qk_packed_topk_body and
// qk_raw_scores_body name them: 1 the tensor-core body (pair_topk_mma.cuh,
// modes kMulti, kSized, kPacked, kRaw), where rows are 16-byte aligned for
// the asynchronous copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and its
// ring, query tile and lists fit; else 0, the CUDA-core body
// (slot_topk_kernel, packed_topk_kernel, raw_scores_kernel).
inline int pair_body(int qt, int D, int kk, bool bf16) {
  return pair_topk_mma_serves(qt, D, kk, bf16) ? 1 : 0;
}

template <typename T>
int raw_scores(const void* gp, const void* qg, const void* codes, const void* ids, void* out,
               int Gn, int qt, int D, int P, int C, int is_l2, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (pair_body(qt, D, 0, kBf16) == 1)
    return launch_pair_topk_mma<PairMode::kRaw, kBf16>(gp, nullptr, qg, codes, nullptr, ids, out,
                                                       nullptr, Gn, qt, D, P, C, 0, is_l2,
                                                       stream);
  const int Dp = padded_dim(D);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1) + kFold) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_RAW(R)                                                                          \
  case 8 * R: {                                                                            \
    cudaError_t e = allow_smem(raw_scores_kernel<R, T>, smem);                             \
    if (e != cudaSuccess) return (int)e;                                                   \
    raw_scores_kernel<R, T><<<Gn, kThreads, smem, st>>>(                                   \
        (const int*)gp, (const T*)qg, (const T*)codes, (const int*)ids, (float*)out, D, Dp, \
        C, is_l2);                                                                         \
    break;                                                                                 \
  }
  switch (qt) {
    QK_RAW(1)
    QK_RAW(2)
    QK_RAW(4)
    QK_RAW(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_RAW
  return (int)cudaGetLastError();
}

template <typename T>
int packed_topk(const void* gp, const void* qg, const void* codes, const void* ids, void* out,
                int Gn, int qt, int D, int P, int C, int kk, int is_l2, int slot_bits,
                void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (pair_body(qt, D, kk, kBf16) == 1)
    return launch_pair_topk_mma<PairMode::kPacked, kBf16>(gp, nullptr, qg, codes, nullptr, ids,
                                                          nullptr, out, Gn, qt, D, P, C, kk,
                                                          is_l2, stream, slot_bits);
  const int Dp = padded_dim(D);
  const int cap = exact_cap(kk);
  const size_t smem =
      (size_t)(qt * Dp + kFold * (Dp + 1) + kFold + qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_PACKED(R)                                                                         \
  case 8 * R: {                                                                              \
    cudaError_t e = allow_smem(packed_topk_kernel<R, T>, smem);                              \
    if (e != cudaSuccess) return (int)e;                                                     \
    packed_topk_kernel<R, T><<<Gn, kThreads, smem, st>>>(                                    \
        (const int*)gp, (const T*)qg, (const T*)codes, (const int*)ids, (int*)out, D, Dp, C, \
        kk, cap, is_l2, slot_bits);                                                          \
    break;                                                                                   \
  }
  switch (qt) {
    QK_PACKED(1)
    QK_PACKED(2)
    QK_PACKED(4)
    QK_PACKED(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_PACKED
  return (int)cudaGetLastError();
}

template <typename T>
int sized_topk(const void* gp, const void* gsize, const void* qg, const void* codes, void* out_s,
               void* out_i, int Gn, int qt, int D, int P, int C, int kk, int is_l2,
               void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (pair_body(qt, D, kk, kBf16) == 1)
    return launch_pair_topk_mma<PairMode::kSized, kBf16>(gp, gsize, qg, codes, nullptr, nullptr,
                                                         out_s, out_i, Gn, qt, D, P, C, kk,
                                                         is_l2, stream);
  return launch_slot_topk<false, T>(gp, gsize, qg, codes, nullptr, out_s, out_i, Gn, qt, D, C,
                                    kk, is_l2, 1, stream);
}

template <typename T>
int multi_topk(const void* gp, const void* qg, const void* codes, const void* ids, void* out_s,
               void* out_i, int Gn, int qt, int D, int P, int C, int kk, int is_l2, int gb,
               void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (gb <= 0 || Gn % gb) return (int)cudaErrorInvalidValue;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (pair_body(qt, D, kk, kBf16) == 1)
    return launch_pair_topk_mma<PairMode::kMulti, kBf16>(gp, nullptr, qg, codes, nullptr, ids,
                                                         out_s, out_i, Gn, qt, D, P, C, kk,
                                                         is_l2, stream);
  return launch_slot_topk<true, T>(gp, nullptr, qg, codes, ids, out_s, out_i, Gn, qt, D, C, kk,
                                   is_l2, gb, stream);
}

}  // namespace

// The launchers: qk_raw_scores, qk_packed_topk, qk_sized_topk and
// qk_multi_topk on f32 qg and codes, the same names with _bf16 on bf16 (the
// same arguments). This file defines the f32 ones; grouped_variants_bf16.cu
// includes it with QK_BF16_UNIT defined, which makes QK_T bf16 and names the
// entries with _bf16, so that the two instantiations compile in parallel.
// The *_body queries take the element size (4 f32, 2 bf16).
#ifdef QK_BF16_UNIT
#define QK_T __nv_bfloat16
#define QK_ENTRY(name) name##_bf16
#else
#define QK_T float
#define QK_ENTRY(name) name
#endif

extern "C" {

// K8: replaces quake_tpu/ops/pallas_grouped.py::_scores_kernel. P:
// partitions of codes, for the tensor map over [P C, D].
int QK_ENTRY(qk_raw_scores)(const void* gp, const void* qg, const void* codes, const void* ids,
                            void* out, int Gn, int qt, int D, int P, int C, int is_l2,
                            void* stream) {
  return raw_scores<QK_T>(gp, qg, codes, ids, out, Gn, qt, D, P, C, is_l2, stream);
}

// K9: replaces quake_tpu/ops/pallas_grouped.py::_packed_kernel. P as for K8.
int QK_ENTRY(qk_packed_topk)(const void* gp, const void* qg, const void* codes, const void* ids,
                             void* out, int Gn, int qt, int D, int P, int C, int kk, int is_l2,
                             int slot_bits, void* stream) {
  return packed_topk<QK_T>(gp, qg, codes, ids, out, Gn, qt, D, P, C, kk, is_l2, slot_bits,
                           stream);
}

// Replaces quake_tpu/ops/pallas_grouped.py::_sized_kernel (ids unused). P
// as for K8.
int QK_ENTRY(qk_sized_topk)(const void* gp, const void* gsize, const void* qg,
                            const void* codes, void* out_s, void* out_i, int Gn, int qt, int D,
                            int P, int C, int kk, int is_l2, void* stream) {
  return sized_topk<QK_T>(gp, gsize, qg, codes, out_s, out_i, Gn, qt, D, P, C, kk, is_l2,
                          stream);
}

// Replaces quake_tpu/ops/pallas_grouped.py::_multi_kernel (sizes unused;
// Gn % gb == 0; the tensor-core body does not depend on gb).
int QK_ENTRY(qk_multi_topk)(const void* gp, const void* qg, const void* codes, const void* ids,
                            void* out_s, void* out_i, int Gn, int qt, int D, int P, int C,
                            int kk, int is_l2, int gb, void* stream) {
  return multi_topk<QK_T>(gp, qg, codes, ids, out_s, out_i, Gn, qt, D, P, C, kk, is_l2, gb,
                          stream);
}

#ifndef QK_BF16_UNIT
// The body qk_multi_topk runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body (gb groups a block).
int qk_multi_topk_body(int qt, int D, int kk, int elem_bytes) {
  return pair_body(qt, D, kk, elem_bytes == 2);
}

// The body qk_packed_topk runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body (one block a group).
int qk_packed_topk_body(int qt, int D, int kk, int elem_bytes) {
  return pair_body(qt, D, kk, elem_bytes == 2);
}

// The body qk_sized_topk runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body (one block a group).
int qk_sized_topk_body(int qt, int D, int kk, int elem_bytes) {
  return pair_body(qt, D, kk, elem_bytes == 2);
}

// The body qk_raw_scores runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body (one block a group).
int qk_raw_scores_body(int qt, int D, int elem_bytes) {
  return pair_body(qt, D, 0, elem_bytes == 2);
}
#endif

}  // extern "C"
