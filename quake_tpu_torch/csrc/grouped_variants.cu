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
//       slot) among the lanes below the partition's size; no row at or past
//       the size is read. Equal scores order by the larger slot.
//   multi_topk      (replaces _multi_kernel): per row the kk best (score,
//       slot) among the lanes with ids >= 0; equal scores order by the
//       smaller slot.
//
// Bound on the H100: operations for the three selecting kernels (2 D flops a
// (real query row, valid lane) pair against 4 D bytes of slab a lane: qt / 2
// flops per byte, above the f32 ridge of 20 from qt = 64), flops / 67
// TFLOP/s on the CUDA cores; multi_topk's tensor-core body takes three TF32
// products per f32 one, 3 x flops / 495 TFLOP/s. K8 also writes qt C 4 bytes
// per group, which at D = 128 stays below the time of its operations.
//
// Design (simple first), shared with K6 (grouped_exact.cu): one block per
// group (multi_topk's CUDA-core body: per gb groups, one after the other),
// the [qt, D] query tile in shared memory, the slab streamed once through
// shared memory in 128-row segments, |x|^2 summed from the segment. The TPU kernels hold a
// whole [qt, C] score tile in fast memory and select in kk rounds over it;
// here each row keeps a candidate buffer of round_up(kk, 32) + 128 entries
// and a threshold in shared memory (K6's buffer of (score, index) pairs for
// sized_topk and multi_topk, a buffer of int32 for K9, whose packed values
// are distinct), cut to its kk largest when full, and the output is kk
// descending rounds over the buffer. The TPU _sized_kernel's tile height ct
// and its tile-by-tile merge are not carried over: the result does not depend
// on them. multi_topk stores C - 1 - slot as the pair's index, so that the
// pair order (larger index first) puts the smaller slot first.
//
// multi_topk has two bodies, chosen by shape in the launcher
// (multi_topk_body, qk_multi_topk_body), never after a failure. The one above
// (D % 4 != 0, or lists that crowd out the ring) is what bounded it on the
// H100 (34 ms on the direct multi path): the f32 product on loads that
// nothing overlapped, gb groups a block (few blocks, a ragged last wave), the
// whole slab scanned, segments without an id included. The tensor-core body
// (multi_topk_mma_kernel) is persistent, multiplies on the tensor cores fed
// by a TMA ring, skips the segments whose ids are all < 0, and keeps a row's
// best kk as a sorted list merged a segment at a time; its note says more.

#include "common.cuh"

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

template <int R>
__global__ void __launch_bounds__(kThreads)
raw_scores_kernel(const int* __restrict__ gp, const float* __restrict__ qg,
                  const float* __restrict__ codes, const int* __restrict__ ids,
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
  const float* slab = codes + (size_t)p * C * D;
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

// The packed value of a score at a lane: a monotone map of the f32 bit
// pattern onto uint32 (negative: all bits flipped; else the sign bit set),
// its top 31 - slot_bits bits above the lane.
__device__ __forceinline__ int pack_score(float sc, int lane, int slot_bits) {
  const unsigned bits = __float_as_uint(sc);
  const unsigned key = (bits >> 31) ? ~bits : (bits | 0x80000000u);
  return (int)(((key >> (slot_bits + 1)) << slot_bits) | (unsigned)lane);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
packed_topk_kernel(const int* __restrict__ gp, const float* __restrict__ qg,
                   const float* __restrict__ codes, const int* __restrict__ ids,
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
  const float* slab = codes + (size_t)p * C * D;
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
template <int R, bool kMulti>
__global__ void __launch_bounds__(kThreads)
slot_topk_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                 const float* __restrict__ qg, const float* __restrict__ codes,
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
    const float* slab = codes + (size_t)p * C * D;
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

template <bool kMulti>
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
    cudaError_t e = allow_smem(slot_topk_kernel<R, kMulti>, smem);                        \
    if (e != cudaSuccess) return (int)e;                                                  \
    slot_topk_kernel<R, kMulti><<<Gn / gb, kThreads, smem, st>>>(                         \
        (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)codes,         \
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

// ------------------------------------------------ multi_topk on the tensor cores

// The sum of squares of this thread's half of the columns of one 128-row
// segment tile of `boxes` boxes (row threadIdx.x % 128; half 0 takes the
// even 16-byte chunks, half 1 the odd ones, each in column order), added to
// a. Every row is summed in the same order, so copies of one vector get
// the same sum.
__device__ __forceinline__ float segment_row_sumsq(const float* seg, int boxes, float a) {
  const int r = threadIdx.x & (kFold - 1), h = threadIdx.x / kFold;
  for (int q4 = h; q4 < boxes * (kBox / 4); q4 += 2) {
    const float4 v = *reinterpret_cast<const float4*>(seg + (q4 >> 3) * kSegBox + r * kBox +
                                                      (((q4 & 7) ^ (r & 7)) << 2));
    a = fmaf(v.x, v.x, a);
    a = fmaf(v.y, v.y, a);
    a = fmaf(v.z, v.z, a);
    a = fmaf(v.w, v.w, a);
  }
  return a;
}

// Shared memory of multi_topk's tensor-core body, in bytes: room to reach a
// 1024-byte boundary, ring, query tile, the rows' lists (3 kk (score, index)
// pairs a row, see merge_rows), the segment's ids, the two halves of its rows'
// |x|^2, |q|^2 per row, the two stage barriers.
inline size_t multi_topk_mma_smem(int qt, int D, int kk, int NBS) {
  return 1024 + 16 +
         (size_t)(2 * ring_stage_floats(qt, NBS) + tile_boxes(D) * (qt < 16 ? 16 : qt) * kBox +
                  qt * 6 * kk + kFold + 2 * kFold + qt) *
             sizeof(float);
}

// Boxes a ring stage of multi_topk's tensor-core body holds: all of D's, or
// the most of 4, 2 and 1 that fits; 0: the body does not fit.
inline int multi_topk_mma_stage_boxes(int qt, int D, int kk) {
  for (int nbs = 4; nbs >= 1; nbs >>= 1) {
    const int NBS = nbs < tile_boxes(D) ? nbs : tile_boxes(D);
    if (multi_topk_mma_smem(qt, D, kk, NBS) <= kSmemLimit) return NBS;
  }
  return 0;
}

// Which body serves multi_topk at a shape (qk_multi_topk_body names them): 1
// the tensor-core body, where rows are 16-byte aligned for the asynchronous
// copies (D % 4 == 0) and its ring, query tile and lists fit; else 0,
// slot_topk_kernel.
inline int multi_topk_body(int qt, int D, int kk) {
  return D % 4 == 0 && multi_topk_mma_stage_boxes(qt, D, kk) > 0 ? 1 : 0;
}

// multi_topk on the tensor cores: persistent, block b takes groups b,
// b + grid, ... (partition-major, so blocks that run together read the same
// partitions), and streams each group's slab through a ring of two 128-row
// segment buffers filled by the Tensor Memory Accelerator one stage ahead,
// across group borders, as K4's tensor-core body does; mma_tile (3xTF32)
// multiplies. A segment whose lanes below C all have ids < 0 holds no
// candidate: warp 0, which issues the copies, and the consumer both skip it by
// a vote over its ids, so it is neither loaded nor multiplied. Lanes at or
// past C (the next partition's rows, read through the tensor map) are masked.
// |x|^2 of a segment's rows is summed from the ring buffer by all threads in
// one fixed order a row, |q|^2 of a query row by four threads (strided, then a
// butterfly sum), the same order for every row. The scores pass through a
// [QT][kTileStride] tile laid over the consumed stage into rows a warp owns.
// A row keeps its kk best (score, C - 1 - slot) pairs as a sorted list (the
// pair order, larger index first, puts the smaller slot first): a segment's
// values above the list's kk-th pair are its candidates, cut to their kk best
// by kk rounds of a warp maximum where there are more, and merged into the
// list (insert_rows, or merge_rows past kk = 32). The list is the row's
// output.
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
multi_topk_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                      const float* __restrict__ qg, const int* __restrict__ ids,
                      float* __restrict__ out_s, int* __restrict__ out_i, int Gn, int D, int NB,
                      int NBS, int stage_floats, int C, int kk, int is_l2) {
  constexpr int MT = QT >= 32 ? 2 : 1;       // m16-tiles per warp
  constexpr int MW = QT >= 64 ? 2 : 1;       // warps along the query rows
  constexpr int NW = kWarps / MW;            // warps along the segment
  constexpr int NT = 16 / NW;                // n8-tiles per warp
  constexpr int T = MT * NT;                 // accumulator tiles per warp
  constexpr int QR = 16 * MT * MW;           // rows of the query tile (zero from QT)
  constexpr int R = QT / 8;                  // rows per warp in the selection
  extern __shared__ __align__(16) float smem[];
  float* ring = smem_aligned(smem);       // 2 x stage_floats: NBS boxes of [128][32], or the tile
  float* qs = ring + 2 * stage_floats;    // NB boxes of [QR][32]
  float* ls = qs + NB * QR * kBox;        // [QT][3 kk] list scores
  int* li = reinterpret_cast<int*>(ls + QT * 3 * kk);       // [QT][3 kk] list indices
  int* sid = li + QT * 3 * kk;                              // [128] the segment's ids
  float* xsq = reinterpret_cast<float*>(sid + kFold);       // [2][128] halves of |x|^2
  float* qsq = xsq + 2 * kFold;                             // [QT] |q|^2
  uint64_t* bars = reinterpret_cast<uint64_t*>(qsq + QT);   // one a ring stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int row0 = (warp / NW) * (16 * MT), col0 = (warp % NW) * (8 * NT);
  const int ksteps = (D + 7) >> 3;
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment: a stage holds NBS boxes
  const int nseg = (C + kFold - 1) / kFold;
  const bool l2 = is_l2 != 0;

  const int first = blockIdx.x, step = gridDim.x, end = Gn;
  // Ghost groups write (-inf, C) and take no part in the walk.
  for (int g = first; g < end; g += step)
    if (gp[g] < 0)
      for (int i = threadIdx.x; i < QT * kk; i += kThreads) {
        out_s[(size_t)g * QT * kk + i] = -INFINITY;
        out_i[(size_t)g * QT * kk + i] = C;
      }
  auto next_live = [&](int g) {
    while (g < end && gp[g] < 0) g += step;
    return g;
  };

  // The producer, warp 0 alone, a stage ahead of the consumer over the same
  // live segments.
  mbar_init(bars);
  int pg = next_live(first), ps = 0, pd = 0;
  auto seg_live = [&](int g, int s) {  // a vote of warp 0 over the segment's ids
    const int* gid = ids + (size_t)gp[g] * C;
    bool any = false;
    for (int j = lane; j < kFold; j += 32) any |= s * kFold + j < C && gid[s * kFold + j] >= 0;
    return __any_sync(0xffffffffu, any);
  };
  auto seek = [&]() {  // (pg, ps) to the next live segment from where they stand
    while (pg < end && !seg_live(pg, ps))
      if (++ps == nseg) {
        ps = 0;
        pg = next_live(pg + step);
      }
  };
  auto prefetch = [&](int stage) {
    if (warp != 0 || pg >= end) return;
    segment_load_async(ring + stage * stage_floats, &cmap, gp[pg] * C + ps * kFold, pd * NBS,
                       min(NBS, NB - pd * NBS), bars + stage);
    if (++pd < ND) return;
    pd = 0;
    if (++ps == nseg) {
      ps = 0;
      pg = next_live(pg + step);
    }
    seek();
  };
  if (warp == 0) {
    seek();
    prefetch(0);
  }

  int stage = 0;
  uint32_t parity = 0;  // bit s: the parity of stage s's next completed phase
  float acc[T][4];      // the products of this thread's entries, tile (i, j) at i NT + j
  for (int g = next_live(first); g < end; g = next_live(g + step)) {
    const int* gid = ids + (size_t)gp[g] * C;
    // The last product on the previous group's tile ended before a barrier.
    query_tile_load(qs, qg + (size_t)g * QT * D, QT, QR, D, NB);
    if (l2 && threadIdx.x < 4 * QT) {  // |q|^2: four threads a row, each every fourth 16 bytes
      const float4* qrow =
          reinterpret_cast<const float4*>(qg + ((size_t)g * QT + threadIdx.x / 4) * D);
      float a = 0.0f;
      for (int d4 = threadIdx.x & 3; d4 < (D >> 2); d4 += 4) {
        const float4 x = __ldg(qrow + d4);
        a = fmaf(x.x, x.x, a);
        a = fmaf(x.y, x.y, a);
        a = fmaf(x.z, x.z, a);
        a = fmaf(x.w, x.w, a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if ((threadIdx.x & 3) == 0) qsq[threadIdx.x / 4] = a;
    }
    int cur[R], thi[R];
    float ths[R];  // (ths, thi): the row's kk-th best pair so far
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int e = lane; e < kk; e += 32) {
        ls[(size_t)row * 3 * kk + e] = -INFINITY;
        li[(size_t)row * 3 * kk + e] = -1;
      }
      cur[r] = 0;
      ths[r] = -INFINITY;
      thi[r] = -1;
    }
    for (int s = 0; s < nseg; ++s) {
      const int ln0 = s * kFold;
      const int id = threadIdx.x < kFold && ln0 + (int)threadIdx.x < C ? gid[ln0 + threadIdx.x] : -1;
      if (threadIdx.x < kFold) sid[threadIdx.x] = id;
      if (!__syncthreads_or(id >= 0)) continue;  // no lane holds a vector: not loaded either
      float xp = 0.0f;  // this thread's half of |x|^2 of segment row threadIdx.x % 128
      for (int cd = 0; cd < ND; ++cd) {
        float* stage_mem = ring + stage * stage_floats;
        prefetch(stage ^ 1);
        mbar_wait(bars + stage, (parity >> stage) & 1u);
        parity ^= 1u << stage;
        __syncthreads();  // and the query tile and |q|^2 are in place
        mma_tile<MT, NT>(acc, qs + cd * NBS * QR * kBox, stage_mem, row0, col0, QR,
                         min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
        if (l2) xp = segment_row_sumsq(stage_mem, min(NBS, NB - cd * NBS), xp);
        if (cd + 1 < ND) {
          __syncthreads();  // the stage is consumed: its buffer may be refilled
          stage ^= 1;
        }
      }
      float* stage_mem = ring + stage * stage_floats;
      if (l2) xsq[threadIdx.x] = xp;  // [half][row]
      __syncthreads();  // every warp has finished reading the stage; |x|^2 is in place
      // The scores, through the tile laid over the consumed stage.
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        const int row = row0 + 16 * (m / 2) + g4 + 8 * (m % 2);
        if (row < QT) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = col0 + 8 * j + 2 * t4 + c;
              const float dot = acc[(m / 2) * NT + j][2 * (m % 2) + c];
              // 2 dot is exact, so a contraction into fmaf changes nothing.
              v[c] = l2 ? 2.0f * dot - qsq[row] - (xsq[col] + xsq[kFold + col]) : dot;
            }
            *reinterpret_cast<float2*>(stage_mem + row * kTileStride + col0 + 8 * j + 2 * t4) =
                make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      // Each warp's rows: a segment's values above the row's kk-th best pair so
      // far, cut to their kk best where there are more, then merged.
      float v[R][4];
      bool ok[4];
      int idx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = sid[lane + 32 * j] >= 0;
        idx[j] = C - 1 - (ln0 + lane + 32 * j);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[r][j] = stage_mem[(warp + kWarps * r) * kTileStride + lane + 32 * j];
      int nc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bool take[4];
        bool any = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          take[j] = ok[j] && pair_above(v[r][j], idx[j], ths[r], thi[r]);
          any |= take[j];
        }
        nc[r] = 0;
        if (!__any_sync(0xffffffffu, any)) continue;  // no value above the row's kk-th best
        unsigned keep[4];
        int n = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          keep[j] = __ballot_sync(0xffffffffu, take[j]);
          n += __popc(keep[j]);
        }
        if (n > kk) {  // the kk-th best candidate, by kk rounds of a warp maximum below the last
          float ks = INFINITY;
          int ki = INT_MAX;
          for (int i = 0; i < kk; ++i) {
            float bs = -INFINITY;
            int bi = -1;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (take[j] && pair_above(ks, ki, v[r][j], idx[j]) &&
                  pair_above(v[r][j], idx[j], bs, bi)) {
                bs = v[r][j];
                bi = idx[j];
              }
            warp_max_pair(bs, bi);
            ks = bs;
            ki = bi;
          }
          n = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            keep[j] = __ballot_sync(0xffffffffu, take[j] && !pair_above(ks, ki, v[r][j], idx[j]));
            n += __popc(keep[j]);
          }
        }
        float* rs = ls + (size_t)(warp + kWarps * r) * 3 * kk + 2 * kk;
        int* ri = li + (size_t)(warp + kWarps * r) * 3 * kk + 2 * kk;
        int pos = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((keep[j] >> lane) & 1u) {
            const int at = pos + __popc(keep[j] & ((1u << lane) - 1u));
            rs[at] = v[r][j];
            ri[at] = idx[j];
          }
          pos += __popc(keep[j]);
        }
        nc[r] = n;
      }
      __syncwarp();
      if (kk <= 32) {
        insert_rows<R>(ls, li, cur, nc, kk);
      } else {
        merge_rows<R>(ls, li, cur, nc, kk);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (nc[r] == 0) continue;
        const size_t last = (size_t)(warp + kWarps * r) * 3 * kk + cur[r] * kk + kk - 1;
        ths[r] = ls[last];
        thi[r] = li[last];
      }
      fence_async_proxy();  // the tile's stores, before the copy that refills the stage
      __syncthreads();      // the stage and the ids are consumed
      stage ^= 1;
    }
    // Each row's list is its output.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int e = lane; e < kk; e += 32) {
        const size_t at = (size_t)row * 3 * kk + cur[r] * kk + e;
        out_s[((size_t)g * QT + row) * kk + e] = ls[at];
        out_i[((size_t)g * QT + row) * kk + e] = li[at] < 0 ? C : C - 1 - li[at];
      }
    }
    __syncwarp();
  }
}

int launch_multi_topk_mma(const void* gp, const void* qg, const void* codes, const void* ids,
                          void* out_s, void* out_i, int Gn, int qt, int D, int P, int C, int kk,
                          int is_l2, void* stream) {
  const int NB = tile_boxes(D);
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D);
  if (me != 0) return me;
  const int NBS = multi_topk_mma_stage_boxes(qt, D, kk);
  const size_t smem = multi_topk_mma_smem(qt, D, kk, NBS);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  cudaStream_t st = (cudaStream_t)stream;
#define QK_MULTI_MMA(QT)                                                                   \
  case QT: {                                                                               \
    cudaError_t e = allow_smem(multi_topk_mma_kernel<QT>, smem);                           \
    if (e != cudaSuccess) return (int)e;                                                   \
    multi_topk_mma_kernel<QT><<<grid, kThreads, smem, st>>>(                               \
        cmap, (const int*)gp, (const float*)qg, (const int*)ids, (float*)out_s, (int*)out_i, \
        Gn, D, NB, NBS, ring_stage_floats(qt, NBS), C, kk, is_l2);                         \
    break;                                                                                 \
  }
  switch (qt) {
    QK_MULTI_MMA(8)
    QK_MULTI_MMA(16)
    QK_MULTI_MMA(32)
    QK_MULTI_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_MULTI_MMA
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: replaces quake_tpu/ops/pallas_grouped.py::_scores_kernel.
int qk_raw_scores(const void* gp, const void* qg, const void* codes, const void* ids, void* out,
                  int Gn, int qt, int D, int C, int is_l2, void* stream) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1) + kFold) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_RAW(R)                                                                         \
  case 8 * R: {                                                                           \
    cudaError_t e = allow_smem(raw_scores_kernel<R>, smem);                               \
    if (e != cudaSuccess) return (int)e;                                                  \
    raw_scores_kernel<R><<<Gn, kThreads, smem, st>>>(                                     \
        (const int*)gp, (const float*)qg, (const float*)codes, (const int*)ids,           \
        (float*)out, D, Dp, C, is_l2);                                                    \
    break;                                                                                \
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

// K9: replaces quake_tpu/ops/pallas_grouped.py::_packed_kernel.
int qk_packed_topk(const void* gp, const void* qg, const void* codes, const void* ids, void* out,
                   int Gn, int qt, int D, int C, int kk, int is_l2, int slot_bits,
                   void* stream) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = exact_cap(kk);
  const size_t smem =
      (size_t)(qt * Dp + kFold * (Dp + 1) + kFold + qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_PACKED(R)                                                                      \
  case 8 * R: {                                                                           \
    cudaError_t e = allow_smem(packed_topk_kernel<R>, smem);                              \
    if (e != cudaSuccess) return (int)e;                                                  \
    packed_topk_kernel<R><<<Gn, kThreads, smem, st>>>(                                    \
        (const int*)gp, (const float*)qg, (const float*)codes, (const int*)ids, (int*)out, \
        D, Dp, C, kk, cap, is_l2, slot_bits);                                             \
    break;                                                                                \
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

// Replaces quake_tpu/ops/pallas_grouped.py::_sized_kernel (ids unused).
int qk_sized_topk(const void* gp, const void* gsize, const void* qg, const void* codes,
                  void* out_s, void* out_i, int Gn, int qt, int D, int C, int kk, int is_l2,
                  void* stream) {
  return launch_slot_topk<false>(gp, gsize, qg, codes, nullptr, out_s, out_i, Gn, qt, D, C, kk,
                                 is_l2, 1, stream);
}

// Replaces quake_tpu/ops/pallas_grouped.py::_multi_kernel (sizes unused;
// Gn % gb == 0; the tensor-core body does not depend on gb).
int qk_multi_topk(const void* gp, const void* qg, const void* codes, const void* ids,
                  void* out_s, void* out_i, int Gn, int qt, int D, int P, int C, int kk,
                  int is_l2, int gb, void* stream) {
  if (gb <= 0 || Gn % gb) return (int)cudaErrorInvalidValue;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (multi_topk_body(qt, D, kk) == 1)
    return launch_multi_topk_mma(gp, qg, codes, ids, out_s, out_i, Gn, qt, D, P, C, kk, is_l2,
                                 stream);
  return launch_slot_topk<true>(gp, nullptr, qg, codes, ids, out_s, out_i, Gn, qt, D, C, kk,
                                is_l2, gb, stream);
}

// The body qk_multi_topk runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body (gb groups a block).
int qk_multi_topk_body(int qt, int D, int kk) { return multi_topk_body(qt, D, kk); }

}  // extern "C"
