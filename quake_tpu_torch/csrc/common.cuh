// Helpers shared by the package's CUDA kernels (csrc/*.cu): the thread
// layout, the fold-128 top-2 selection, the (score, index) pair order and the
// per-row candidate buffer of the exact selections, the shared-memory loads
// and the tile product.
// Everything is in an anonymous namespace: each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFold = 128;   // fold width: columns per row after folding
constexpr int kWarps = 8;    // warps per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The exact selections' total order on (score, index) pairs: score first,
// then the larger index (slot or id) among equal scores.
__device__ __forceinline__ bool pair_above(float s, int i, float ts, int ti) {
  return s > ts || (s == ts && i > ti);
}

// Largest (score, index) pair of a warp, to every lane.
__device__ __forceinline__ void warp_max_pair(float& s, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (pair_above(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Largest pair of the row's buffer (bs, bi)[0, cnt) strictly below (ps, pi);
// (-inf, -1) when there is none. The result reaches every lane.
__device__ __forceinline__ void next_below(const float* bs, const int* bi, int cnt, float ps,
                                           int pi, float& rs, int& ri) {
  const int lane = threadIdx.x & 31;
  float ls = -INFINITY;
  int li = -1;
  for (int e = lane; e < cnt; e += 32) {
    const float x = bs[e];
    const int y = bi[e];
    if (pair_above(ps, pi, x, y) && pair_above(x, y, ls, li)) {
      ls = x;
      li = y;
    }
  }
  warp_max_pair(ls, li);
  rs = ls;
  ri = li;
}

// The kk-th largest pair of a row's buffer becomes the threshold (ts, ti) and
// the buffer is cut to the pairs at or above it. Returns the new count.
__device__ __noinline__ int cut_row(float* bs, int* bi, int cnt, int kk, float& ts, int& ti) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float ps = INFINITY;
  int pi = INT_MAX;
  for (int i = 0; i < kk; ++i) next_below(bs, bi, cnt, ps, pi, ps, pi);
  int w = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    const float x = e < cnt ? bs[e] : -INFINITY;
    const int y = e < cnt ? bi[e] : -1;
    const bool keep = e < cnt && !pair_above(ps, pi, x, y);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    __syncwarp();  // every lane has read its entry before any is overwritten
    if (keep) {
      const int pos = w + __popc(m & ((1u << lane) - 1u));
      bs[pos] = x;
      bi[pos] = y;
    }
    w += __popc(m);
  }
  __syncwarp();
  ts = ps;
  ti = pi;
  return w;
}

// cap of the per-row candidate buffers of the exact selections (K6, K9 and
// the sized and multi scans); the wrappers check the same formula against the
// shared memory a block may use.
inline int exact_cap(int kk) { return (kk + 31) / 32 * 32 + 128; }

// Streaming top-2 update of one fold column with a new packed value.
__device__ __forceinline__ void fold2(float& m1, float& m2, float v) {
  m2 = fmaxf(m2, fminf(m1, v));
  m1 = fmaxf(m1, v);
}

// One selection round over a row held by a warp (4 columns per lane):
// returns the row maximum and demotes the columns holding it.
__device__ __forceinline__ float select_round(float (&m1)[4], float (&m2)[4]) {
  float b = fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3]));
  b = warp_max(b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m1[j] == b) {
      m1[j] = m2[j];
      m2[j] = -1.0f;
    }
  }
  return b;
}

// The [qt, D] query tile into shared memory as [qt][Dp], zero-padded.
__device__ __forceinline__ void load_query_tile(float* qs, const float* src, int qt, int D,
                                                int Dp) {
  for (int i = threadIdx.x; i < qt * Dp; i += kThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    qs[i] = d < D ? src[(size_t)r * D + d] : 0.0f;
  }
}

// Copies rows [row0, row0 + 128) of a [*, D] f32 matrix into shared memory
// as [128][Dp + 1] (odd stride: lane-strided column reads hit distinct
// banks), zero-filling the pad columns d >= D and rows >= nrows.
__device__ __forceinline__ void load_segment(float* seg, const float* src, int row0,
                                             int nrows, int D, int Dp) {
  const int ss = Dp + 1;
  for (int i = threadIdx.x; i < kFold * Dp; i += kThreads) {
    const int c = i / Dp;
    const int d = i - c * Dp;
    const int r = row0 + c;
    seg[c * ss + d] = (d < D && r < nrows) ? src[(size_t)r * D + d] : 0.0f;
  }
}

// acc[r][j] = <q row (warp + 8 r), segment column (lane + 32 j)> for the
// R rows and 4 columns this thread owns. q tile is [*, Dp] (Dp % 4 == 0,
// zero-padded), segment is [128][Dp + 1].
template <int R>
__device__ __forceinline__ void tile_dots(float (&acc)[R][4], const float* qs,
                                          const float* seg, int Dp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ss = Dp + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  for (int d = 0; d < Dp; d += 4) {
    float sv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* col = seg + (lane + 32 * j) * ss + d;
      sv[j][0] = col[0];
      sv[j][1] = col[1];
      sv[j][2] = col[2];
      sv[j][3] = col[3];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (warp + kWarps * r) * Dp + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[r][j];
        a = fmaf(qv.x, sv[j][0], a);
        a = fmaf(qv.y, sv[j][1], a);
        a = fmaf(qv.z, sv[j][2], a);
        a = fmaf(qv.w, sv[j][3], a);
        acc[r][j] = a;
      }
    }
  }
}

inline int padded_dim(int D) { return (D + 3) & ~3; }

// Dynamic shared memory above 48 KB needs the per-kernel opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
