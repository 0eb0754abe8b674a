// Helpers shared by the package's CUDA kernels (csrc/*.cu): the thread
// layout, the fold-128 top-2 selection and the other fold widths of K1 and
// K5, the (score, index) pair order and the per-row candidate buffer of the
// exact selections, the shared-memory loads and the tile product on the
// CUDA cores (tile_dots), and, for kernels K1, K3-K9 and multi_topk, the tile
// product on the tensor cores with its asynchronous loads (mma_tile,
// segment_load_async) and the ring's shape; for K1 on bf16 codes the bf16
// tile product (mma_tile_bf16).
// Everything is in an anonymous namespace: each source gets its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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

// A row's kk best (score, index) pairs as a sorted list (K6, K7, K9 and
// multi_topk on the tensor cores). A row's lists lie in shared memory as (ls, li)[3 kk]:
// the best so far at [cur kk, cur kk + kk), in the pair order, descending,
// with (-inf, -1) fillers while fewer than kk are known; the other list at the
// other of the first two thirds; n <= kk new candidates at [2 kk, 2 kk + n),
// in any order. Indices are distinct, so the order is total.
//
// merge_rows puts the kk best of each of a warp's R rows (rows warp + 8 r)
// and its n[r] candidates into the row's other list and flips cur[r], the
// rows side by side: lane e0 + lane ranks entry e of every row in one loop (a
// list entry at e has e entries of its list above it, a candidate the prefix
// of the sorted list that a binary search finds), adds the candidates above
// it, and an entry of rank below kk lands at that rank. The fillers lie below
// every candidate, so the ranks are a permutation and every place of the new
// list is written once.
template <int R>
__device__ __forceinline__ void merge_rows(float* ls, int* li, int (&cur)[R], const int (&n)[R],
                                           int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int most = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) most = n[r] > most ? n[r] : most;
  if (most == 0) return;  // warp-uniform
  for (int e0 = 0; e0 < kk + most; e0 += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = e0 + lane;
      if (n[r] == 0 || e >= kk + n[r]) continue;
      float* rs = ls + (size_t)(warp + kWarps * r) * 3 * kk;
      int* ri = li + (size_t)(warp + kWarps * r) * 3 * kk;
      const float* cs = rs + cur[r] * kk;
      const int* ci = ri + cur[r] * kk;
      float s;
      int i, rank;
      if (e < kk) {
        s = cs[e];
        i = ci[e];
        rank = e;
      } else {
        s = rs[kk + e];  // candidate e - kk
        i = ri[kk + e];
        int lo = 0, hi = kk;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (pair_above(cs[mid], ci[mid], s, i)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        rank = lo;
      }
      for (int j = 0; j < n[r]; ++j) rank += pair_above(rs[2 * kk + j], ri[2 * kk + j], s, i);
      if (rank < kk) {
        rs[(cur[r] ^ 1) * kk + rank] = s;
        ri[(cur[r] ^ 1) * kk + rank] = i;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (n[r] > 0) cur[r] ^= 1;
}

// merge_rows where kk <= 32, the list in registers: lane e holds entry e of
// each row's list (in place, cur unchanged). The candidates go in one at a
// time, the warp's rows side by side: a candidate's place is the number of
// list entries above it (one vote), the entries from there on move down one
// lane and the last falls off. Inserting candidates one by one keeps the kk
// best of the list and those inserted so far, whatever their order.
template <int R>
__device__ __forceinline__ void insert_rows(float* ls, int* li, const int (&cur)[R],
                                            const int (&n)[R], int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int most = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) most = n[r] > most ? n[r] : most;
  if (most == 0) return;  // warp-uniform
  float s[R];
  int id[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = (size_t)(warp + kWarps * r) * 3 * kk + cur[r] * kk + lane;
    s[r] = lane < kk ? ls[at] : -INFINITY;
    id[r] = lane < kk ? li[at] : -1;
  }
  for (int c = 0; c < most; ++c) {
    // No branch between the rows, so that their chains interleave: a row
    // whose candidates are all in takes a pair below every entry, which
    // lands past the list.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = c < n[r];
      const size_t at = (size_t)(warp + kWarps * r) * 3 * kk + 2 * kk + (live ? c : 0);
      const float cs = live ? ls[at] : -INFINITY;
      const int ci = live ? li[at] : INT_MIN;
      const int pos = __popc(__ballot_sync(0xffffffffu, lane < kk && pair_above(s[r], id[r], cs, ci)));
      const float us = __shfl_up_sync(0xffffffffu, s[r], 1);
      const int ui = __shfl_up_sync(0xffffffffu, id[r], 1);
      if (lane == pos) {
        s[r] = cs;
        id[r] = ci;
      } else if (lane > pos) {
        s[r] = us;
        id[r] = ui;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (n[r] == 0 || lane >= kk) continue;
    const size_t at = (size_t)(warp + kWarps * r) * 3 * kk + cur[r] * kk + lane;
    ls[at] = s[r];
    li[at] = id[r];
  }
  __syncwarp();
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

// The maximum of a row's m1 columns held by a warp (4 columns per lane).
__device__ __forceinline__ float select_round_max(const float (&m1)[4]) {
  return warp_max(fmaxf(fmaxf(m1[0], m1[1]), fmaxf(m1[2], m1[3])));
}

// One selection round over a row held by a warp (4 columns per lane):
// returns the row maximum and demotes the columns holding it.
__device__ __forceinline__ float select_round(float (&m1)[4], float (&m2)[4]) {
  const float b = select_round_max(m1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m1[j] == b) {
      m1[j] = m2[j];
      m2[j] = -1.0f;
    }
  }
  return b;
}

// The maximum over the lanes of `mask` of a packed value (an integer below
// 2^24, or -1: exact as an int) in one warp reduction instruction, in place
// of a shuffle chain.
__device__ __forceinline__ float packed_max(unsigned mask, float v) {
  return (float)__reduce_max_sync(mask, (int)v);
}

// k selection rounds over R rows a warp holds (4 columns a lane each, as in
// select_round), the rows' reductions side by side. emit(r, i, best) runs on
// every lane after round i of row r. With kList the rounds also run over each
// row's list of an earlier fold block (see select_round_list), lists + (warp +
// 8 r) k.
template <int R, bool kList = false, typename Emit>
__device__ __forceinline__ void select_rounds(float (&m1)[R][4], float (&m2)[R][4], int k,
                                              Emit emit, const float* lists = nullptr) {
  int h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) h[r] = 0;
  for (int i = 0; i < k; ++i) {
    float b[R], l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      b[r] = packed_max(0xffffffffu,
                        fmaxf(fmaxf(m1[r][0], m1[r][1]), fmaxf(m1[r][2], m1[r][3])));
      if constexpr (kList) {
        l[r] = h[r] < k ? lists[(size_t)((threadIdx.x >> 5) + kWarps * r) * k + h[r]] : -1.0f;
        b[r] = fmaxf(b[r], l[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m1[r][j] == b[r]) {
          m1[r][j] = m2[r][j];
          m2[r][j] = -1.0f;
        }
      }
      if constexpr (kList) h[r] += (h[r] < k && l[r] == b[r]) ? 1 : 0;
      emit(r, i, b[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fold widths other than 128 (the JAX package's "f{fold}" names; kernels K1
// and K5). The tile layouts stay on 128-row segments; the fold width F is a
// runtime parameter of its own, served in two forms that compute the JAX
// function (pallas_grouped.py::_v7_fold_rounds) exactly. Packed values are
// distinct within a row (the lane is part of them), so the top two of a union
// of columns are the top two of the parts' top twos, and kk rounds emit the kk
// largest of all the columns' (m1, m2), whatever order the columns took.
//
//   F = 32, 64 (dividing 128): the state stays on 128 columns; at a group's end
//      the columns c, c + F, ... merge into column c (fold_narrow). In the
//      rounds' layout lane l owns columns l + 32 j, so the merge needs no
//      exchange: j merges into j mod F / 32.
//   F = 128 m: segment s feeds fold block s mod m. A group's segments run in
//      fold-block order (block 0: segments 0, m, 2 m, ...; then block 1, ...),
//      so one 128-column state serves every block in turn. At a block's end its
//      rounds run over the block's columns and the row's list of the blocks
//      before it (select_round_list): the kk largest of the union, which is the
//      kk largest of all of the row's F columns once the last block has run.
//      The state is that of F = 128 whatever m is, and the list takes kk values
//      a row of shared memory, so every m whose F divides C is served.
// ---------------------------------------------------------------------------

// Fold blocks of a fold width: m for F = 128 m, else 1.
__host__ __device__ inline int fold_blocks(int fold) { return fold > kFold ? fold / kFold : 1; }

// Values a row of the fold lists takes in shared memory: kk where m > 1 (K5
// keeps them where K4 keeps its candidate buffers), else none.
inline int fold_list_len(int fold, int kk) { return fold_blocks(fold) > 1 ? kk : 0; }

// The segment after s of a group of nseg segments in fold-block order (m
// blocks), or -1 after the last.
__host__ __device__ inline int next_fold_segment(int s, int nseg, int m) {
  if (s + m < nseg) return s + m;
  const int b = s % m + 1;
  return b < m && b < nseg ? b : -1;
}

// The i-th segment of a group of nseg segments in fold-block order.
__host__ __device__ inline int fold_order_segment(int i, int nseg, int m) {
  for (int b = 0; b < m && b < nseg; ++b) {
    const int cnt = (nseg - 1 - b) / m + 1;
    if (i < cnt) return b + i * m;
    i -= cnt;
  }
  return -1;
}

// Column (b1, b2) into (a1, a2): the top two of the union.
__device__ __forceinline__ void merge_top2(float& a1, float& a2, float b1, float b2) {
  a2 = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
  a1 = fmaxf(a1, b1);
}

// F = 32 or 64: a warp's R rows in the rounds' layout folded from 128 columns
// to F; the columns a lane no longer owns read -1 (they never win a round that
// a value can win). Any other F leaves the state as it is.
template <int R>
__device__ __forceinline__ void fold_narrow(float (&m1)[R][4], float (&m2)[R][4], int fold) {
  if (fold != 32 && fold != 64) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    merge_top2(m1[r][0], m2[r][0], m1[r][2], m2[r][2]);
    merge_top2(m1[r][1], m2[r][1], m1[r][3], m2[r][3]);
    m1[r][2] = m2[r][2] = m1[r][3] = m2[r][3] = -1.0f;
    if (fold == 32) {
      merge_top2(m1[r][0], m2[r][0], m1[r][1], m2[r][1]);
      m1[r][1] = m2[r][1] = -1.0f;
    }
  }
}

// One selection round over a row held by a warp (select_round) and the row's
// list L of the fold blocks before this one: kk values, descending, -1 after
// its end, its head at h. The round's maximum is the larger of the columns'
// and the head's; the head moves on when it wins (a value of the list differs
// from every column's: its lane lies in another block).
__device__ __forceinline__ float select_round_list(float (&m1)[4], float (&m2)[4], const float* L,
                                                   int& h, int kk) {
  const float l = h < kk ? L[h] : -1.0f;
  const float b = fmaxf(select_round_max(m1), l);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (m1[j] == b) {
      m1[j] = m2[j];
      m2[j] = -1.0f;
    }
  }
  if (h < kk && l == b) ++h;
  return b;
}

// The rows [warp + 8 r] of og [qt][kk] (the lists the blocks before this one
// left) into L [qt][kk]: only the warp's own rows, which its lanes wrote.
template <int R>
__device__ __forceinline__ void load_lists(float* L, const float* og, int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    for (int e = lane; e < kk; e += 32) L[row * kk + e] = og[row * kk + e];
  }
  __syncwarp();
}

// An operand element as f32: a bf16 value converts exactly.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The [qt, D] query tile (f32 or bf16) into shared memory as [qt][Dp] f32,
// zero-padded.
template <typename T>
__device__ __forceinline__ void load_query_tile(float* qs, const T* src, int qt, int D, int Dp) {
  for (int i = threadIdx.x; i < qt * Dp; i += kThreads) {
    const int r = i / Dp;
    const int d = i - r * Dp;
    qs[i] = d < D ? to_f32(src[(size_t)r * D + d]) : 0.0f;
  }
}

// Copies rows [row0, row0 + 128) of a [*, D] f32 or bf16 matrix into shared
// memory as [128][Dp + 1] f32 (odd stride: lane-strided column reads hit
// distinct banks), zero-filling the pad columns d >= D and rows >= nrows.
template <typename T>
__device__ __forceinline__ void load_segment(float* seg, const T* src, int row0, int nrows,
                                             int D, int Dp) {
  const int ss = Dp + 1;
  for (int i = threadIdx.x; i < kFold * Dp; i += kThreads) {
    const int c = i / Dp;
    const int d = i - c * Dp;
    const int r = row0 + c;
    seg[c * ss + d] = (d < D && r < nrows) ? to_f32(src[(size_t)r * D + d]) : 0.0f;
  }
}

// acc[r][j] (+)= <q row (warp + 8 r), segment column (lane + 32 j)> for the
// R rows and 4 columns this thread owns (zero: acc starts from 0). q tile is
// [*, Dp] (Dp % 4 == 0, zero-padded), segment is [128][Dp + 1].
template <int R>
__device__ __forceinline__ void tile_dots(float (&acc)[R][4], const float* qs,
                                          const float* seg, int Dp, bool zero = true) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ss = Dp + 1;
  if (zero) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  }
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

inline __host__ __device__ int padded_dim(int D) { return (D + 3) & ~3; }

// ---------------------------------------------------------------------------
// The tile product on the tensor cores (kernels K1, K3-K9, multi_topk).
//
// <q, x> for a [16 MW, D] query tile and a 128-row segment, as
// mma.sync.m16n8k8 TF32 products with f32 accumulation. TF32 keeps 10 mantissa
// bits, and the kernels' keys are a floor() of the product, so each operand is
// split on the card into hi = tf32(x) and lo = tf32(x - hi) (round to nearest,
// ties away, as cvt.rna.tf32.f32) and the product is
//     q_lo x_hi + q_hi x_lo + q_hi x_hi
// summed in f32 ("3xTF32"): the dropped q_lo x_lo term is below 2^-22 of
// |q| |x|. ops/split_product.py is the plain model.
//
// Operand tiles lie in shared memory in boxes of 32 columns: a [rows][D] tile
// is tile_boxes(D) = ceil(D / 32) boxes of [rows][32] f32, one after the
// other, and within a box the 16-byte chunk c of row r is stored at chunk
// c ^ (r & 7) (tile_at). That is the layout the Tensor Memory Accelerator
// writes with its 128-byte swizzle, so a whole box of a segment arrives by one
// cp.async.bulk.tensor from a tensor map over the slabs viewed as [P C, D],
// completing on the stage's mbarrier; and the fragment loads of a warp (8
// rows x 4 consecutive floats) hit 32 distinct banks. The copy zero-fills
// the columns from D to the end of the last box and any row past the end of
// the slabs; rows at or past a group's size arrive as they are in memory and
// the kernels mask them. Boxes start on 1024-byte boundaries.
//
// The 8 warps form an MW x NW grid (NW = 8 / MW): warp w owns MT m16-tiles
// (16 MT query rows from 16 MT (w / NW)) and NT = 16 / NW n8-tiles (8 NT
// segment rows, the product's columns, from 8 NT (w % NW)): 2 x 4 warps of
// 2 x 4 tiles at qt = 64, so that a value loaded and split feeds as many
// products as the registers allow. In the accumulator acc[i NT + j][e] of lane
// (g = lane / 4, t = lane % 4), entry e of tile (i, j) is row
// 16 i + g + 8 (e / 2), column 8 j + 2 t + (e % 2) of the warp's block.
// ---------------------------------------------------------------------------
constexpr int kTileStride = 136;  // row stride of a [qt][128] f32 value tile (136 % 32 == 8:
                                  // the float2 stores of a warp spread over all banks)

constexpr int kBox = 32;                // floats of a box row: 128 bytes, the swizzle span
constexpr int kSegBox = kFold * kBox;   // floats of one box of a 128-row segment (16 KB)

inline __host__ __device__ int tile_boxes(int D) { return (D + kBox - 1) / kBox; }

// Where element (r, k) of a [rows][*] operand tile lies.
__device__ __forceinline__ int tile_at(int r, int k, int rows) {
  return (k >> 5) * rows * kBox + r * kBox + ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3);
}

// The first 1024-byte boundary of the block's dynamic shared memory.
__device__ __forceinline__ float* smem_aligned(float* raw) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(raw);
  return raw + ((1024u - (at & 1023u)) & 1023u) / sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarrier: one arrival (the thread that announces the bytes) and a count of
// bytes that the bulk copies take off as they land.
__device__ __forceinline__ void mbar_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Spins until the barrier's phase of the given parity has completed; the
// bytes copied in that phase are then visible to the caller. A copy that
// never completes (a wrong tensor map, a wrong byte count) ends the kernel
// with an error after about a second instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (spins > (1u << 26)) __trap();
  }
}

// Generic-proxy accesses to shared memory made so far are ordered before
// asynchronous-proxy (bulk copy) accesses that follow a later barrier.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of the tensor map `map` (its rows from row, 32 columns from col)
// into dst by one bulk tensor copy, completing on bar; issued by the calling
// thread, which has announced the bytes on bar.
__device__ __forceinline__ void box_load_async(float* dst, const CUtensorMap* map, int col,
                                               int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// Rows [row, row + 128), columns from box box0 on, of the slabs (tensor map
// cmap over [P C, D], box_cols elements a box: 32 f32 or 64 bf16, 128 bytes
// either way) into the `boxes` boxes of the segment tile dst, one bulk tensor
// copy a box, started by the block's first thread and completing on bar.
// Whatever the block read or wrote in the tile before must lie behind a
// __syncthreads().
__device__ __forceinline__ void segment_load_async(float* dst, const CUtensorMap* cmap, int row,
                                                   int box0, int boxes, uint64_t* bar,
                                                   int box_cols = kBox) {
  if (threadIdx.x != 0) return;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"((uint32_t)(boxes * kSegBox * sizeof(float)))
               : "memory");
  fence_async_proxy();
  for (int b = 0; b < boxes; ++b)
    box_load_async(dst + b * kSegBox, cmap, (box0 + b) * box_cols, row, bar);
}

// The [qt, D] query tile (rows of D 32-bit words, D % 4 == 0: D f32 values,
// or 2 D bf16 values in pairs) into a [rows][*] operand tile, copied as bits;
// rows >= qt and the words from D to the end of the last box are zero.
__device__ __forceinline__ void query_tile_load(float* dst, const float* src, int qt, int rows,
                                                int D, int boxes) {
  const int nch = boxes * (kBox / 4);  // 16-byte chunks a row
  const int dch = D >> 2;
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    const int r = i / nch;
    const int c = i - r * nch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < qt && c < dch) v = *reinterpret_cast<const uint4*>(src + (size_t)r * D + 4 * c);
    *reinterpret_cast<uint4*>(dst + tile_at(r, 4 * c, rows)) = v;
  }
}

// hi = tf32(x), rounded to nearest with ties away from zero as
// cvt.rna.tf32.f32 rounds: half of the last kept place is added to the
// magnitude bits and the 13 dropped bits are cleared. lo = tf32(x - hi) gets
// the same half added and no mask: the tensor cores read only the upper 19
// bits of a TF32 operand. Integer arithmetic on the bits gives the values of
// two cvt.rna.tf32.f32 conversions and timed the same in the kernels. A finite
// x within half a TF32 place of FLT_MAX rounds up to infinity (the model in
// ops/split_product.py does the same), and its product is then inf or nan.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c = a b + (kZero ? 0 : c), one m16n8k8 TF32 product.
template <bool kZero>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kZero) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// The split fragments of one depth-8 step: a[i] the m16 x k8 tile i of the
// query rows, b[j] the k8 x n8 tile j of the segment rows.
template <int MT, int NT>
struct StepFragments {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
};

// qa and sb point at this lane's first element of the step-0 fragments (row
// row0 + g or col0 + g, column t); qrows is the query tile's height.
template <int MT, int NT>
__device__ __forceinline__ void load_step(StepFragments<MT, NT>& f, const float* qa,
                                          const float* sb, int ks, int g, int qrows) {
  // Step ks covers the chunks 2 ks and 2 ks + 1 of box ks / 4; every row this
  // lane reads has (row & 7) == g, so one pair of offsets serves them all.
  const int c0 = (((2 * ks) & 7) ^ g) << 2, c1 = c0 ^ 4;
  const float* a = qa + (ks >> 2) * qrows * kBox;
  const float* b = sb + (ks >> 2) * kSegBox;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    tf32_split(a[16 * i * kBox + c0], f.ah[i][0], f.al[i][0]);
    tf32_split(a[(16 * i + 8) * kBox + c0], f.ah[i][1], f.al[i][1]);
    tf32_split(a[16 * i * kBox + c1], f.ah[i][2], f.al[i][2]);
    tf32_split(a[(16 * i + 8) * kBox + c1], f.ah[i][3], f.al[i][3]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    tf32_split(b[j * 8 * kBox + c0], f.bh[j][0], f.bl[j][0]);
    tf32_split(b[j * 8 * kBox + c1], f.bh[j][1], f.bl[j][1]);
  }
}

// part (+)= the three terms of one step, one term at a time over all the
// tiles: consecutive mma operations then write different accumulators and
// need not wait for each other. The small terms come first.
template <bool kZero, int MT, int NT>
__device__ __forceinline__ void mma_step(float (&part)[MT * NT][4],
                                         const StepFragments<MT, NT>& f) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32<kZero>(part[i * NT + j], f.al[i], f.bh[j][0], f.bh[j][1]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32<false>(part[i * NT + j], f.ah[i], f.bl[j][0], f.bl[j][1]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32<false>(part[i * NT + j], f.ah[i], f.bh[j][0], f.bh[j][1]);
}

// acc (+)= <q rows, segment rows> for this warp's (16 MT) x (8 NT) block:
// query rows from row0 of the tile qs (qrows high), segment rows from col0 of
// the tile seg, over ksteps steps of depth 8 (round_up(D, 8) / 8 in all). Where
// a ring stage holds fewer boxes than D takes, the caller walks D in depth
// chunks: qs and seg then point at the chunk's first box, and only the first
// chunk starts acc from zero.
//
// The tensor cores add into their f32 accumulator by truncation, so a sum
// carried there over all of D drifts by several units in the last place.
// Two steps at a time are therefore summed on the tensor cores from zero
// (the two small terms of a step before its large one) and that partial sum
// is added to acc on the CUDA cores, rounded to nearest.
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(float (&acc)[MT * NT][4], const float* qs,
                                         const float* seg, int row0, int col0, int qrows,
                                         int ksteps, bool zero = true) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (zero) {
#pragma unroll
    for (int ti = 0; ti < MT * NT; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ti][e] = 0.0f;
  }
  const float* qa = qs + (row0 + g) * kBox + t;
  const float* sb = seg + (col0 + g) * kBox + t;
  for (int k0 = 0; k0 < ksteps; k0 += 2) {
    float part[MT * NT][4];
    StepFragments<MT, NT> f;
    load_step<MT, NT>(f, qa, sb, k0, g, qrows);
    mma_step<true, MT, NT>(part, f);
    if (k0 + 1 < ksteps) {
      load_step<MT, NT>(f, qa, sb, k0 + 1, g, qrows);
      mma_step<false, MT, NT>(part, f);
    }
#pragma unroll
    for (int ti = 0; ti < MT * NT; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ti][e] += part[ti][e];
  }
}

// ---------------------------------------------------------------------------
// The tile product on bf16 operands (kernel K1 on bf16 codes).
//
// The same tiles as mma_tile, read as 32-bit words: a word holds two bf16
// values along the depth (the lower one in the low half), so a [rows][D]
// bf16 tile is tile_boxes(D / 2) boxes of [rows][32] words (64 bf16 columns,
// the 128 bytes of the swizzle span) in tile_at's layout. A depth-16 step
// covers the words of a depth-8 step of the f32 tiles, and the m16n8k16 bf16
// fragments lie where the m16n8k8 TF32 ones do: A register 0 holds row g,
// columns 2 t and 2 t + 1 (word t of the step's first chunk), register 1 row
// g + 8, registers 2 and 3 the same in the second chunk (columns 2 t + 8 and
// 2 t + 9); B register 0 holds segment row g, columns 2 t and 2 t + 1, and
// register 1 columns 2 t + 8 and 2 t + 9. One mma.sync.m16n8k16 a tile and
// step, no split: a product of two bf16 values is exact in f32.
//
// The tensor cores add into their accumulator by truncation (see mma_tile).
// kBf16PartialSteps steps (4: a box, 64 depth columns) are summed there from
// zero, and that partial sum is added to acc on the CUDA cores, rounded to
// nearest: one addition a box keeps the CUDA cores' share small beside one
// mma a step. Built with -DQK_BF16_PARTIAL_STEPS=n (a measuring aid,
// scripts/exact_score_errors.py k1bf16), n steps make a partial sum; 16 sums
// all of a ring stage on the tensor cores.
// ---------------------------------------------------------------------------
#ifndef QK_BF16_PARTIAL_STEPS
#define QK_BF16_PARTIAL_STEPS 4
#endif
constexpr int kBf16PartialSteps = QK_BF16_PARTIAL_STEPS;

// c = a b + (kZero ? 0 : c), one m16n8k16 bf16 product accumulating in f32.
template <bool kZero>
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kZero) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// part (+)= one depth-16 step of this warp's tiles; qa and sb point at this
// lane's first word of the step-0 fragments (row row0 + g or col0 + g, word t).
template <bool kZero, int MT, int NT>
__device__ __forceinline__ void mma_step_bf16(float (&part)[MT * NT][4], const uint32_t* qa,
                                              const uint32_t* sb, int ks, int g, int qrows) {
  const int c0 = (((2 * ks) & 7) ^ g) << 2, c1 = c0 ^ 4;  // as load_step's
  const uint32_t* a = qa + (ks >> 2) * qrows * kBox;
  const uint32_t* b = sb + (ks >> 2) * kSegBox;
  uint32_t af[MT][4], bf[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    af[i][0] = a[16 * i * kBox + c0];
    af[i][1] = a[(16 * i + 8) * kBox + c0];
    af[i][2] = a[16 * i * kBox + c1];
    af[i][3] = a[(16 * i + 8) * kBox + c1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bf[j][0] = b[j * 8 * kBox + c0];
    bf[j][1] = b[j * 8 * kBox + c1];
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16<kZero>(part[i * NT + j], af[i], bf[j][0], bf[j][1]);
}

// acc (+)= <q rows, segment rows> on bf16 tiles (the words of mma_tile's
// layout), over ksteps steps of depth 16 (round_up(D, 16) / 16 in all), with
// mma_tile's arguments otherwise.
template <int MT, int NT>
__device__ __forceinline__ void mma_tile_bf16(float (&acc)[MT * NT][4], const float* qs,
                                              const float* seg, int row0, int col0, int qrows,
                                              int ksteps, bool zero = true) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (zero) {
#pragma unroll
    for (int ti = 0; ti < MT * NT; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ti][e] = 0.0f;
  }
  const uint32_t* qa = reinterpret_cast<const uint32_t*>(qs) + (row0 + g) * kBox + t;
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(seg) + (col0 + g) * kBox + t;
  for (int k0 = 0; k0 < ksteps; k0 += kBf16PartialSteps) {
    float part[MT * NT][4];
    mma_step_bf16<true, MT, NT>(part, qa, sb, k0, g, qrows);
#pragma unroll
    for (int s = 1; s < kBf16PartialSteps; ++s)
      if (k0 + s < ksteps) mma_step_bf16<false, MT, NT>(part, qa, sb, k0 + s, g, qrows);
#pragma unroll
    for (int ti = 0; ti < MT * NT; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ti][e] += part[ti][e];
  }
}

// acc (+)= <q rows, segment rows> on f32 tiles (mma_tile, steps of depth 8)
// or bf16 tiles (mma_tile_bf16, steps of depth 16), with their arguments.
template <bool kBf16, int MT, int NT>
__device__ __forceinline__ void mma_tile_any(float (&acc)[MT * NT][4], const float* qs,
                                             const float* seg, int row0, int col0, int qrows,
                                             int ksteps, bool zero = true) {
  if constexpr (kBf16)
    mma_tile_bf16<MT, NT>(acc, qs, seg, row0, col0, qrows, ksteps, zero);
  else
    mma_tile<MT, NT>(acc, qs, seg, row0, col0, qrows, ksteps, zero);
}

// a + the squares of the values in 16 bytes of a row, in column order: four
// f32, or eight bf16 (two a 32-bit word, the lower column in the low half;
// a bf16 value is the upper half of its f32, so the conversion is exact).
template <bool kBf16>
__device__ __forceinline__ float sumsq16(float4 v, float a) {
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      const uint32_t w = __float_as_uint(e[i]);
      const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
      a = fmaf(lo, lo, a);
      a = fmaf(hi, hi, a);
    } else {
      a = fmaf(e[i], e[i], a);
    }
  }
  return a;
}

// Depth steps of a row of D columns, four a box: of 8 f32 or 16 bf16 columns.
inline __host__ __device__ int depth_steps(int D, bool bf16) {
  return bf16 ? (D + 15) >> 4 : (D + 7) >> 3;
}

// 32-bit words of a row of D columns, or 0 where a row is not 16-byte aligned
// for the copies (f32: D % 4 != 0; bf16: D % 8 != 0). The tensor-core bodies
// lay out and size their tiles in words: a box is 32 words (128 bytes) of a
// row, 32 f32 or 64 bf16 columns.
inline __host__ __device__ int row_words(int D, bool bf16) {
  if (D % (bf16 ? 8 : 4) != 0) return 0;
  return bf16 ? D / 2 : D;
}

// Shared memory a block may use. The tensor-core bodies serve a shape whose
// rows are 16-byte aligned for the asynchronous copies (D % 4 == 0) and whose
// whole-D query tile fits beside a ring stage of 4, 2 or 1 boxes.
constexpr size_t kSmemLimit = 232448;

// Floats of one ring stage of NBS boxes of the selecting tensor-core bodies
// (K4-K9, multi_topk): a segment tile, or the [qt][kTileStride] value tile
// laid over it, up to the next 1024-byte boundary.
inline int ring_stage_floats(int qt, int NBS) {
  const int tile = (qt * kTileStride + 255) / 256 * 256;
  return NBS * kSegBox > tile ? NBS * kSegBox : tile;
}

// A selecting tensor-core body's ring stage and per-row candidate buffers:
// NBS boxes a stage (all of D's, or the most of 4, 2 and 1 that fits) and
// cap = round_up(kk, 32) plus the most of 128, 96, 64 and 32 that fits with
// it (a cut makes room for 32 values at a time; more room means fewer cuts),
// where smem(NBS, cap) is the body's shared memory in bytes. cap 0: the body
// does not fit.
struct RingShape {
  int NBS, cap;
};
template <typename Smem>
inline RingShape ring_shape(int D, int kk, Smem smem) {
  for (int nbs = 4; nbs >= 1; nbs >>= 1) {
    const int NBS = nbs < tile_boxes(D) ? nbs : tile_boxes(D);
    for (int room = 128; room >= 32; room -= 32) {
      const int cap = (kk + 31) / 32 * 32 + room;
      if (smem(NBS, cap) <= kSmemLimit) return {NBS, cap};
    }
  }
  return {0, 0};
}

// Boxes a ring stage of a tensor-core body holds, where smem(NBS) is its
// shared memory in bytes: all of D's, or the most of 4, 2 and 1 that fits; 0:
// the body does not fit.
template <typename Smem>
inline int ring_stage_boxes(int D, Smem smem) {
  for (int nbs = 4; nbs >= 1; nbs >>= 1) {
    const int NBS = nbs < tile_boxes(D) ? nbs : tile_boxes(D);
    if (smem(NBS) <= kSmemLimit) return NBS;
  }
  return 0;
}

// A tensor map over the slabs viewed as [rows, D] f32 (elem_bytes 4, D % 4 ==
// 0) or bf16 (elem_bytes 2, D % 8 == 0), codes on a 16-byte boundary, in
// boxes of box_rows rows (128: a segment) x 128 bytes (32 f32 or 64 bf16
// columns) with the 128-byte swizzle; what lies outside the array reads as
// zero. The encoder (cuTensorMapEncodeTiled) is looked up in libcuda at run
// time, so the library need not be linked. Returns a cudaError_t.
inline int slab_tensor_map(CUtensorMap* map, const void* codes, unsigned long long rows, int D,
                           int box_rows = kFold, int elem_bytes = 4) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {  // libcuda is in the process already: PyTorch loaded it
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
    if (!fn) return (int)cudaErrorNotSupported;
    encode = (Encode)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(kBox * sizeof(float) / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            2, const_cast<void*>(codes),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// SMs of the current device (the one the launch that follows goes to).
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Dynamic shared memory above 48 KB needs the per-kernel opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
