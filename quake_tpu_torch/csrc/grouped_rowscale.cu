// Hand-written Hopper (sm_90a) kernels of the per-row-scale grouped scans
// (the v3p, v3pN, v4, v5, v6 and v7 generations of the JAX package).
//
// K4 and K5 compute, for group g (partition p = gp[g], qt query rows of
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
// K4 with a chunk table (the v4 generation): a group may be one [qt, ct] chunk
// of its partition. row_off[g] is the chunk's first row (the slab and norms
// pointers move there, lanes and slots are chunk-local and gsize[g] counts
// the chunk's valid lanes), and qsrc[g] is the query tile the chunk-group
// reads, so the chunks of one (partition, query tile) group share one tile.
// Both are optional: without them a group is a whole partition with its own
// tile, as v3p, v3pN and v6 use it (_v6_kernel fetches in chunks and then
// runs one _v3p_select over the whole row with slot_mult = next_pow2(C): the
// function of _v3pn_kernel).
//
// K7 (chunk_merge, the v5 generation) runs K4's body on each [qt, ct] chunk
// below the partition's size, dequantizes the chunk's kk winners
// (rowmin + key * (rng / levels), global slot = chunk * ct + local slot) and
// keeps, per row, the kk best (score, slot) pairs over all chunks: score
// descending, then the larger slot. It writes scores [Gn, qt, kk] f32 (-inf =
// none) and slots [Gn, qt, kk] int32 (-1 = none). The TPU kernel collects all
// maxch * kk candidates of a row and then runs kk rounds over them; that tile
// does not fit shared memory at maxch = 59 (C = 7552, ct = 128), so K7 merges
// the best kk so far with each chunk's kk (only those above the kk-th best so
// far are emitted at all). Global slots are distinct, so the order is total
// and the running merge selects exactly the same kk pairs.
// Each chunk needs its own row range before its keys: two passes over the
// chunk, and a chunk of at most 128 rows stays in shared memory between them
// (one trip to global memory). The dequantized score uses the intrinsics
// that are never contracted into an fma: ties between chunks decide winners.
//
// K4's exact top-kk keeps, per row, a candidate buffer in shared memory of
// cap = round_up(kk, 32) + 128 values and a threshold (initially -1): a value
// above the threshold is appended (ballot + prefix count); when 32 more
// might not fit, the buffer is cut to its kk largest values and the
// threshold becomes the kk-th largest. The output is kk descending rounds of
// "largest value below the previous one" over the buffer.

#include <limits.h>

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
// column) pairs this thread owns, then f(r, j, ln, ok, score). With
// load = false the one segment that the previous pass left in shared memory
// is used again (size <= 128).
template <int R, typename F>
__device__ __forceinline__ void score_pass(const float* qs, float* seg, const float* slab,
                                           const float* nrm, int size, int D, int Dp,
                                           bool l2, F&& f, bool load = true) {
  const int lane = threadIdx.x & 31;
  const int nseg = (size + kFold - 1) / kFold;
  for (int s = 0; s < nseg; ++s) {
    if (load) {
      __syncthreads();  // previous segment fully consumed (and q tile written)
      load_segment(seg, slab, s * kFold, size, D, Dp);
      __syncthreads();
    }
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
                     const int* __restrict__ qsrc, const int* __restrict__ row_off,
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
  const int off = row_off ? row_off[g] : 0;
  const int size = min(gsize[g], C - off);
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
  load_query_tile(qs, qg + (size_t)(qsrc ? qsrc[g] : g) * qt * D, qt, D, Dp);
  const float* slab = codes + ((size_t)p * C + off) * D;
  const float* nrm = norms + (size_t)p * C + off;
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
int launch_rowscale(const void* gp, const void* gsize, const void* qsrc, const void* row_off,
                    const void* qg, const void* codes,
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
        (const int*)gp, (const int*)gsize, (const int*)qsrc, (const int*)row_off,         \
        (const float*)qg, (const float*)codes, (const float*)norms, (float*)out,          \
        (float*)stats, D, Dp, C, kk, cap, is_l2, slot_mult, levels);                      \
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

// ---------------------------------------------------------------- kernel K7

// A row's merge lists live in shared memory as (ms, mi)[3 kk]: the best kk so
// far at [cur kk, cur kk + kk), the next best list at the other of the first
// two thirds, the current chunk's candidates at [2 kk, 3 kk).

// The chunk's winners (descending packed values of the row's buffer),
// dequantized, into the candidate third, as far as they are above (ts, ti),
// the row's kk-th best pair so far: a chunk's candidates descend in (score,
// slot), so after the first one that is not above it none can enter the best
// kk. Returns how many were written (warp-uniform, at most kk).
__device__ __noinline__ int emit_chunk(const float* b, int cnt, int kk, float slot_mult,
                                       float rowmin, float step, int slot0, float ts, int ti,
                                       float* cs, int* ci) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float prev = INFINITY;
  int n = 0;
  for (; n < kk; ++n) {
    float lm = -1.0f;
    for (int e = lane; e < cnt; e += 32) {
      const float x = b[e];
      if (x < prev) lm = fmaxf(lm, x);
    }
    prev = warp_max(lm);
    if (prev < 0.0f) break;  // the buffer ran out
    const float key = floorf(prev / slot_mult);  // slot_mult is a power of two: exact
    const float sc = __fadd_rn(rowmin, __fmul_rn(key, step));
    const int slot = slot0 + (int)(prev - key * slot_mult);
    if (!pair_above(sc, slot, ts, ti)) break;
    if (lane == 0) {
      cs[n] = sc;
      ci[n] = slot;
    }
  }
  __syncwarp();
  return n;
}

// The kk best pairs of (best so far) + (the chunk's n candidates) into the
// other best list.
__device__ __noinline__ void merge_row(float* ms, int* mi, int cur, int kk, int n) {
  const int lane = threadIdx.x & 31;
  const int src = cur * kk, dst = (cur ^ 1) * kk;
  float ps = INFINITY;
  int pi = INT_MAX;
  for (int i = 0; i < kk; ++i) {
    float ls = -INFINITY;
    int li = -1;
    for (int e = lane; e < kk + n; e += 32) {
      const int at = e < kk ? src + e : kk + e;  // candidates: from 2 kk
      const float x = ms[at];
      const int y = mi[at];
      if (pair_above(ps, pi, x, y) && pair_above(x, y, ls, li)) {
        ls = x;
        li = y;
      }
    }
    warp_max_pair(ls, li);
    ps = ls;
    pi = li;
    if (lane == 0) {
      ms[dst + i] = ps;
      mi[dst + i] = pi;
    }
  }
  __syncwarp();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
chunk_merge_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                   const float* __restrict__ qg, const float* __restrict__ codes,
                   const float* __restrict__ norms, float* __restrict__ out_s,
                   int* __restrict__ out_i, int D, int Dp, int C, int ct, int kk, int cap,
                   int is_l2, float slot_mult, float levels) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [qt][Dp]
  float* seg = qs + qt * Dp;                // [128][Dp + 1]
  float* buf = seg + kFold * (Dp + 1);      // [qt][cap]
  float* ms = buf + qt * cap;               // [qt][3 kk] merge scores
  int* mi = reinterpret_cast<int*>(ms + qt * 3 * kk);  // [qt][3 kk] merge slots
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = gp[g];
  const int size = p >= 0 ? min(gsize[g], C) : 0;
  float* osg = out_s + (size_t)g * qt * kk;
  int* oig = out_i + (size_t)g * qt * kk;
  if (size <= 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) {
      osg[i] = -INFINITY;
      oig[i] = -1;
    }
    return;
  }
  load_query_tile(qs, qg + (size_t)g * qt * D, qt, D, Dp);
  const bool l2 = is_l2 != 0;
  // Each warp owns its rows' merge lists: start them empty.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    for (int e = lane; e < kk; e += 32) {
      ms[row * 3 * kk + e] = -INFINITY;
      mi[row * 3 * kk + e] = -1;
    }
  }
  __syncwarp();
  int cur[R];  // which of a row's first two lists holds its best so far
#pragma unroll
  for (int r = 0; r < R; ++r) cur[r] = 0;
  const int nch = (size + ct - 1) / ct;
  for (int c = 0; c < nch; ++c) {
    const int csize = min(size - c * ct, ct);
    const float* slab = codes + ((size_t)p * C + (size_t)c * ct) * D;
    const float* nrm = norms + (size_t)p * C + (size_t)c * ct;

    // Pass 1: each row's min and max over the chunk's valid lanes.
    float mn[R], mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mn[r] = INFINITY;
      mx[r] = -INFINITY;
    }
    score_pass<R>(qs, seg, slab, nrm, csize, D, Dp, l2,
                  [&](int r, int, int, bool ok, float sc) {
                    if (ok) {
                      mn[r] = fminf(mn[r], sc);
                      mx[r] = fmaxf(mx[r], sc);
                    }
                  });
    float scale[R], step[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mn[r] = warp_min(mn[r]);
      mx[r] = warp_max(mx[r]);
      const float rng = fmaxf(mx[r] - mn[r], kMinRange);
      scale[r] = levels / rng;
      step[r] = __fdiv_rn(rng, levels);
    }

    // Pass 2: the same scores, quantized, packed, the exact top-kk as K4. A
    // chunk of one segment is still in shared memory.
    int cnt[R];
    float thr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cnt[r] = 0;
      thr[r] = -1.0f;
    }
    score_pass<R>(qs, seg, slab, nrm, csize, D, Dp, l2,
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
                  },
                  csize > kFold);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      float* rms = ms + (size_t)row * 3 * kk;
      int* rmi = mi + (size_t)row * 3 * kk;
      const int last = cur[r] * kk + kk - 1;  // the row's kk-th best so far
      const int n = emit_chunk(buf + (size_t)row * cap, cnt[r], kk, slot_mult, mn[r], step[r],
                               c * ct, rms[last], rmi[last], rms + 2 * kk, rmi + 2 * kk);
      if (n > 0) {  // warp-uniform
        merge_row(rms, rmi, cur[r], kk, n);
        cur[r] ^= 1;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = warp + kWarps * r;
    for (int e = lane; e < kk; e += 32) {
      osg[row * kk + e] = ms[(size_t)row * 3 * kk + cur[r] * kk + e];
      oig[row * kk + e] = mi[(size_t)row * 3 * kk + cur[r] * kk + e];
    }
  }
}

int launch_chunk_merge(const void* gp, const void* gsize, const void* qg, const void* codes,
                       const void* norms, void* out_s, void* out_i, int Gn, int qt, int D, int C,
                       int ct, int kk, int is_l2, float slot_mult, float levels, void* stream) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = topk_cap(kk);
  const size_t smem =
      (size_t)(qt * Dp + kFold * (Dp + 1) + qt * cap + qt * 6 * kk) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_CHUNK_MERGE(R)                                                                  \
  case 8 * R: {                                                                            \
    cudaError_t e = allow_smem(chunk_merge_kernel<R>, smem);                               \
    if (e != cudaSuccess) return (int)e;                                                   \
    chunk_merge_kernel<R><<<Gn, kThreads, smem, st>>>(                                     \
        (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)codes,          \
        (const float*)norms, (float*)out_s, (int*)out_i, D, Dp, C, ct, kk, cap, is_l2,     \
        slot_mult, levels);                                                                \
    break;                                                                                 \
  }
  switch (qt) {
    QK_CHUNK_MERGE(1)
    QK_CHUNK_MERGE(2)
    QK_CHUNK_MERGE(4)
    QK_CHUNK_MERGE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_CHUNK_MERGE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: replaces quake_tpu/ops/pallas_grouped.py::_v3p_kernel, _v3pn_kernel and
// _v6_kernel (_v3p_group_body + _v3p_select on a whole partition; qsrc and
// row_off null) and _v4_kernel (the same body on one chunk per group; qsrc
// and row_off given).
int qk_rowscale_topk(const void* gp, const void* gsize, const void* qsrc, const void* row_off,
                     const void* qg, const void* codes, const void* norms, void* out,
                     void* stats, int Gn, int qt, int D, int C, int kk, int is_l2,
                     float slot_mult, float levels, void* stream) {
  return launch_rowscale<false>(gp, gsize, qsrc, row_off, qg, codes, norms, out, stats, Gn, qt,
                                D, C, kk, is_l2, slot_mult, levels, stream);
}

// K5: replaces quake_tpu/ops/pallas_grouped.py::_v7_kernel (_v7_select +
// _v7_fold_rounds).
int qk_rowscale_fold(const void* gp, const void* gsize, const void* qg, const void* codes,
                     const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                     int kk, int is_l2, float slot_mult, float levels, void* stream) {
  return launch_rowscale<true>(gp, gsize, nullptr, nullptr, qg, codes, norms, out, stats, Gn,
                               qt, D, C, kk, is_l2, slot_mult, levels, stream);
}

// K7: replaces quake_tpu/ops/pallas_grouped.py::_v5_kernel.
int qk_chunk_merge(const void* gp, const void* gsize, const void* qg, const void* codes,
                   const void* norms, void* out_s, void* out_i, int Gn, int qt, int D, int C,
                   int ct, int kk, int is_l2, float slot_mult, float levels, void* stream) {
  return launch_chunk_merge(gp, gsize, qg, codes, norms, out_s, out_i, Gn, qt, D, C, ct, kk,
                            is_l2, slot_mult, levels, stream);
}

}  // extern "C"
