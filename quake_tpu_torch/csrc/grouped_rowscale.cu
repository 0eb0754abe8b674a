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
//   K5 (rowscale_fold) — fold-128 top-2 then kk rounds, as kernel K1 (fold
//      column = lane % 128). It too needs the row's range first: a top-2 by
//      raw score is not the top-2 by packed value, whose keys tie within a
//      level and break the tie by the larger lane. Other fold widths (32, 64,
//      128 m) as K1 serves them (common.cuh): the tensor-core body selects in
//      fold-block order, its fold lists where K4 keeps its buffers.
//
// Bound on the H100: operations, 2 D flops a (real query row, valid lane)
// pair of a pass, against 4 (D + 1) bytes of slab and norms a lane (qt / 2 =
// 32 flops per byte at qt = 64). The row range needs a first pass over the
// scores before any key exists, so K4's and K5's work is two passes; K7's is
// one where a chunk is one 128-row segment (its range and keys come from the
// same accumulators). The tensor-core bodies (K4, K5 and K7) take their
// products as split TF32 operands (three TF32 products per f32 one: 3 x flops
// / 495 TFLOP/s a pass); the CUDA-core bodies run them in f32 (flops / 67
// TFLOP/s a pass).
//
// K4 has three bodies, chosen by shape in the launcher (rowscale_topk_body),
// never after a failure. What bounded the first design: an f32 product on
// the CUDA cores run twice, loads that nothing overlapped, one short-lived
// block per group, a warp's rows emitted one after the other, and, with a
// chunk table, one block per 128-row chunk that fetched the same query tile
// again.
//
// K5 has two bodies, chosen by shape in the launcher (rowscale_fold_body):
// K4's tensor-core body with the fold selection (kFoldSelect), and
// rowscale_scan_kernel. What bounded the latter on the H100 (30.3 ms on the
// v7 path) was what bounded K4's: two f32 products on synchronous loads, one
// short-lived block a group.
//
// rowscale_scan_kernel (K5's and K4's CUDA-core body; K7's CUDA-core body
// follows the same design), simple: one block per group, the [qt, D] query
// tile in shared memory, the slab streamed through shared memory in 128-row segments twice (only the
// ceil(size / 128) segments that hold vectors). Pass 1 takes each row's min
// and max; pass 2 recomputes the same scores with the same code in the same
// order (bit-identical, so a winner's key comes from the same float as the
// stats) and selects. There is no C % 128 requirement: the last segment may
// be partial and slot_mult is next_pow2(C). Build without --use_fast_math:
// levels / rng must be an IEEE division, as in XLA.
//
// rowscale_topk_mma_kernel, K4 on whole partitions (D % 4 == 0, and a query
// tile and candidate buffers that fit shared memory beside the ring; a D past
// a ring stage's depth streams through it in depth chunks, as in K1):
// persistent, one block per SM, block b takes groups b,
// b + grid, ... (the groups are partition-major, so the blocks that run
// together read the same partitions). The slab streams through a ring of two
// 128-row segment buffers filled by the Tensor Memory Accelerator
// (cp.async.bulk.tensor from a tensor map over the slabs, completing on the
// stage's mbarrier), one segment ahead of the product and across group
// borders; rows at or past the group's size are masked, rows past the end of
// the slabs read as zero. Both passes run mma_tile (common.cuh: 3xTF32, the
// same operations in the same order, so the scores are bit-identical). The
// last segment of pass 1 stays in the accumulator and is the first that pass
// 2 selects from, so a group of one segment is multiplied once; a group of
// two finds its first segment still in the ring and loads nothing twice. Row
// min and max are taken in the accumulator's layout and reduced over the quad
// and, through shared memory, over the warps that share a row. For the
// selection a segment's packed values pass through a [qt][128] tile laid over
// the consumed segment buffer into the layout of the exact top-kk (a warp
// owns whole rows), which is unchanged but for its last step: the kk rounds
// that emit a row's winners run for the warp's eight rows at once and store
// a row's winners together. The two products hold the pace (see mma_tile).
// K5 runs the same body (kFoldSelect): a segment's packed values, in the
// same tile and layout, go into the fold columns' top two (fold2; a segment
// starts on a multiple of 128, so the tile's column is the fold column), and
// the group's end runs kk select_rounds a row, the warp's rows side by side.
// Folding in the accumulator's layout instead, which saves two barrier
// phases a segment, measured the same (PERF.md): the products bound it.
//
// rowscale_chunk_kernel, K4 with a chunk table (the v4 generation): a group
// may be one [qt, ct] chunk of its partition. row_off[g] is the chunk's first
// row (the slab and norms pointers move there, lanes and slots are
// chunk-local and gsize[g] counts the chunk's valid lanes), and qsrc[g] is
// the query tile the chunk-group reads, so the chunks of one (partition,
// query tile) group share one tile. A chunk's row range can be far below its
// scores (a last chunk with a few valid lanes, a row whose best lanes tie):
// its levels are then narrower than the scores' last place, and keys and
// stats agree with the plain version only if the sums run in its order. So
// this body multiplies in f32 on the CUDA cores (tile_dots) and takes from
// the redesign what does not touch the arithmetic: it is persistent, walks a
// contiguous run of chunk-groups, keeps the query tile while qsrc[g] stays,
// loads one segment ahead with asynchronous copies into a ring of two
// buffers, multiplies a one-segment chunk once, and emits a warp's rows at
// once. Without qsrc and row_off a group is a whole partition with its own
// tile, as v3p, v3pN and v6 use K4 (_v6_kernel fetches in chunks and then
// runs one _v3p_select over the whole row with slot_mult = next_pow2(C): the
// function of _v3pn_kernel).
//
// K7 (chunk_merge, the v5 generation; replaces quake_tpu/ops/
// pallas_grouped.py::_v5_kernel) runs K4's body on each [qt, ct] chunk below
// the partition's size, dequantizes the chunk's kk winners (rowmin + key *
// (rng / levels), global slot = chunk * ct + local slot) and keeps, per row,
// the kk best (score, slot) pairs over all chunks: score descending, then the
// larger slot. It writes scores [Gn, qt, kk] f32 (-inf = none) and slots
// [Gn, qt, kk] int32 (-1 = none). The TPU kernel collects all maxch * kk
// candidates of a row and then runs kk rounds over them; that tile does not
// fit shared memory at maxch = 59 (C = 7552, ct = 128), so K7 merges the best
// kk so far with each chunk's kk (only those whose dequantized score is not
// below the kk-th best so far are kept at all). Global slots are distinct, so
// the order is total and the running merge selects exactly the same kk
// pairs. The dequantized score uses the intrinsics that are never
// contracted into an fma: ties between chunks decide winners.
//
// K7 has two bodies, chosen by shape in the launcher (chunk_merge_body,
// qk_chunk_merge_body), never after a failure. chunk_merge_kernel (D % 4 != 0,
// or merge lists that crowd out the ring): one block per group, the f32
// product of rowscale_scan_kernel run twice a chunk, emit_chunk and merge_row
// one row after another. What bounded it on the H100 (42 ms on the v5 path):
// the two products, loads that nothing overlapped, a block's short life, and
// the serial per-row selection of up to 59 chunks a row.
//
// chunk_merge_mma_kernel, the tensor-core body: persistent and fed by K4's
// TMA ring (a segment ahead, across chunk and group borders; rows at or past
// the chunk's size masked), mma_tile (3xTF32) a segment. A chunk of one
// 128-row segment (ct <= 128: every chunk of the v5 path at C = 7552) is
// multiplied once: its row range is reduced in the accumulator's layout and
// its keys come from the same accumulators, so they match the range bit for
// bit. A chunk of n > 1 segments (ct = 256, 384, 512 or a whole slab) is
// multiplied twice, 2 n - 1 visits as K4's body visits a group, the same code
// in the same order (bit-identical scores): its scores do not fit beside the
// ring. The keys pass through K4's [qt][128] tile into rows a warp owns,
// where a value whose dequantized score lies below the row's kk-th best so
// far is dropped before it is stored. A chunk of one segment takes its top kk
// straight from the registers (kk rounds of a warp maximum where more than kk
// are left); a longer one collects them in K4's candidate buffer. The winners
// go into the row's sorted best list, the warp's rows side by side
// (insert_rows, merge_rows). The chunk's row range, selection and merge run
// in phases between block barriers, which the 8 warps of the one block an SM
// cannot overlap with the product (PERF.md).
//
// bf16 codes (the _bf16 entries; the JAX package's precision="bf16", the queries
// rounded to bf16 as its wrappers round them): every body of K4, K5 and K7
// on bf16 operands, templated over the element type. The tensor-core bodies
// (kBf16) read their tiles as 32-bit words, two columns a word, and multiply
// by mma_tile_bf16: one m16n8k16 bf16 product a depth-16 step where the f32
// bodies take three TF32 products a depth-8 step. A product of two bf16
// values is exact in f32, so only the order of the sums differs from the
// plain version's, as in f32; both passes run the same code in the same
// order, so the stats and the keys still come from bit-identical scores. A
// box is 128 bytes of a row either way (64 bf16 columns): the ring, the tensor
// map's swizzle and the fragment layout are the f32 bodies', the tiles sized
// in words, so a stage holds twice the depth and the lists have more room.
// They serve D % 8 == 0 (the copies' 16-byte rows); their bound is 2 flops a
// (row, lane, column) a pass over 989 TFLOP/s, or 2 bytes an element. The
// CUDA-core bodies, v4's chunk-table body among them, convert the bf16 values
// to f32 as they load them (exact) and keep their f32 arithmetic and order;
// the chunk-table body loads bf16 synchronously (an asynchronous copy moves 4
// bytes at least, and its f32 ring has no room for raw bf16 rows).
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

// kk descending values of each of a warp's R rows (rows warp + 8 r, buffers of
// cap values each, cnt[r] of them filled) into og[row][0, kk), -1 after a
// buffer runs out. The kk rounds are a chain of dependent reductions per row,
// so the rows' chains are interleaved to hide each other's latency. Lane i
// keeps round i's winner and a row's winners leave 32 at a time in one
// store: a store per round and row kept the warps waiting on the store path.
template <int R>
__device__ __forceinline__ void emit_rows(const float* buf, int cap, const int (&cnt)[R], int kk,
                                          float* og) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncwarp();
  float prev[R], keep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) prev[r] = INFINITY;
  for (int i = 0; i < kk; ++i) {
    float lm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lm[r] = -1.0f;
    for (int e = lane; e < cap; e += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // e < cap: the load is in bounds whatever the row holds, so it needs
        // no branch of its own (eight of them a step cost more than the rounds).
        const float x = buf[(size_t)(warp + kWarps * r) * cap + e];
        lm[r] = fmaxf(lm[r], (e < cnt[r] && x < prev[r]) ? x : -1.0f);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) lm[r] = fmaxf(lm[r], __shfl_xor_sync(0xffffffffu, lm[r], o));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      prev[r] = lm[r];
      if ((i & 31) == lane) keep[r] = lm[r];
    }
    if ((i & 31) == 31 || i == kk - 1) {  // warp-uniform: the last 32 (or fewer) rounds leave
      const int at = (i & ~31) + lane;
      if (at <= i) {
#pragma unroll
        for (int r = 0; r < R; ++r) og[(warp + kWarps * r) * kk + at] = keep[r];
      }
    }
  }
}

// One pass over the group's segments s0, s0 + sstep, ...: acc = <q, x> for
// the R x 4 (row, column) pairs this thread owns, then f(r, j, ln, ok,
// score). With load = false the one segment that the previous pass left in
// shared memory is used again (size <= 128).
template <int R, typename T, typename F>
__device__ __forceinline__ void score_pass(const float* qs, float* seg, const T* slab,
                                           const float* nrm, int size, int D, int Dp,
                                           bool l2, F&& f, bool load = true, int s0 = 0,
                                           int sstep = 1) {
  const int lane = threadIdx.x & 31;
  const int nseg = (size + kFold - 1) / kFold;
  for (int s = s0; s < nseg; s += sstep) {
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

// kBlocks (K5 at fold = 128 m, m > 1): the fold blocks of common.cuh; the
// other instantiations keep F = 128's code.
template <int R, bool kFoldSelect, typename T, bool kBlocks = false>
__global__ void __launch_bounds__(kThreads)
rowscale_scan_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                     const int* __restrict__ qsrc, const int* __restrict__ row_off,
                     const T* __restrict__ qg, const T* __restrict__ codes,
                     const float* __restrict__ norms, float* __restrict__ out,
                     float* __restrict__ stats, int D, int Dp, int C, int kk, int cap,
                     int is_l2, float slot_mult, float levels, int fold) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [qt][Dp]
  float* seg = qs + qt * Dp;                // [128][Dp + 1]
  float* buf = seg + kFold * (Dp + 1);      // [qt][cap]: K4's buffers, K5's fold lists
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
  const T* slab = codes + ((size_t)p * C + off) * D;
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

  // Pass 2: the same scores, quantized with the row's range, packed, selected
  // (K5: a fold block at a time, common.cuh).
  if constexpr (kFoldSelect) {
    const int nseg = (size + kFold - 1) / kFold;
    const int fb = kBlocks ? fold_blocks(fold) : 1;
    for (int b = 0; b < fb && b < nseg; ++b) {
      float m1[R][4], m2[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
      score_pass<R>(qs, seg, slab, nrm, size, D, Dp, l2,
                    [&](int r, int j, int ln, bool ok, float sc) {
                      const float key = floorf((sc - mn[r]) * scale[r]);
                      fold2(m1[r][j], m2[r][j], ok ? key * slot_mult + (float)ln : -1.0f);
                    }, true, b, fb);
      fold_narrow<R>(m1, m2, fold);
      if (kBlocks && b > 0) {  // the rounds also run over the list of the blocks before
        load_lists<R>(buf, og, kk);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = warp + kWarps * r;
          int h = 0;
          for (int i = 0; i < kk; ++i) {
            const float v = select_round_list(m1[r], m2[r], buf + row * kk, h, kk);
            if (lane == 0) og[row * kk + i] = v;
          }
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + kWarps * r;
        for (int i = 0; i < kk; ++i) {
          const float v = select_round(m1[r], m2[r]);
          if (lane == 0) og[row * kk + i] = v;
        }
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
    emit_rows<R>(buf, cap, cnt, kk, og);
  }
}

// cap of K4's per-row candidate buffer (the wrapper checks the same formula
// against the shared memory a block may use).
inline int topk_cap(int kk) { return (kk + 31) / 32 * 32 + 128; }

template <bool kFoldSelect, typename T>
int launch_rowscale(const void* gp, const void* gsize, const void* qsrc, const void* row_off,
                    const void* qg, const void* codes,
                    const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                    int kk, int is_l2, float slot_mult, float levels, void* stream,
                    int fold = kFold) {
  if (Gn <= 0) return (int)cudaGetLastError();
  const int Dp = padded_dim(D);
  const int cap = kFoldSelect ? fold_list_len(fold, kk) : topk_cap(kk);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1) + qt * cap) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define QK_ROWSCALE_LAUNCH(R, B)                                                          \
  {                                                                                       \
    cudaError_t e = allow_smem(rowscale_scan_kernel<R, kFoldSelect, T, B>, smem);         \
    if (e != cudaSuccess) return (int)e;                                                  \
    rowscale_scan_kernel<R, kFoldSelect, T, B><<<Gn, kThreads, smem, st>>>(               \
        (const int*)gp, (const int*)gsize, (const int*)qsrc, (const int*)row_off,         \
        (const T*)qg, (const T*)codes, (const float*)norms, (float*)out,                  \
        (float*)stats, D, Dp, C, kk, cap, is_l2, slot_mult, levels, fold);                \
  }
#define QK_ROWSCALE(R)                                                                    \
  case 8 * R:                                                                             \
    if (kFoldSelect && cap > 0) QK_ROWSCALE_LAUNCH(R, kFoldSelect) else                   \
      QK_ROWSCALE_LAUNCH(R, false)                                                        \
    break;
  switch (qt) {
    QK_ROWSCALE(1)
    QK_ROWSCALE(2)
    QK_ROWSCALE(4)
    QK_ROWSCALE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_ROWSCALE
#undef QK_ROWSCALE_LAUNCH
  return (int)cudaGetLastError();
}

// ------------------------------------------------ K4 with a chunk table

// load_segment's copy as asynchronous 4-byte copies (the odd row stride rules
// out wider ones), one commit group a segment; what load_segment zero-fills
// is zero-filled here (a copy of no source bytes).
__device__ __forceinline__ void load_segment_async(float* seg, const float* src, int row0,
                                                   int nrows, int D, int Dp) {
  const int ss = Dp + 1;
  for (int i = threadIdx.x; i < kFold * Dp; i += kThreads) {
    const int c = i / Dp;
    const int d = i - c * Dp;
    const int r = row0 + c;
    const bool ok = d < D && r < nrows;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(seg + c * ss + d)),
                 "l"(ok ? src + (size_t)r * D + d : src), "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The CUDA-core body for a chunk table (the v4 scan), persistent: one block
// per SM walks a contiguous run of chunk-groups, keeps the [qt, D] query tile
// while qsrc[g] stays the same, and loads the next segment (of this
// chunk-group or the next) into the other of two buffers while it multiplies
// the current one. The scores are tile_dots' (f32, one fmaf a term in the
// order of D), bit for bit those of rowscale_scan_kernel. A chunk of one
// segment (every chunk at ct = 128) is multiplied once: its second pass
// selects from the first one's accumulator. A chunk of n > 1 segments is
// visited 2 n times, each visit loading its segment. On bf16 (T) a segment
// is loaded synchronously, converted to f32, into the other buffer.
template <int R, typename T>
__global__ void __launch_bounds__(kThreads, 1)
rowscale_chunk_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                      const int* __restrict__ qsrc, const int* __restrict__ row_off,
                      const T* __restrict__ qg, const T* __restrict__ codes,
                      const float* __restrict__ norms, float* __restrict__ out,
                      float* __restrict__ stats, int Gn, int D, int Dp, int C, int kk, int cap,
                      int is_l2, float slot_mult, float levels) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  const int seg_floats = kFold * (Dp + 1);
  float* qs = smem;                      // [qt][Dp]
  float* ring = qs + qt * Dp;            // 2 x [128][Dp + 1]
  float* buf = ring + 2 * seg_floats;    // [qt][cap]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool l2 = is_l2 != 0;
  const int per = (Gn + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per, end = min(Gn, first + per);
  auto size_of = [&](int g) { return min(gsize[g], C - row_off[g]); };
  // Ghost groups write -1 and stats (0, 1e-20) and take no part in the walk.
  for (int g = first; g < end; ++g)
    if (size_of(g) <= 0) {
      for (int i = threadIdx.x; i < qt * kk; i += kThreads) out[(size_t)g * qt * kk + i] = -1.0f;
      for (int i = threadIdx.x; i < qt; i += kThreads) {
        stats[((size_t)g * qt + i) * 2] = 0.0f;
        stats[((size_t)g * qt + i) * 2 + 1] = kMinRange;
      }
    }
  auto next_live = [&](int g) {
    while (g < end && size_of(g) <= 0) ++g;
    return g;
  };
  auto visits_of = [](int nseg) { return nseg == 1 ? 1 : 2 * nseg; };

  // The producer, one visit ahead of the consumer.
  int pg = next_live(first), pv = 0;
  auto prefetch = [&](int stage) {
    if (pg >= end) return;
    const int size = size_of(pg), nseg = (size + kFold - 1) / kFold;
    const T* src = codes + ((size_t)gp[pg] * C + row_off[pg]) * D;
    if constexpr (sizeof(T) == 4)
      load_segment_async(ring + stage * seg_floats, src, (pv % nseg) * kFold, size, D, Dp);
    else
      load_segment(ring + stage * seg_floats, src, (pv % nseg) * kFold, size, D, Dp);
    if (++pv == visits_of(nseg)) {
      pg = next_live(pg + 1);
      pv = 0;
    }
  };
  int cg = pg, cv = 0, stage = 0, cur_q = -1;
  prefetch(0);

  float mn[R], mx[R], scale[R], thr[R];
  int cnt[R];
  int size = 0, nseg = 0;
  const float* nrm = norms;
  while (cg < end) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the segment has landed; the other buffer is consumed
    prefetch(stage ^ 1);
    if (cv == 0) {
      size = size_of(cg);
      nseg = (size + kFold - 1) / kFold;
      nrm = norms + (size_t)gp[cg] * C + row_off[cg];
      if (qsrc[cg] != cur_q) {  // block-uniform; the last product on the old tile is over
        cur_q = qsrc[cg];
        load_query_tile(qs, qg + (size_t)cur_q * qt * D, qt, D, Dp);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mn[r] = INFINITY;
        mx[r] = -INFINITY;
        cnt[r] = 0;
        thr[r] = -1.0f;
      }
    }
    const int s = cv % nseg;
    float acc[R][4];  // the scores of rows warp + 8 r, lanes s 128 + lane + 32 j
    tile_dots<R>(acc, qs, ring + stage * seg_floats, Dp);
    if (l2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ln = s * kFold + lane + 32 * j;
        const float nv = ln < size ? nrm[ln] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r)  // 2 dot is exact, so a contraction into fmaf changes nothing
          acc[r][j] = 2.0f * acc[r][j] - nv;
      }
    }
    if (cv < nseg) {  // pass 1: each row's min and max over its valid lanes
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s * kFold + lane + 32 * j < size) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mn[r] = fminf(mn[r], acc[r][j]);
            mx[r] = fmaxf(mx[r], acc[r][j]);
          }
        }
      if (cv == nseg - 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mn[r] = warp_min(mn[r]);
          mx[r] = warp_max(mx[r]);
          const float rng = fmaxf(mx[r] - mn[r], kMinRange);
          scale[r] = levels / rng;
          if (lane == 0) {
            const size_t row = (size_t)cg * qt + warp + kWarps * r;
            stats[2 * row] = isfinite(mn[r]) ? mn[r] : 0.0f;
            stats[2 * row + 1] = rng;
          }
        }
      }
    }
    if (cv >= nseg || nseg == 1) {  // pass 2: quantized with the row's range, packed, selected
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ln = s * kFold + lane + 32 * j;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float* b = buf + (size_t)(warp + kWarps * r) * cap;
          if (cnt[r] + 32 > cap) {  // warp-uniform
            thr[r] = cut_row(b, cnt[r], kk);
            cnt[r] = kk;
          }
          const float key = floorf((acc[r][j] - mn[r]) * scale[r]);
          const float v = ln < size ? key * slot_mult + (float)ln : -1.0f;
          const bool take = v > thr[r];
          const unsigned m = __ballot_sync(0xffffffffu, take);
          if (take) b[cnt[r] + __popc(m & ((1u << lane) - 1u))] = v;
          cnt[r] += __popc(m);
        }
      }
    }
    stage ^= 1;
    if (++cv < visits_of(nseg)) continue;
    emit_rows<R>(buf, cap, cnt, kk, out + (size_t)cg * qt * kk);
    cg = next_live(cg + 1);
    cv = 0;
  }
}

// Shared memory of the chunk-table body, in bytes.
inline size_t rowscale_chunk_smem(int qt, int D, int kk) {
  const int Dp = padded_dim(D);
  return (size_t)(qt * Dp + 2 * kFold * (Dp + 1) + qt * topk_cap(kk)) * sizeof(float);
}

template <typename T>
int launch_rowscale_chunk(const void* gp, const void* gsize, const void* qsrc,
                          const void* row_off, const void* qg, const void* codes,
                          const void* norms, void* out, void* stats, int Gn, int qt, int D, int C,
                          int kk, int is_l2, float slot_mult, float levels, void* stream) {
  const size_t smem = rowscale_chunk_smem(qt, D, kk);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  cudaStream_t st = (cudaStream_t)stream;
#define QK_ROWSCALE_CHUNK(R)                                                              \
  case 8 * R: {                                                                           \
    cudaError_t e = allow_smem(rowscale_chunk_kernel<R, T>, smem);                        \
    if (e != cudaSuccess) return (int)e;                                                  \
    rowscale_chunk_kernel<R, T><<<grid, kThreads, smem, st>>>(                            \
        (const int*)gp, (const int*)gsize, (const int*)qsrc, (const int*)row_off,         \
        (const T*)qg, (const T*)codes, (const float*)norms, (float*)out,                  \
        (float*)stats, Gn, D, padded_dim(D), C, kk, topk_cap(kk), is_l2, slot_mult,       \
        levels);                                                                          \
    break;                                                                                \
  }
  switch (qt) {
    QK_ROWSCALE_CHUNK(1)
    QK_ROWSCALE_CHUNK(2)
    QK_ROWSCALE_CHUNK(4)
    QK_ROWSCALE_CHUNK(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_ROWSCALE_CHUNK
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K4 on the tensor cores

// Shared memory of K4's tensor-core body, in bytes, with rows of W 32-bit
// words (D f32 or 2 W bf16 values), ring stages of NBS boxes and candidate
// buffers of cap values a row: room to reach a 1024-byte boundary, ring,
// query tile, buffers, (rowmin, scale) per row, the cross-warp min / max
// exchange, the two stage barriers.
inline size_t rowscale_topk_mma_smem(int qt, int W, int NBS, int cap) {
  return 1024 + 16 +
         (size_t)(2 * ring_stage_floats(qt, NBS) + tile_boxes(W) * (qt < 16 ? 16 : qt) * kBox +
                  qt * cap + 2 * qt + 2 * 32 * kWarps) *
             sizeof(float);
}

inline RingShape rowscale_topk_mma_shape(int qt, int W, int kk) {
  return ring_shape(W, kk,
                    [&](int NBS, int cap) { return rowscale_topk_mma_smem(qt, W, NBS, cap); });
}

// Boxes a ring stage of K5's tensor-core body holds (rows of W words; it
// keeps no candidate buffer, only fold lists of lk values a row); 0: none fits.
inline int rowscale_fold_mma_stage_boxes(int qt, int W, int lk) {
  return ring_stage_boxes(W, [&](int NBS) { return rowscale_topk_mma_smem(qt, W, NBS, lk); });
}

// Which body serves a shape (qk_rowscale_topk_body names them). A chunk table
// never takes the tensor-core body: a chunk's row range can be far below its
// scores, its keys then resolve the scores' last places, and only f32 sums
// in the order of D reproduce the plain version's there (in bf16 too: its
// products are exact, its sums are not).
inline int rowscale_topk_body(int qt, int D, int kk, bool chunked, bool bf16) {
  if (chunked) return rowscale_chunk_smem(qt, D, kk) <= kSmemLimit ? 1 : 0;
  const int W = row_words(D, bf16);
  return W > 0 && rowscale_topk_mma_shape(qt, W, kk).cap > 0 ? 2 : 0;
}

// Which body serves K5 at a shape (qk_rowscale_fold_body names them): 2 the
// tensor-core body where rows are 16-byte aligned (D % 4 == 0 in f32, D % 8
// == 0 in bf16) and its query tile (and, at fold widths 128 m with m > 1,
// the fold lists) fits beside a ring stage, else 0, the CUDA-core body of one
// block a group. The fold keeps two values a column whatever kk is.
inline int rowscale_fold_body(int qt, int D, bool bf16, int fold, int kk) {
  const int W = row_words(D, bf16);
  return W > 0 && rowscale_fold_mma_stage_boxes(qt, W, fold_list_len(fold, kk)) > 0 ? 2 : 0;
}

// kk selection rounds over the fold columns of each of a warp's R rows
// (rows warp + 8 r, select_rounds; with kList also over the rows' lists of
// the fold blocks before this one, lists [qt][kk]), the winners into
// og[row][0, kk): lane i keeps round i's winner and a row's winners leave 32
// at a time.
template <int R, bool kList = false>
__device__ __forceinline__ void emit_fold_rows(float (&m1)[R][4], float (&m2)[R][4], int kk,
                                               float* og, const float* lists = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float keep[R];
  select_rounds<R, kList>(m1, m2, kk, [&](int r, int i, float best) {
    if ((i & 31) == lane) keep[r] = best;
    if ((i & 31) == 31 || i == kk - 1) {  // warp-uniform
      const int at = (i & ~31) + lane;
      if (at <= i) og[(warp + kWarps * r) * kk + at] = keep[r];
    }
  }, lists);
}

// A fold block's end (common.cuh): the columns narrowed where fold is 32 or
// 64, then the rounds, after the first block (merge) over the rows' lists
// of the blocks before it too, which og holds and which move into lists.
template <int R>
__device__ __forceinline__ void emit_fold_block(float (&m1)[R][4], float (&m2)[R][4], int kk,
                                                float* og, float* lists, bool merge, int fold) {
  fold_narrow<R>(m1, m2, fold);
  if (merge) {
    load_lists<R>(lists, og, kk);
    emit_fold_rows<R, true>(m1, m2, kk, og, lists);
  } else {
    emit_fold_rows<R>(m1, m2, kk, og);
  }
}

// kBlocks (K5 at fold = 128 m, m > 1): the fold blocks of common.cuh; the
// other instantiations keep F = 128's code.
template <int QT, bool kFoldSelect, bool kBf16, bool kBlocks = false>
__global__ void __launch_bounds__(kThreads, 1)
rowscale_topk_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                         const int* __restrict__ gsize, const float* __restrict__ qg,
                         const float* __restrict__ norms, float* __restrict__ out,
                         float* __restrict__ stats, int Gn, int D, int NB, int NBS,
                         int stage_floats, int C, int kk, int cap, int is_l2, float slot_mult,
                         float levels, int fold) {
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
  float* buf = qs + NB * QR * kBox;       // [QT][cap]: K4's buffers, K5's fold lists
  float* rowp = buf + QT * cap;           // [QT][2] = (rowmin, levels / rng)
  float* red = rowp + 2 * QT;             // [QR][NW][2] = (min, max) per warp, at most 512
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * 32 * kWarps);  // one a ring stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int wn = warp % NW;
  const int row0 = (warp / NW) * (16 * MT), col0 = wn * (8 * NT);
  const int W = kBf16 ? D >> 1 : D;     // 32-bit words of a row (qg: the tiles' words)
  const int ksteps = depth_steps(D, kBf16);
  const int box_cols = kBf16 ? 2 * kBox : kBox;  // elements of a box row
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment: a stage holds NBS boxes
  const bool l2 = is_l2 != 0;

  // This block's groups: first, first + step, ... below end.
  const int first = blockIdx.x, step = gridDim.x, end = Gn;
  auto size_of = [&](int g) { return min(gsize[g], C); };
  // Ghost groups write -1 and stats (0, 1e-20) and take no part in the walk.
  for (int g = first; g < end; g += step)
    if (size_of(g) <= 0) {
      for (int i = threadIdx.x; i < QT * kk; i += kThreads) out[(size_t)g * QT * kk + i] = -1.0f;
      for (int i = threadIdx.x; i < QT; i += kThreads) {
        stats[((size_t)g * QT + i) * 2] = 0.0f;
        stats[((size_t)g * QT + i) * 2 + 1] = kMinRange;
      }
    }
  auto next_live = [&](int g) {
    while (g < end && size_of(g) <= 0) g += step;
    return g;
  };

  // A group of n segments is visited 2 n - 1 times: segments 0 .. n - 1 for
  // the row ranges, then (the last one selected from the accumulator)
  // segments 0 .. n - 2 again for the selection. A visit takes ND stages, one
  // a depth chunk, and stages alternate, so with n == 2 and ND == 1 visit 2
  // finds the segment of visit 0 where visit 0 left it and loads nothing.
  // K5 with fold blocks (fold = 128 m, m > 1) selects in fold-block order
  // o_0, o_1, ... (fold_order_segment, common.cuh), so that one state serves
  // the blocks in turn: pass 1 visits o_1 .. o_{n-1}, o_0 and pass 2
  // o_1 .. o_{n-1}.
  const int fb = kBlocks ? fold_blocks(fold) : 1;  // fold blocks
  auto visit_segment = [&](int v, int n) {
    if (fb == 1) return v < n ? v : v - n;
    return fold_order_segment(v < n ? (v + 1) % n : v - n + 1, n, fb);
  };
  mbar_init(bars);
  int pg = next_live(first), pv = 0, pd = 0, pnseg = 0, prow = 0;  // the producer, a stage ahead
  auto producer_group = [&]() {
    if (pg < end) {
      pnseg = (size_of(pg) + kFold - 1) / kFold;
      prow = gp[pg] * C;  // the partition's first row of the slabs viewed as [P C, D]
    }
  };
  producer_group();
  auto prefetch = [&](int stage) {
    if (pg < end) {
      const int s = visit_segment(pv, pnseg);
      if (!(ND == 1 && pnseg == 2 && pv == 2))
        segment_load_async(ring + stage * stage_floats, &cmap, prow + s * kFold, pd * NBS,
                           min(NBS, NB - pd * NBS), bars + stage, box_cols);
      if (++pd < ND) return;
      pd = 0;
      if (++pv == 2 * pnseg - 1) {
        pg = next_live(pg + step);
        pv = 0;
        producer_group();
      }
    }
  };
  int cg = pg, cv = 0, cd = 0, stage = 0;
  uint32_t parity = 0;  // bit s: the parity of stage s's next completed phase
  prefetch(0);

  // Rows row0 + 16 i + g4 + 8 h at [2 i + h], over this thread's columns.
  float mn[2 * MT], mx[2 * MT];
  float acc[T][4];  // the scores of this thread's entries, tile (i, j) at i NT + j
  int cnt[R];
  float thr[R];
  float m1[R][4], m2[R][4];  // K5: the top two packed values of each fold column
  int size = 0, nseg = 0;
  const float* nrm = norms;
  while (cg < end) {
    float* stage_mem = ring + stage * stage_floats;
    prefetch(stage ^ 1);
    if (cv == 0 && cd == 0) {
      size = size_of(cg);
      nseg = (size + kFold - 1) / kFold;
      nrm = norms + (size_t)gp[cg] * C;
      // The last product of the previous group ended before a barrier.
      query_tile_load(qs, qg + (size_t)cg * QT * W, QT, QR, W, NB);
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        mn[m] = INFINITY;
        mx[m] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cnt[r] = 0;
        thr[r] = -1.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
      }
    }
    const int s = visit_segment(cv, nseg);
    // This thread's norms, asked for before the product so that they arrive
    // under it.
    const int lnb = s * kFold + col0 + 2 * t4;
    float nv[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ln = lnb + 8 * j + c;
        nv[j][c] = (l2 && ln < size) ? __ldg(nrm + ln) : 0.0f;
      }
    if (!(ND == 1 && nseg == 2 && cv == 2)) {  // the current stage has landed (or was left here)
      mbar_wait(bars + stage, (parity >> stage) & 1u);
      parity ^= 1u << stage;
    }
    __syncthreads();  // and the query tile is in place

    mma_tile_any<kBf16, MT, NT>(acc, qs + cd * NBS * QR * kBox, stage_mem, row0, col0, QR,
                                min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
    if (cd + 1 < ND) {  // the segment's next depth chunk adds to acc
      __syncthreads();  // the stage is consumed: its buffer may be refilled
      stage ^= 1;
      ++cd;
      continue;
    }
    cd = 0;
    if (l2) {
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // 2 dot is exact, so a contraction into fmaf changes nothing
          acc[ti][e] = 2.0f * acc[ti][e] - nv[ti % NT][e & 1];
    }

    // The packed values of the scores in acc, through the tile laid over the
    // consumed stage, into each row's candidate buffer (K4) or fold columns
    // (K5: a segment starts on a multiple of 128, so lane + 32 j is the fold
    // column). Every warp must have finished reading the stage before the call.
    auto select_segment = [&]() {
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        const int row = row0 + 16 * (m / 2) + g4 + 8 * (m % 2);
        if (row < QT) {
          const float rmin = rowp[2 * row], scale = rowp[2 * row + 1];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int ln = lnb + 8 * j + c;
              const float key = floorf((acc[(m / 2) * NT + j][2 * (m % 2) + c] - rmin) * scale);
              v[c] = ln < size ? key * slot_mult + (float)ln : -1.0f;
            }
            *reinterpret_cast<float2*>(stage_mem + row * kTileStride + col0 + 8 * j + 2 * t4) =
                make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      // All of the warp's values first, then row by row.
      float v[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[r][j] = stage_mem[(warp + kWarps * r) * kTileStride + lane + 32 * j];
      if constexpr (kFoldSelect) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) fold2(m1[r][j], m2[r][j], v[r][j]);
        return;
      }
      // K4: a row none of whose values passes its threshold (most rows, once
      // the thresholds have risen) costs one vote.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float top = fmaxf(fmaxf(v[r][0], v[r][1]), fmaxf(v[r][2], v[r][3]));
        if (!__any_sync(0xffffffffu, top > thr[r])) continue;
        float* b = buf + (size_t)(warp + kWarps * r) * cap;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cnt[r] + 32 > cap) {  // warp-uniform
            thr[r] = cut_row(b, cnt[r], kk);
            cnt[r] = kk;
          }
          const bool take = v[r][j] > thr[r];
          const unsigned m = __ballot_sync(0xffffffffu, take);
          if (take) b[cnt[r] + __popc(m & ((1u << lane) - 1u))] = v[r][j];
          cnt[r] += __popc(m);
        }
      }
    };

    if (cv < nseg) {  // pass 1: each row's min and max over its valid lanes
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lnb + 8 * (ti % NT) + (e & 1) < size) {
            const int m = 2 * (ti / NT) + (e >> 1);
            mn[m] = fminf(mn[m], acc[ti][e]);
            mx[m] = fmaxf(mx[m], acc[ti][e]);
          }
      if (cv == nseg - 1) {  // the ranges are complete: stats, then select from acc
#pragma unroll
        for (int m = 0; m < 2 * MT; ++m) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            mn[m] = fminf(mn[m], __shfl_xor_sync(0xffffffffu, mn[m], o));
            mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], o));
          }
          if (t4 == 0) {
            const int row = row0 + 16 * (m / 2) + g4 + 8 * (m % 2);
            red[(row * NW + wn) * 2] = mn[m];
            red[(row * NW + wn) * 2 + 1] = mx[m];
          }
        }
        __syncthreads();  // also: every warp has finished reading the stage
        if (threadIdx.x < QT) {
          const int row = threadIdx.x;
          float rmin = INFINITY, rmax = -INFINITY;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            rmin = fminf(rmin, red[(row * NW + w) * 2]);
            rmax = fmaxf(rmax, red[(row * NW + w) * 2 + 1]);
          }
          const float rng = fmaxf(rmax - rmin, kMinRange);
          rowp[2 * row] = rmin;
          rowp[2 * row + 1] = levels / rng;
          stats[((size_t)cg * QT + row) * 2] = isfinite(rmin) ? rmin : 0.0f;
          stats[((size_t)cg * QT + row) * 2 + 1] = rng;
        }
        __syncthreads();
      }
    } else {  // pass 2: the same scores, to be quantized with the row's range
      __syncthreads();  // every warp has finished reading the stage
    }
    if (cv >= nseg - 1) select_segment();  // from the last visit of pass 1 on
    fence_async_proxy();  // the tile's stores, before the copy that refills the stage
    __syncthreads();      // the stage is consumed: its buffer may be refilled
    stage ^= 1;
    float* og = out + (size_t)cg * QT * kk;
    if (++cv < 2 * nseg - 1) {
      if constexpr (kBlocks) {
        // A fold block that ends before the group does: its rounds, then a
        // fresh state for the next block.
        if (cv >= nseg &&
            fold_order_segment(cv - nseg + 1, nseg, fb) % fb != s % fb) {
          emit_fold_block<R>(m1, m2, kk, og, buf, s % fb != 0, fold);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
        }
      }
      continue;
    }
    if constexpr (kBlocks) {
      emit_fold_block<R>(m1, m2, kk, og, buf, s % fb != 0, fold);
    } else if constexpr (kFoldSelect) {
      fold_narrow<R>(m1, m2, fold);
      emit_fold_rows<R>(m1, m2, kk, og);
    } else {
      emit_rows<R>(buf, cap, cnt, kk, og);
    }
    cg = next_live(cg + step);
    cv = 0;
  }
}

template <bool kFoldSelect, bool kBf16>
int launch_rowscale_topk_mma(const void* gp, const void* gsize, const void* qg,
                             const void* codes, const void* norms, void* out, void* stats,
                             int Gn, int qt, int D, int P, int C, int kk, int is_l2,
                             float slot_mult, float levels, void* stream, int fold = kFold) {
  const int W = row_words(D, kBf16);
  const int NB = tile_boxes(W);
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D, kFold,
                                 kBf16 ? 2 : 4);
  if (me != 0) return me;
  const int lk = fold_list_len(fold, kk);
  const RingShape shape = kFoldSelect ? RingShape{rowscale_fold_mma_stage_boxes(qt, W, lk), lk}
                                      : rowscale_topk_mma_shape(qt, W, kk);
  const int NBS = shape.NBS, cap = shape.cap;
  const size_t smem = rowscale_topk_mma_smem(qt, W, NBS, cap);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  cudaStream_t st = (cudaStream_t)stream;
#define QK_ROWSCALE_MMA_LAUNCH(QT, B)                                                     \
  {                                                                                       \
    cudaError_t e = allow_smem(rowscale_topk_mma_kernel<QT, kFoldSelect, kBf16, B>, smem); \
    if (e != cudaSuccess) return (int)e;                                                  \
    rowscale_topk_mma_kernel<QT, kFoldSelect, kBf16, B><<<grid, kThreads, smem, st>>>(    \
        cmap, (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)norms,   \
        (float*)out, (float*)stats, Gn, D, NB, NBS, ring_stage_floats(qt, NBS), C,        \
        kk, cap, is_l2, slot_mult, levels, fold);                                         \
  }
#define QK_ROWSCALE_MMA(QT)                                                               \
  case QT:                                                                                \
    if (kFoldSelect && lk > 0) QK_ROWSCALE_MMA_LAUNCH(QT, kFoldSelect) else               \
      QK_ROWSCALE_MMA_LAUNCH(QT, false)                                                   \
    break;
  switch (qt) {
    QK_ROWSCALE_MMA(8)
    QK_ROWSCALE_MMA(16)
    QK_ROWSCALE_MMA(32)
    QK_ROWSCALE_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_ROWSCALE_MMA
#undef QK_ROWSCALE_MMA_LAUNCH
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

template <int R, typename T>
__global__ void __launch_bounds__(kThreads)
chunk_merge_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                   const T* __restrict__ qg, const T* __restrict__ codes,
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
    const T* slab = codes + ((size_t)p * C + (size_t)c * ct) * D;
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

template <typename T>
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
    cudaError_t e = allow_smem(chunk_merge_kernel<R, T>, smem);                            \
    if (e != cudaSuccess) return (int)e;                                                   \
    chunk_merge_kernel<R, T><<<Gn, kThreads, smem, st>>>(                                  \
        (const int*)gp, (const int*)gsize, (const T*)qg, (const T*)codes,                  \
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

// ------------------------------------------------- K7 on the tensor cores

// Shared memory of K7's tensor-core body with rows of W 32-bit words (D f32
// or 2 W bf16 values), in bytes: room to reach a 1024-byte boundary, ring,
// query tile, candidate buffers of cap values a row, the merge lists (3 kk
// (score, slot) pairs a row), (rowmin, levels / rng, rng / levels,
// threshold) per row, the cross-warp min / max exchange, the two stage
// barriers.
inline size_t chunk_merge_mma_smem(int qt, int W, int kk, int NBS, int cap) {
  return 1024 + 16 +
         (size_t)(2 * ring_stage_floats(qt, NBS) + tile_boxes(W) * (qt < 16 ? 16 : qt) * kBox +
                  qt * cap + qt * 6 * kk + 4 * qt + 2 * 32 * kWarps) *
             sizeof(float);
}

inline RingShape chunk_merge_mma_shape(int qt, int W, int kk) {
  return ring_shape(W, kk,
                    [&](int NBS, int cap) { return chunk_merge_mma_smem(qt, W, kk, NBS, cap); });
}

// Which body serves K7 at a shape (qk_chunk_merge_body names them): 1 the
// tensor-core body, where rows are 16-byte aligned for the asynchronous
// copies (D % 4 == 0 in f32, D % 8 == 0 in bf16) and its ring, query tile,
// buffers and merge lists fit (a bf16 query tile takes half the room, so the
// lists fit to a larger kk at a deep D); else 0, chunk_merge_kernel.
inline int chunk_merge_body(int qt, int D, int kk, bool bf16) {
  const int W = row_words(D, bf16);
  return W > 0 && chunk_merge_mma_shape(qt, W, kk).cap > 0 ? 1 : 0;
}

// K7 on the tensor cores (the design is in the note at the top of the file).
// A block walks units (group, chunk): the chunks c < ceil(size / ct) of its
// groups b, b + grid, ..., each of n = ceil(csize / 128) segments from row
// gp[g] C + c ct of the slabs, visited 2 n - 1 times as K4's tensor-core body
// visits a group. Per unit, a row keeps the chunk's packed values whose
// dequantized score is not below the row's kk-th best score so far
// (rowp[4 row + 3]) and of those its kk largest: the chunk's exact top kk
// less those that cannot enter the row's best kk (a value left out lies
// below every value kept and, its dequantized score being at most that of a
// value the score test left out, below the kk-th best). They are
// dequantized and merged at the unit's end.
template <int QT, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
chunk_merge_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                       const int* __restrict__ gsize, const float* __restrict__ qg,
                       const float* __restrict__ norms, float* __restrict__ out_s,
                       int* __restrict__ out_i, int Gn, int D, int NB, int NBS, int stage_floats,
                       int C, int ct, int kk, int cap, int is_l2, float slot_mult, float levels) {
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
  float* buf = qs + NB * QR * kBox;       // [QT][cap] the chunk's packed candidates
  float* ls = buf + QT * cap;             // [QT][3 kk] merge scores
  int* li = reinterpret_cast<int*>(ls + QT * 3 * kk);          // [QT][3 kk] merge slots
  float* rowp = reinterpret_cast<float*>(li + QT * 3 * kk);    // [QT][4]
  float* red = rowp + 4 * QT;             // [QR][NW][2] = (min, max) per warp, at most 512
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * 32 * kWarps);  // one a ring stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int wn = warp % NW;
  const int row0 = (warp / NW) * (16 * MT), col0 = wn * (8 * NT);
  const int W = kBf16 ? D >> 1 : D;     // 32-bit words of a row (qg: the tiles' words)
  const int ksteps = depth_steps(D, kBf16);
  const int box_cols = kBf16 ? 2 * kBox : kBox;  // elements of a box row
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment: a stage holds NBS boxes
  const bool l2 = is_l2 != 0;

  const int first = blockIdx.x, step = gridDim.x, end = Gn;
  auto size_of = [&](int g) { return gp[g] >= 0 ? min(gsize[g], C) : 0; };
  // Ghost groups write (-inf, -1) and take no part in the walk.
  for (int g = first; g < end; g += step)
    if (size_of(g) <= 0)
      for (int i = threadIdx.x; i < QT * kk; i += kThreads) {
        out_s[(size_t)g * QT * kk + i] = -INFINITY;
        out_i[(size_t)g * QT * kk + i] = -1;
      }
  auto next_live = [&](int g) {
    while (g < end && size_of(g) <= 0) g += step;
    return g;
  };
  auto chunks_of = [&](int size) { return (size + ct - 1) / ct; };
  auto segs_of = [&](int size, int c) { return (min(size - c * ct, ct) + kFold - 1) / kFold; };

  // The producer walks the same units a stage ahead of the consumer.
  mbar_init(bars);
  int pg = next_live(first), pc = 0, pv = 0, pd = 0, pnseg = 0, prow = 0, psize = 0;
  auto producer_unit = [&]() {  // (pc == 0: a new group, whose size and first row are read once)
    if (pg < end) {
      if (pc == 0) {
        psize = size_of(pg);
        prow = gp[pg] * C;  // the chunk's first row of the slabs viewed as [P C, D]
      }
      pnseg = segs_of(psize, pc);
    }
  };
  producer_unit();
  auto prefetch = [&](int stage) {
    if (pg < end) {
      const int s = pv < pnseg ? pv : pv - pnseg;
      if (!(ND == 1 && pnseg == 2 && pv == 2))
        segment_load_async(ring + stage * stage_floats, &cmap, prow + s * kFold, pd * NBS,
                           min(NBS, NB - pd * NBS), bars + stage, box_cols);
      if (++pd < ND) return;
      pd = 0;
      if (++pv < 2 * pnseg - 1) return;
      pv = 0;
      prow += ct;
      if (++pc == chunks_of(psize)) {
        pc = 0;
        pg = next_live(pg + step);
      }
      producer_unit();
    }
  };
  int cg = pg, cc = 0, cv = 0, cd = 0, stage = 0;
  uint32_t parity = 0;  // bit s: the parity of stage s's next completed phase
  prefetch(0);

  // Rows row0 + 16 i + g4 + 8 h at [2 i + h], over this thread's columns.
  float mn[2 * MT], mx[2 * MT];
  float acc[T][4];  // the scores of this thread's entries, tile (i, j) at i NT + j
  int cnt[R], cur[R], nc[R];
  float thr[R];
  int size = 0, csize = 0, nseg = 0;
  const float* nrm = norms;   // the chunk's norms
  const float* gnrm = norms;  // the group's partition's norms
  const float inv_mult = 1.0f / slot_mult;  // a power of two: v * inv_mult is exact
  // The dequantized score and global slot of a chunk's packed value into a
  // row's candidate third at pos.
  auto put_candidate = [&](int row, int pos, float v) {
    const float key = floorf(v * inv_mult);
    ls[(size_t)row * 3 * kk + 2 * kk + pos] =
        __fadd_rn(rowp[4 * row], __fmul_rn(key, rowp[4 * row + 2]));
    li[(size_t)row * 3 * kk + 2 * kk + pos] = cc * ct + (int)(v - key * slot_mult);
  };
  while (cg < end) {
    float* stage_mem = ring + stage * stage_floats;
    prefetch(stage ^ 1);
    if (cv == 0 && cd == 0) {
      if (cc == 0) {  // a new group: its query tile and empty merge lists
        size = size_of(cg);
        gnrm = norms + (size_t)gp[cg] * C;
        // The last product of the previous group ended before a barrier.
        query_tile_load(qs, qg + (size_t)cg * QT * W, QT, QR, W, NB);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = warp + kWarps * r;
          for (int e = lane; e < kk; e += 32) {
            ls[(size_t)row * 3 * kk + e] = -INFINITY;
            li[(size_t)row * 3 * kk + e] = -1;
          }
          if (lane == 0) rowp[4 * row + 3] = -INFINITY;
          cur[r] = 0;
        }
      }
      csize = min(size - cc * ct, ct);
      nseg = (csize + kFold - 1) / kFold;
      nrm = gnrm + (size_t)cc * ct;
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        mn[m] = INFINITY;
        mx[m] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cnt[r] = 0;
        nc[r] = 0;
        thr[r] = -1.0f;
      }
    }
    const int s = cv < nseg ? cv : cv - nseg;
    // This thread's norms, asked for before the product so that they arrive
    // under it.
    const int lnb = s * kFold + col0 + 2 * t4;
    float nv[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ln = lnb + 8 * j + c;
        nv[j][c] = (l2 && ln < csize) ? __ldg(nrm + ln) : 0.0f;
      }
    if (!(ND == 1 && nseg == 2 && cv == 2)) {  // the current stage has landed (or was left here)
      mbar_wait(bars + stage, (parity >> stage) & 1u);
      parity ^= 1u << stage;
    }
    __syncthreads();  // and the query tile, the lists and the thresholds are in place

    mma_tile_any<kBf16, MT, NT>(acc, qs + cd * NBS * QR * kBox, stage_mem, row0, col0, QR,
                                min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
    if (cd + 1 < ND) {  // the segment's next depth chunk adds to acc
      __syncthreads();  // the stage is consumed: its buffer may be refilled
      stage ^= 1;
      ++cd;
      continue;
    }
    cd = 0;
    if (l2) {
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // 2 dot is exact, so a contraction into fmaf changes nothing
          acc[ti][e] = 2.0f * acc[ti][e] - nv[ti % NT][e & 1];
    }

    // The packed values of the scores in acc whose dequantized score is not
    // below the row's kk-th best so far (else -1), through the tile laid over
    // the consumed stage, into each row's candidate buffer. Every warp must
    // have finished reading the stage before the call.
    auto select_segment = [&]() {
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        const int row = row0 + 16 * (m / 2) + g4 + 8 * (m % 2);
        if (row < QT) {
          const float rmin = rowp[4 * row], scale = rowp[4 * row + 1];
          const float stp = rowp[4 * row + 2], ts = rowp[4 * row + 3];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int ln = lnb + 8 * j + c;
              const float key = floorf((acc[(m / 2) * NT + j][2 * (m % 2) + c] - rmin) * scale);
              // The dequantized score as the merge computes it: never
              // contracted into an fma, ties between chunks decide winners.
              const bool keep = ln < csize && !(__fadd_rn(rmin, __fmul_rn(key, stp)) < ts);
              v[c] = keep ? key * slot_mult + (float)ln : -1.0f;
            }
            *reinterpret_cast<float2*>(stage_mem + row * kTileStride + col0 + 8 * j + 2 * t4) =
                make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      float v[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[r][j] = stage_mem[(warp + kWarps * r) * kTileStride + lane + 32 * j];
      if (nseg == 1) {  // the whole chunk is in these registers: its kk best straight from them
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool any = fmaxf(fmaxf(v[r][0], v[r][1]), fmaxf(v[r][2], v[r][3])) >= 0.0f;
          if (!__any_sync(0xffffffffu, any)) continue;  // no value above the row's kk-th best so far
          unsigned keep[4];
          int n = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            keep[j] = __ballot_sync(0xffffffffu, v[r][j] >= 0.0f);
            n += __popc(keep[j]);
          }
          if (n > kk) {  // the kk-th largest value, by kk rounds of a warp maximum below the last
            float kth = 16777216.0f;  // 2^24: above every packed value
            for (int i = 0; i < kk; ++i) {
              float m = -1.0f;
#pragma unroll
              for (int j = 0; j < 4; ++j) m = fmaxf(m, v[r][j] < kth ? v[r][j] : -1.0f);
              kth = packed_max(0xffffffffu, m);
            }
            n = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              keep[j] = __ballot_sync(0xffffffffu, v[r][j] >= kth);
              n += __popc(keep[j]);
            }
          }
          int pos = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((keep[j] >> lane) & 1u)
              put_candidate(warp + kWarps * r, pos + __popc(keep[j] & ((1u << lane) - 1u)),
                            v[r][j]);
            pos += __popc(keep[j]);
          }
          nc[r] = n;
        }
        return;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float top = fmaxf(fmaxf(v[r][0], v[r][1]), fmaxf(v[r][2], v[r][3]));
        if (!__any_sync(0xffffffffu, top > thr[r])) continue;
        float* b = buf + (size_t)(warp + kWarps * r) * cap;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cnt[r] + 32 > cap) {  // warp-uniform
            thr[r] = cut_row(b, cnt[r], kk);
            cnt[r] = kk;
          }
          const bool take = v[r][j] > thr[r];
          const unsigned m = __ballot_sync(0xffffffffu, take);
          if (take) b[cnt[r] + __popc(m & ((1u << lane) - 1u))] = v[r][j];
          cnt[r] += __popc(m);
        }
      }
    };

    if (cv < nseg) {  // pass 1: each row's min and max over the chunk's valid lanes
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (lnb + 8 * (ti % NT) + (e & 1) < csize) {
            const int m = 2 * (ti / NT) + (e >> 1);
            mn[m] = fminf(mn[m], acc[ti][e]);
            mx[m] = fmaxf(mx[m], acc[ti][e]);
          }
      if (cv == nseg - 1) {  // the ranges are complete: select from acc
#pragma unroll
        for (int m = 0; m < 2 * MT; ++m) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            mn[m] = fminf(mn[m], __shfl_xor_sync(0xffffffffu, mn[m], o));
            mx[m] = fmaxf(mx[m], __shfl_xor_sync(0xffffffffu, mx[m], o));
          }
          if (t4 == 0) {
            const int row = row0 + 16 * (m / 2) + g4 + 8 * (m % 2);
            red[(row * NW + wn) * 2] = mn[m];
            red[(row * NW + wn) * 2 + 1] = mx[m];
          }
        }
        __syncthreads();  // also: every warp has finished reading the stage
        if (threadIdx.x < QT) {
          const int row = threadIdx.x;
          float rmin = INFINITY, rmax = -INFINITY;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            rmin = fminf(rmin, red[(row * NW + w) * 2]);
            rmax = fmaxf(rmax, red[(row * NW + w) * 2 + 1]);
          }
          const float rng = fmaxf(rmax - rmin, kMinRange);
          rowp[4 * row] = rmin;
          rowp[4 * row + 1] = levels / rng;
          rowp[4 * row + 2] = __fdiv_rn(rng, levels);
        }
        __syncthreads();
      }
    } else {  // pass 2: the same scores, to be quantized with the row's range
      __syncthreads();  // every warp has finished reading the stage
    }
    if (cv >= nseg - 1) select_segment();  // from the last visit of pass 1 on
    fence_async_proxy();  // the tile's stores, before the copy that refills the stage
    __syncthreads();      // the stage is consumed: its buffer may be refilled
    stage ^= 1;
    if (++cv < 2 * nseg - 1) continue;
    cv = 0;

    // The chunk's winners (a chunk of several segments: its buffer cut to the
    // kk best values and dequantized) merged with each row's best so far.
    if (nseg > 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* b = buf + (size_t)(warp + kWarps * r) * cap;
        if (cnt[r] > kk) {  // warp-uniform
          cut_row(b, cnt[r], kk);
          cnt[r] = kk;
        }
        for (int e = lane; e < cnt[r]; e += 32) put_candidate(warp + kWarps * r, e, b[e]);
        nc[r] = cnt[r];
      }
    }
    __syncwarp();
    if (kk <= 32) {
      insert_rows<R>(ls, li, cur, nc, kk);
    } else {
      merge_rows<R>(ls, li, cur, nc, kk);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {  // the row's new kk-th best score: the threshold of the next chunk
      const int row = warp + kWarps * r;
      if (nc[r] > 0 && lane == 0) rowp[4 * row + 3] = ls[(size_t)row * 3 * kk + cur[r] * kk + kk - 1];
    }
    __syncwarp();
    if (++cc < chunks_of(size)) continue;
    cc = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int e = lane; e < kk; e += 32) {
        out_s[((size_t)cg * QT + row) * kk + e] = ls[(size_t)row * 3 * kk + cur[r] * kk + e];
        out_i[((size_t)cg * QT + row) * kk + e] = li[(size_t)row * 3 * kk + cur[r] * kk + e];
      }
    }
    __syncwarp();
    cg = next_live(cg + step);
  }
}

template <bool kBf16>
int launch_chunk_merge_mma(const void* gp, const void* gsize, const void* qg, const void* codes,
                           const void* norms, void* out_s, void* out_i, int Gn, int qt, int D,
                           int P, int C, int ct, int kk, int is_l2, float slot_mult,
                           float levels, void* stream) {
  const int W = row_words(D, kBf16);
  const int NB = tile_boxes(W);
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D, kFold,
                                 kBf16 ? 2 : 4);
  if (me != 0) return me;
  const RingShape shape = chunk_merge_mma_shape(qt, W, kk);
  const size_t smem = chunk_merge_mma_smem(qt, W, kk, shape.NBS, shape.cap);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  cudaStream_t st = (cudaStream_t)stream;
#define QK_CHUNK_MERGE_MMA(QT)                                                             \
  case QT: {                                                                               \
    cudaError_t e = allow_smem(chunk_merge_mma_kernel<QT, kBf16>, smem);                   \
    if (e != cudaSuccess) return (int)e;                                                   \
    chunk_merge_mma_kernel<QT, kBf16><<<grid, kThreads, smem, st>>>(                       \
        cmap, (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)norms,    \
        (float*)out_s, (int*)out_i, Gn, D, NB, shape.NBS, ring_stage_floats(qt, shape.NBS), \
        C, ct, kk, shape.cap, is_l2, slot_mult, levels);                                   \
    break;                                                                                 \
  }
  switch (qt) {
    QK_CHUNK_MERGE_MMA(8)
    QK_CHUNK_MERGE_MMA(16)
    QK_CHUNK_MERGE_MMA(32)
    QK_CHUNK_MERGE_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_CHUNK_MERGE_MMA
  return (int)cudaGetLastError();
}

// K4 (on whole partitions or a chunk table) on operands of type T.
template <typename T>
int rowscale_topk(const void* gp, const void* gsize, const void* qsrc, const void* row_off,
                  const void* qg, const void* codes, const void* norms, void* out, void* stats,
                  int Gn, int qt, int D, int P, int C, int kk, int is_l2, float slot_mult,
                  float levels, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  switch (rowscale_topk_body(qt, D, kk, row_off != nullptr, kBf16)) {
    case 2:
      return launch_rowscale_topk_mma<false, kBf16>(gp, gsize, qg, codes, norms, out, stats, Gn,
                                                    qt, D, P, C, kk, is_l2, slot_mult, levels,
                                                    stream);
    case 1:
      return launch_rowscale_chunk<T>(gp, gsize, qsrc, row_off, qg, codes, norms, out, stats,
                                      Gn, qt, D, C, kk, is_l2, slot_mult, levels, stream);
    default:
      return launch_rowscale<false, T>(gp, gsize, qsrc, row_off, qg, codes, norms, out, stats,
                                       Gn, qt, D, C, kk, is_l2, slot_mult, levels, stream);
  }
}

// K5 on operands of type T, at fold width `fold` (32, 64 or 128 m dividing
// C; the Python wrapper checks).
template <typename T>
int rowscale_fold(const void* gp, const void* gsize, const void* qg, const void* codes,
                  const void* norms, void* out, void* stats, int Gn, int qt, int D, int P, int C,
                  int kk, int is_l2, float slot_mult, float levels, int fold, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (rowscale_fold_body(qt, D, kBf16, fold, kk) == 2)
    return launch_rowscale_topk_mma<true, kBf16>(gp, gsize, qg, codes, norms, out, stats, Gn, qt,
                                                 D, P, C, kk, is_l2, slot_mult, levels, stream,
                                                 fold);
  return launch_rowscale<true, T>(gp, gsize, nullptr, nullptr, qg, codes, norms, out, stats, Gn,
                                  qt, D, C, kk, is_l2, slot_mult, levels, stream, fold);
}

// K7 on operands of type T.
template <typename T>
int chunk_merge(const void* gp, const void* gsize, const void* qg, const void* codes,
                const void* norms, void* out_s, void* out_i, int Gn, int qt, int D, int P, int C,
                int ct, int kk, int is_l2, float slot_mult, float levels, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (chunk_merge_body(qt, D, kk, kBf16) == 1)
    return launch_chunk_merge_mma<kBf16>(gp, gsize, qg, codes, norms, out_s, out_i, Gn, qt, D, P,
                                         C, ct, kk, is_l2, slot_mult, levels, stream);
  return launch_chunk_merge<T>(gp, gsize, qg, codes, norms, out_s, out_i, Gn, qt, D, C, ct, kk,
                               is_l2, slot_mult, levels, stream);
}

}  // namespace

// The launchers: qk_rowscale_topk, qk_rowscale_fold and qk_chunk_merge on
// f32 qg and codes, the same names with _bf16 on bf16 (the same arguments;
// norms, outputs and stats f32 either way). This file defines the f32 ones;
// grouped_rowscale_bf16.cu includes it with QK_BF16_UNIT defined, which
// makes QK_T bf16 and names the entries with _bf16, so that the two
// instantiations compile in parallel. The *_body queries take the element
// size (4 f32, 2 bf16).
#ifdef QK_BF16_UNIT
#define QK_T __nv_bfloat16
#define QK_ENTRY(name) name##_bf16
#else
#define QK_T float
#define QK_ENTRY(name) name
#endif

extern "C" {

// K4: replaces quake_tpu/ops/pallas_grouped.py::_v3p_kernel, _v3pn_kernel and
// _v6_kernel (_v3p_group_body + _v3p_select on a whole partition; qsrc and
// row_off null) and _v4_kernel (the same body on one chunk per group; qsrc
// and row_off given).
int QK_ENTRY(qk_rowscale_topk)(const void* gp, const void* gsize, const void* qsrc,
                               const void* row_off, const void* qg, const void* codes,
                               const void* norms, void* out, void* stats, int Gn, int qt, int D,
                               int P, int C, int kk, int is_l2, float slot_mult, float levels,
                               void* stream) {
  return rowscale_topk<QK_T>(gp, gsize, qsrc, row_off, qg, codes, norms, out, stats, Gn, qt, D,
                             P, C, kk, is_l2, slot_mult, levels, stream);
}

// K5: replaces quake_tpu/ops/pallas_grouped.py::_v7_kernel (_v7_select +
// _v7_fold_rounds). P: partitions of codes, for the tensor map over [P C, D].
int QK_ENTRY(qk_rowscale_fold)(const void* gp, const void* gsize, const void* qg,
                               const void* codes, const void* norms, void* out, void* stats,
                               int Gn, int qt, int D, int P, int C, int kk, int is_l2,
                               float slot_mult, float levels, int fold, void* stream) {
  return rowscale_fold<QK_T>(gp, gsize, qg, codes, norms, out, stats, Gn, qt, D, P, C, kk,
                             is_l2, slot_mult, levels, fold, stream);
}

// K7: replaces quake_tpu/ops/pallas_grouped.py::_v5_kernel.
int QK_ENTRY(qk_chunk_merge)(const void* gp, const void* gsize, const void* qg,
                             const void* codes, const void* norms, void* out_s, void* out_i,
                             int Gn, int qt, int D, int P, int C, int ct, int kk, int is_l2,
                             float slot_mult, float levels, void* stream) {
  return chunk_merge<QK_T>(gp, gsize, qg, codes, norms, out_s, out_i, Gn, qt, D, P, C, ct, kk,
                           is_l2, slot_mult, levels, stream);
}

#ifndef QK_BF16_UNIT
// The body qk_rowscale_topk runs at this shape: 2 the tensor-core body, 1 the
// persistent CUDA-core body for a chunk table, 0 the CUDA-core body of one
// block a group.
int qk_rowscale_topk_body(int qt, int D, int kk, int chunked, int elem_bytes) {
  return rowscale_topk_body(qt, D, kk, chunked != 0, elem_bytes == 2);
}

// The body qk_rowscale_fold runs at this shape and fold width: 2 the
// tensor-core body, 0 the CUDA-core body of one block a group (kk changes it
// only through the fold lists of fold = 128 m, m > 1).
int qk_rowscale_fold_body(int qt, int D, int kk, int elem_bytes, int fold) {
  return rowscale_fold_body(qt, D, elem_bytes == 2, fold, kk);
}

// The body qk_chunk_merge runs at this shape: 1 the tensor-core body, 0 the
// CUDA-core body of one block a group.
int qk_chunk_merge_body(int qt, int D, int kk, int elem_bytes) {
  return chunk_merge_body(qt, D, kk, elem_bytes == 2);
}
#endif

}  // extern "C"
