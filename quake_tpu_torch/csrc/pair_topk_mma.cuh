// The tensor-core body of the exact (score, index) selections: multi_topk,
// sized_topk and K9, packed_topk (grouped_variants.cu), and K6, exact_topk,
// in its two modes (grouped_exact.cu); and of K8, raw_scores
// (grouped_variants.cu), which keeps every score. One kernel, templated over
// what differs:
//
//   mode     valid lanes            l2 score                  index          none
//   kMulti   ids >= 0, whole slab   2<q,x> - |q|^2 - |x|^2    C - 1 - slot   C
//   kById    ids >= 0, whole slab   2<q,x> - |q|^2 - |x|^2    the id         -1
//   kBySlot  lane < size            2<q,x> - norms[lane]      the slot       -1
//   kSized   lane < size            2<q,x> - |q|^2 - |x|^2    the slot       -1
//   kPacked  ids >= 0, whole slab   2<q,x> - |q|^2 - |x|^2    pack_score     -1
//   kRaw     ids >= 0, whole slab   2<q,x> - |q|^2 - |x|^2    (no selection: -inf)
//
// The ip score is <q, x> in every mode. Each row keeps its kk best (score,
// index) pairs in the pair order (score, then the larger index), so multi's
// index C - 1 - slot puts the smaller slot first among equal scores and
// kById, kBySlot and kSized the larger index. kPacked selects on the pair
// (0, packed value), whose order is the packed int32's order (the packed
// values of valid lanes are distinct and >= 0), and writes the packed values
// alone; the key is not put into the float score, whose 24 bits would round
// its 31 - slot_bits. kRaw keeps no list: it writes the segment's score tile to
// out[g, row, lane] as it stands, -inf where the lane has no id, and nothing
// at or past C. kPacked and kRaw compute their scores by the same code in
// the same order, so K9's output is the top kk of K8's scores, packed, bit
// for bit. Ghost groups (p < 0; in modes kBySlot and kSized also size <= 0)
// write (-inf, none), in mode kRaw -inf in all qt C entries.
//
// Persistent: block b takes groups b, b + grid, ... (partition-major, so
// blocks that run together read the same partitions), and streams each
// group's segments through a ring of two 128-row segment buffers filled by the
// Tensor Memory Accelerator one stage ahead, across group borders, as K4's
// tensor-core body does; mma_tile (3xTF32) multiplies, once a segment. The
// modes that read ids scan the whole slab but skip a segment whose lanes
// below C all have ids < 0: warp 0, which issues the copies, and the consumer
// both skip it by a vote over its ids, so it is neither loaded nor multiplied
// (kRaw writes its -inf all the same).
// Modes kBySlot and kSized load only the ceil(size / 128) segments that
// hold vectors and read no id: the segment that holds the size-th row is
// loaded whole and its lanes at or past the size are masked (what they hold,
// NaN or inf included, reaches no output: a product column and a row's
// |x|^2 are those of its own row alone); no later segment is loaded. Lanes at
// or past C (the next partition's rows, read through the tensor map) are
// masked in every mode. Where the kernel sums the norms, |x|^2 of a
// segment's rows comes from the ring buffer, summed by all threads in one
// fixed order a row (copies of one vector tie bit for bit), and |q|^2 of a
// query row by four threads (strided, then a butterfly sum), the same order
// for every row; a depth chunk of the ring (D past a stage) changes neither
// order. The scores pass through a [QT][kTileStride] tile laid over the
// consumed stage into rows a warp owns. Mode kRaw streams each row of the
// tile out, 16 bytes a lane with streaming stores (__stcs), which drain while
// the next segment multiplies: the bytes K8 writes, not its operations, set
// its least time. A row keeps its kk best pairs as a sorted list: a
// segment's values above the list's kk-th pair are its candidates, cut to
// their kk best by kk rounds of a warp maximum where there are more, and
// merged into the list (insert_rows, or merge_rows past kk = 32). The list
// is the row's output. Indices of valid lanes are
// distinct (slots are; so are the ids of a partition, as the store keeps
// them; so are packed values, by their lane bits), so the order is total.
//
// bf16 codes (kBf16; the JAX package's precision="bf16", the queries rounded
// to bf16 as its wrappers round them): the same body on bf16 tiles, read as
// 32-bit words (two columns a word) and multiplied by mma_tile_bf16, one
// m16n8k16 bf16 product a depth-16 step where the f32 body takes three TF32
// products a depth-8 step; a product of two bf16 values is exact in f32, so
// only the order of the sums differs from the plain version's. A box is 128
// bytes of a row in both (64 bf16 columns), so the ring, the tensor map's
// swizzle and the fragment layout are the f32 body's; the tiles are sized in
// words, so a stage holds twice the depth. |q|^2 comes from the rounded query
// tile and |x|^2 from the ring's bf16 words, each converted exactly and
// summed in the same fixed order as in f32. Its bound: 2 flops a (row, lane,
// column) over 989 TFLOP/s, or 2 bytes an element. It serves D % 8 == 0 (the
// copies' 16-byte rows).

#pragma once

#include <limits.h>

#include "common.cuh"

namespace {

enum class PairMode { kMulti, kById, kBySlot, kSized, kPacked, kRaw };

// K9's packed value of a score at a lane: a monotone map of the f32 bit
// pattern onto uint32 (negative: all bits flipped; else the sign bit set),
// its top 31 - slot_bits bits above the lane.
__device__ __forceinline__ int pack_score(float sc, int lane, int slot_bits) {
  const unsigned bits = __float_as_uint(sc);
  const unsigned key = (bits >> 31) ? ~bits : (bits | 0x80000000u);
  return (int)(((key >> (slot_bits + 1)) << slot_bits) | (unsigned)lane);
}

// Mode kRaw: four scores of one output row, at lanes ln .. ln + 3, by
// streaming stores (16 bytes where C % 4 == 0); nothing at or past C.
__device__ __forceinline__ void raw_store(float* orow, int ln, int C, float4 v) {
  if ((C & 3) == 0) {
    if (ln < C) __stcs(reinterpret_cast<float4*>(orow + ln), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (ln + i < C) __stcs(orow + ln + i, e[i]);
}

// The sum of squares of this thread's half of the columns of one 128-row
// segment tile of `boxes` boxes (row threadIdx.x % 128; half 0 takes the
// even 16-byte chunks, half 1 the odd ones, each in column order; f32 or
// bf16 values), added to a. Every row is summed in the same order, so copies
// of one vector get the same sum.
template <bool kBf16>
__device__ __forceinline__ float segment_row_sumsq(const float* seg, int boxes, float a) {
  const int r = threadIdx.x & (kFold - 1), h = threadIdx.x / kFold;
  for (int q4 = h; q4 < boxes * (kBox / 4); q4 += 2)
    a = sumsq16<kBf16>(*reinterpret_cast<const float4*>(seg + (q4 >> 3) * kSegBox + r * kBox +
                                                        (((q4 & 7) ^ (r & 7)) << 2)),
                       a);
  return a;
}

// Shared memory of the body with rows of W 32-bit words (D f32 or 2 W bf16
// values), in bytes: room to reach a 1024-byte boundary, ring, query tile,
// the rows' lists (3 kk (score, index) pairs a row, see merge_rows), the
// segment's ids, the two halves of its rows' |x|^2, |q|^2 per row, the two
// stage barriers (the same in every mode).
inline size_t pair_topk_mma_smem(int qt, int W, int kk, int NBS) {
  return 1024 + 16 +
         (size_t)(2 * ring_stage_floats(qt, NBS) + tile_boxes(W) * (qt < 16 ? 16 : qt) * kBox +
                  qt * 6 * kk + kFold + 2 * kFold + qt) *
             sizeof(float);
}

// Boxes a ring stage of the body holds (rows of W words); 0: the body does
// not fit.
inline int pair_topk_mma_stage_boxes(int qt, int W, int kk) {
  return ring_stage_boxes(W, [&](int NBS) { return pair_topk_mma_smem(qt, W, kk, NBS); });
}

// Whether the body serves a shape: rows 16-byte aligned for the asynchronous
// copies (D % 4 == 0 in f32, D % 8 == 0 in bf16), and its ring, query tile
// and lists fit.
inline bool pair_topk_mma_serves(int qt, int D, int kk, bool bf16) {
  const int W = row_words(D, bf16);
  return W > 0 && pair_topk_mma_stage_boxes(qt, W, kk) > 0;
}

template <int QT, PairMode M, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
pair_topk_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                     const int* __restrict__ gsize, const float* __restrict__ qg,
                     const float* __restrict__ norms, const int* __restrict__ ids,
                     float* __restrict__ out_s, int* __restrict__ out_i, int Gn, int D, int NB,
                     int NBS, int stage_floats, int C, int kk, int is_l2, int slot_bits) {
  constexpr bool kSlots = M == PairMode::kBySlot || M == PairMode::kSized;  // lanes below the size
  constexpr bool kNorms = M == PairMode::kBySlot;  // the store's norms, not summed here
  constexpr bool kKeep = M == PairMode::kRaw;      // every score out, no selection
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
  const int W = kBf16 ? D >> 1 : D;     // 32-bit words of a row (qg: the tiles' words)
  const int ksteps = depth_steps(D, kBf16);
  const int box_cols = kBf16 ? 2 * kBox : kBox;  // elements of a box row
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment: a stage holds NBS boxes
  const bool l2 = is_l2 != 0;
  const bool sums = l2 && !kNorms;      // |q|^2 and |x|^2 summed here
  const int none = M == PairMode::kMulti ? C : -1;
  const int width = kKeep ? C : kk;     // entries of an output row

  const int first = blockIdx.x, step = gridDim.x, end = Gn;
  // The lanes a group scans (0: a ghost) and its segments.
  auto lanes_of = [&](int g) { return gp[g] < 0 ? 0 : kSlots ? min(gsize[g], C) : C; };
  auto nseg_of = [&](int g) { return (lanes_of(g) + kFold - 1) / kFold; };
  // Ghost groups write (-inf, none) and take no part in the walk.
  for (int g = first; g < end; g += step)
    if (lanes_of(g) <= 0)
      for (int i = threadIdx.x; i < QT * width; i += kThreads) {
        if constexpr (M != PairMode::kPacked) out_s[(size_t)g * QT * width + i] = -INFINITY;
        if constexpr (!kKeep) out_i[(size_t)g * QT * width + i] = none;
      }
  auto next_live = [&](int g) {
    while (g < end && lanes_of(g) <= 0) g += step;
    return g;
  };

  // The producer, warp 0 alone, a stage ahead of the consumer over the same
  // live segments.
  mbar_init(bars);
  int pg = next_live(first), ps = 0, pd = 0, pnseg = pg < end ? nseg_of(pg) : 0;
  auto seg_live = [&](int g, int s) {  // a vote of warp 0 over the segment's ids
    if constexpr (kSlots) {
      return true;
    } else {
      const int* gid = ids + (size_t)gp[g] * C;
      bool any = false;
      for (int j = lane; j < kFold; j += 32) any |= s * kFold + j < C && gid[s * kFold + j] >= 0;
      return __any_sync(0xffffffffu, any) != 0;
    }
  };
  auto next_group = [&]() {
    ps = 0;
    pg = next_live(pg + step);
    if (pg < end) pnseg = nseg_of(pg);
  };
  auto seek = [&]() {  // (pg, ps) to the next live segment from where they stand
    while (pg < end && !seg_live(pg, ps))
      if (++ps == pnseg) next_group();
  };
  auto prefetch = [&](int stage) {
    if (warp != 0 || pg >= end) return;
    segment_load_async(ring + stage * stage_floats, &cmap, gp[pg] * C + ps * kFold, pd * NBS,
                       min(NBS, NB - pd * NBS), bars + stage, box_cols);
    if (++pd < ND) return;
    pd = 0;
    if (++ps == pnseg) next_group();
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
    const int n = lanes_of(g), nseg = nseg_of(g);
    const int* gid = kSlots ? nullptr : ids + (size_t)gp[g] * C;
    const float* nrm = kNorms ? norms + (size_t)gp[g] * C : nullptr;
    // The last product on the previous group's tile ended before a barrier.
    query_tile_load(qs, qg + (size_t)g * QT * W, QT, QR, W, NB);
    if (sums && threadIdx.x < 4 * QT) {  // |q|^2: four threads a row, each every fourth 16 bytes
      const float4* qrow =
          reinterpret_cast<const float4*>(qg + ((size_t)g * QT + threadIdx.x / 4) * W);
      float a = 0.0f;
      for (int d4 = threadIdx.x & 3; d4 < (W >> 2); d4 += 4)
        a = sumsq16<kBf16>(__ldg(qrow + d4), a);
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
      if constexpr (!kSlots) {
        const int id =
            threadIdx.x < kFold && ln0 + (int)threadIdx.x < C ? gid[ln0 + threadIdx.x] : -1;
        if (threadIdx.x < kFold) sid[threadIdx.x] = id;
        if (!__syncthreads_or(id >= 0)) {  // no lane holds a vector: not loaded either
          if constexpr (kKeep) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              raw_store(out_s + ((size_t)g * QT + warp + kWarps * r) * C, ln0 + 4 * lane, C,
                        make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY));
          }
          continue;
        }
      }
      // Mode kBySlot: this thread's norms, asked for before the product so
      // that they arrive under it.
      float nv[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ln = ln0 + col0 + 8 * j + 2 * t4 + c;
          nv[j][c] = kNorms && l2 && ln < n ? __ldg(nrm + ln) : 0.0f;
        }
      float xp = 0.0f;  // this thread's half of |x|^2 of segment row threadIdx.x % 128
      for (int cd = 0; cd < ND; ++cd) {
        float* stage_mem = ring + stage * stage_floats;
        prefetch(stage ^ 1);
        mbar_wait(bars + stage, (parity >> stage) & 1u);
        parity ^= 1u << stage;
        __syncthreads();  // and the query tile and |q|^2 are in place
        mma_tile_any<kBf16, MT, NT>(acc, qs + cd * NBS * QR * kBox, stage_mem, row0, col0, QR,
                                    min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
        if (sums) xp = segment_row_sumsq<kBf16>(stage_mem, min(NBS, NB - cd * NBS), xp);
        if (cd + 1 < ND) {
          __syncthreads();  // the stage is consumed: its buffer may be refilled
          stage ^= 1;
        }
      }
      float* stage_mem = ring + stage * stage_floats;
      if (sums) xsq[threadIdx.x] = xp;  // [half][row]
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
              if (!l2) {
                v[c] = dot;
              } else if constexpr (kNorms) {
                v[c] = 2.0f * dot - nv[j][c];
              } else {
                v[c] = 2.0f * dot - qsq[row] - (xsq[col] + xsq[kFold + col]);
              }
            }
            *reinterpret_cast<float2*>(stage_mem + row * kTileStride + col0 + 8 * j + 2 * t4) =
                make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      if constexpr (kKeep) {
        // Each warp's rows of the tile, 16 bytes a lane; -inf where the lane
        // holds no vector.
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = warp + kWarps * r;
          float4 t = *reinterpret_cast<const float4*>(stage_mem + row * kTileStride + 4 * lane);
          const int* id4 = sid + 4 * lane;
          if (id4[0] < 0) t.x = -INFINITY;
          if (id4[1] < 0) t.y = -INFINITY;
          if (id4[2] < 0) t.z = -INFINITY;
          if (id4[3] < 0) t.w = -INFINITY;
          raw_store(out_s + ((size_t)g * QT + row) * C, ln0 + 4 * lane, C, t);
        }
      } else {
        // Each warp's rows: a segment's values above the row's kk-th best pair so
        // far, cut to their kk best where there are more, then merged. Mode
        // kPacked selects on (0, the lane's packed value).
        float v[R][4];
        bool ok[4];
        int idx[R][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ln = ln0 + lane + 32 * j;
          int ix = ln;
          if constexpr (M == PairMode::kMulti) {
            ok[j] = sid[lane + 32 * j] >= 0;
            ix = C - 1 - ln;
          } else if constexpr (M == PairMode::kById) {
            ix = sid[lane + 32 * j];
            ok[j] = ix >= 0;
          } else if constexpr (M == PairMode::kPacked) {
            ok[j] = sid[lane + 32 * j] >= 0;
          } else {
            ok[j] = ln < n;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) idx[r][j] = ix;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[r][j] = stage_mem[(warp + kWarps * r) * kTileStride + lane + 32 * j];
            if constexpr (M == PairMode::kPacked) {
              idx[r][j] = pack_score(v[r][j], ln0 + lane + 32 * j, slot_bits);
              v[r][j] = 0.0f;
            }
          }
        int nc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          bool take[4];
          bool any = false;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            take[j] = ok[j] && pair_above(v[r][j], idx[r][j], ths[r], thi[r]);
            any |= take[j];
          }
          nc[r] = 0;
          if (!__any_sync(0xffffffffu, any)) continue;  // no value above the row's kk-th best
          unsigned keep[4];
          int cnt = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            keep[j] = __ballot_sync(0xffffffffu, take[j]);
            cnt += __popc(keep[j]);
          }
          if (cnt > kk) {  // the kk-th best candidate: kk rounds of a warp maximum below the last
            float ks = INFINITY;
            int ki = INT_MAX;
            for (int i = 0; i < kk; ++i) {
              float bs = -INFINITY;
              int bi = -1;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (take[j] && pair_above(ks, ki, v[r][j], idx[r][j]) &&
                    pair_above(v[r][j], idx[r][j], bs, bi)) {
                  bs = v[r][j];
                  bi = idx[r][j];
                }
              warp_max_pair(bs, bi);
              ks = bs;
              ki = bi;
            }
            cnt = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              keep[j] = __ballot_sync(0xffffffffu,
                                      take[j] && !pair_above(ks, ki, v[r][j], idx[r][j]));
              cnt += __popc(keep[j]);
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
              ri[at] = idx[r][j];
            }
            pos += __popc(keep[j]);
          }
          nc[r] = cnt;
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
      }
      fence_async_proxy();  // the tile's stores, before the copy that refills the stage
      __syncthreads();      // the stage and the ids are consumed
      stage ^= 1;
    }
    // Each row's list is its output (mode kRaw: none, kk = 0).
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int e = lane; e < kk; e += 32) {
        const size_t at = (size_t)row * 3 * kk + cur[r] * kk + e;
        const int i = li[at];
        if constexpr (M != PairMode::kPacked) out_s[((size_t)g * QT + row) * kk + e] = ls[at];
        out_i[((size_t)g * QT + row) * kk + e] =
            M == PairMode::kMulti ? (i < 0 ? C : C - 1 - i) : i;
      }
    }
    __syncwarp();
  }
}

// Launches the body in mode M (gsize and norms: mode kBySlot; gsize alone:
// mode kSized; ids: the others; out_s alone: mode kRaw, with kk = 0; out_i
// alone and slot_bits: mode kPacked), on f32 or (kBf16) bf16 qg and codes.
// The caller has checked pair_topk_mma_serves.
template <PairMode M, bool kBf16>
int launch_pair_topk_mma(const void* gp, const void* gsize, const void* qg, const void* codes,
                         const void* norms, const void* ids, void* out_s, void* out_i, int Gn,
                         int qt, int D, int P, int C, int kk, int is_l2, void* stream,
                         int slot_bits = 0) {
  const int W = row_words(D, kBf16);
  const int NB = tile_boxes(W);
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D, kFold,
                                 kBf16 ? 2 : 4);
  if (me != 0) return me;
  const int NBS = pair_topk_mma_stage_boxes(qt, W, kk);
  const size_t smem = pair_topk_mma_smem(qt, W, kk, NBS);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  cudaStream_t st = (cudaStream_t)stream;
#define QK_PAIR_MMA(QT)                                                                    \
  case QT: {                                                                               \
    cudaError_t e = allow_smem(pair_topk_mma_kernel<QT, M, kBf16>, smem);                  \
    if (e != cudaSuccess) return (int)e;                                                   \
    pair_topk_mma_kernel<QT, M, kBf16><<<grid, kThreads, smem, st>>>(                      \
        cmap, (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)norms,    \
        (const int*)ids, (float*)out_s, (int*)out_i, Gn, D, NB, NBS,                       \
        ring_stage_floats(qt, NBS), C, kk, is_l2, slot_bits);                              \
    break;                                                                                 \
  }
  switch (qt) {
    QK_PAIR_MMA(8)
    QK_PAIR_MMA(16)
    QK_PAIR_MMA(32)
    QK_PAIR_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_PAIR_MMA
  return (int)cudaGetLastError();
}

}  // namespace
