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
// Thread layout of the selection rounds, shared by the kernels: a warp owns
// whole rows, and lane l of a warp owns the four fold columns {l, l+32, l+64,
// l+96}, so a round's row maximum is a local max over four registers plus a
// 5-step shuffle reduction. K2, K3 and K1's CUDA-core body do all arithmetic in
// f32 on the CUDA cores; K1's main body takes its products on the tensor
// cores, as split TF32 operands that keep f32 accuracy (common.cuh, mma_tile).
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
// Bound on the H100: tensor-core operations. A group does 2 qt C D flops
// against C D 4 bytes of slab, i.e. qt / 2 = 32 flops per byte at qt = 64; the
// split product costs three TF32 products per f32 one, so the operations bound
// is 3 x flops / 495 TFLOP/s, and the bytes bound (every probed partition read
// once) stays below it as long as the L2 cache carries the reuse of a slab by
// the groups that share its partition.
//
// Two bodies, chosen by shape in the launcher (grouped_scan_uses_mma), never
// after a failure:
//
// grouped_scan_mma_kernel, the main body (D % 4 == 0, and a whole-D query
// tile that fits shared memory beside the ring). What bounded the first design: an f32 product on the CUDA cores
// that kept shared memory as busy as the FMA pipe, loads that nothing
// overlapped, and one short-lived block per group. This one is persistent:
// one block per SM, block b takes groups b, b + grid, ..., so the blocks that
// run together read the same few partitions (the groups are partition-major).
// The slab streams through a ring of two 128-row segment buffers filled by
// the Tensor Memory Accelerator (cp.async.bulk.tensor from a tensor map over
// the slabs, a box of 128 rows x 32 columns a copy, completing on the stage's
// mbarrier; 16-byte cp.async, and bulk copies of one row each, kept the warps
// waiting on the load path for a tenth of the kernel's time), the load of
// the next segment (of this group or the next) started before the current one
// is multiplied; rows at or past the group's size are masked. A ring stage
// holds all of D up to 128 columns; a deeper D streams through it in depth
// chunks of four, two or one boxes (whatever fits beside the query tile) and
// the accumulator carries over a segment's chunks. The product is
// mma_tile (common.cuh: mma.sync TF32 on split operands, "3xTF32"), which
// holds the pace: an mma.sync keeps the warp's dispatch slot while it runs, so
// the loads, splits and additions around it add to its time instead of
// hiding under it. The fold-128 top-2 state (m1, m2) lives in the
// accumulator's layout, one pair per (row, column) entry a thread owns, so a
// segment's fold needs no exchange between threads. At a group's end (m1,
// m2) pass through a [qt][128] tile in shared memory into the rounds' layout
// (a warp owns whole rows) and the kk rounds run as in every other kernel of
// this file.
//
// grouped_scan_kernel, the CUDA-core body (D % 4 != 0: a row is not 16-byte
// aligned): one block per group,
// the [qt, D] query tile in shared memory, one 128-row segment buffer, each
// thread R x 4 dot products and (m1, m2) pairs in registers.
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

// Built with -DQK_PRODUCT_ONLY (a timing aid, never the package's build) the
// body keeps its loads and products and drops the keys, the fold and the
// rounds: a running maximum stands in for them, and what it writes is no result.
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
grouped_scan_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                        const int* __restrict__ gsize, const float* __restrict__ qg,
                        const float* __restrict__ normsT, float* __restrict__ out, int Gn,
                        int D, int NB, int NBS, int C, int kk, float slot_mult, float levels) {
  constexpr int MT = QT >= 32 ? 2 : 1;       // m16-tiles per warp
  constexpr int MW = QT >= 64 ? 2 : 1;       // warps along the query rows
  constexpr int NW = kWarps / MW;            // warps along the segment
  constexpr int NT = 16 / NW;                // n8-tiles per warp
  constexpr int T = MT * NT;                 // accumulator tiles per warp
  constexpr int QR = 16 * MT * MW;           // rows of the query tile (zero from QT)
  constexpr int R = QT / 8;                  // rows per warp in the rounds
  extern __shared__ __align__(16) float smem[];
  float* ring = smem_aligned(smem);                        // 2 x NBS boxes of [128][32]
  float* qs = ring + 2 * NBS * kSegBox;                    // NB boxes of [QR][32]
  float* tile = qs + NB * QR * kBox;                       // [QT][kTileStride]
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile + QT * kTileStride);  // one a ring stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int row0 = (warp / NW) * (16 * MT), col0 = (warp % NW) * (8 * NT);
  const int ksteps = (D + 7) >> 3;
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment: a stage holds NBS boxes
  const int step = gridDim.x;

  // Ghost groups write -1 and take no part in the walk.
  for (int g = blockIdx.x; g < Gn; g += step)
    if (min(gsize[g], C) <= 0)
      for (int i = threadIdx.x; i < QT * kk; i += kThreads) out[(size_t)g * QT * kk + i] = -1.0f;
  auto next_live = [&](int g) {
    while (g < Gn && min(gsize[g], C) <= 0) g += step;
    return g;
  };
  mbar_init(bars);
  // The producer walks one stage (a depth chunk of a segment) ahead of the
  // consumer, across segments and groups.
  int pg = next_live(blockIdx.x), ps = 0, pd = 0, pnseg = 0, prow = 0;
  auto producer_group = [&]() {
    if (pg < Gn) {
      pnseg = (min(gsize[pg], C) + kFold - 1) / kFold;
      prow = gp[pg] * C;  // the partition's first row of the slabs viewed as [P C, D]
    }
  };
  producer_group();
  auto prefetch = [&](int stage) {
    if (pg < Gn) {
      segment_load_async(ring + stage * NBS * kSegBox, &cmap, prow + ps * kFold, pd * NBS,
                         min(NBS, NB - pd * NBS), bars + stage);
      if (++pd < ND) return;
      pd = 0;
      if (++ps == pnseg) {
        pg = next_live(pg + step);
        ps = 0;
        producer_group();
      }
    }
  };
  int cg = pg, cs = 0, cd = 0, stage = 0;
  uint32_t parity = 0;  // bit s: the parity of stage s's next completed phase
  prefetch(0);

  float m1[T][4], m2[T][4];  // tile (i, j) at i NT + j
  float acc[T][4];           // carried over a segment's depth chunks
  int size = 0, nseg = 0;
  const float* nrm = normsT;
  while (cg < Gn) {
    prefetch(stage ^ 1);
    if (cs == 0 && cd == 0) {
      size = min(gsize[cg], C);
      nseg = (size + kFold - 1) / kFold;
      nrm = normsT + (size_t)gp[cg] * C;
      // The last product of the previous group ended before a barrier.
      query_tile_load(qs, qg + (size_t)cg * QT * D, QT, QR, D, NB);
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e) m1[ti][e] = m2[ti][e] = -1.0f;
    }
    // This thread's norms, asked for before the product so that they arrive
    // under it (C % 128 == 0 and even columns: 8-byte aligned).
    const int lnb = cs * kFold + col0 + 2 * t4;
    float2 nv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      nv[j] = __ldg(reinterpret_cast<const float2*>(nrm + lnb + 8 * j));
    mbar_wait(bars + stage, (parity >> stage) & 1u);  // the current stage has landed
    parity ^= 1u << stage;
    __syncthreads();  // and the query tile is in place
    mma_tile<MT, NT>(acc, qs + cd * NBS * QR * kBox, ring + stage * NBS * kSegBox, row0, col0, QR,
                     min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
    if (cd + 1 < ND) {  // the segment's next depth chunk adds to acc
      __syncthreads();  // the stage is consumed: its buffer may be refilled
      stage ^= 1;
      ++cd;
      continue;
    }
    cd = 0;
#pragma unroll
    for (int ti = 0; ti < T; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#ifdef QK_PRODUCT_ONLY
        m1[ti][e] = fmaxf(m1[ti][e], acc[ti][e] - nv[ti % NT].x);
#else
        const int j = ti % NT;
        const int ln = lnb + 8 * j + (e & 1);
        const float n = (e & 1) ? nv[j].y : nv[j].x;
        const float key = fminf(fmaxf(floorf(acc[ti][e] - n), 0.0f), levels);
        fold2(m1[ti][e], m2[ti][e], ln < size ? key * slot_mult + (float)ln : -1.0f);
#endif
      }
    __syncthreads();  // the segment is consumed: its buffer may be refilled
    stage ^= 1;
    if (++cs < nseg) continue;

    // The group's end: (m1, m2) into the rounds' layout, then kk rounds.
    float* og = out + (size_t)cg * QT * kk;
#ifdef QK_PRODUCT_ONLY
    float b = m2[0][0];
#pragma unroll
    for (int ti = 0; ti < T; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) b = fmaxf(b, m1[ti][e]);
    b = warp_max(b);
    if (lane == 0) og[warp] = b;
#else
    float r1[R][4], r2[R][4];
    auto to_rounds = [&](const float (&m)[T][4], float (&r)[R][4]) {
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * (ti / NT) + g4 + 8 * h;
          if (row < QT)
            *reinterpret_cast<float2*>(tile + row * kTileStride + col0 + 8 * (ti % NT) +
                                       2 * t4) = make_float2(m[ti][2 * h], m[ti][2 * h + 1]);
        }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[rr][j] = tile[(warp + kWarps * rr) * kTileStride + lane + 32 * j];
      __syncthreads();
    };
    to_rounds(m1, r1);
    to_rounds(m2, r2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      for (int i = 0; i < kk; ++i) {
        const float b = select_round(r1[r], r2[r]);
        if (lane == 0) og[row * kk + i] = b;
      }
    }
#endif
    cg = next_live(cg + step);
    cs = 0;
  }
}

// Shared memory of the tensor-core body with ring stages of NBS boxes, in
// bytes: room to reach a 1024-byte boundary, ring, query tile, value tile, the
// two stage barriers.
inline size_t grouped_scan_mma_smem(int qt, int D, int NBS) {
  return 1024 + 16 +
         (size_t)(2 * NBS * kSegBox + tile_boxes(D) * (qt < 16 ? 16 : qt) * kBox +
                  qt * kTileStride) *
             sizeof(float);
}

// Boxes of a ring stage of the tensor-core body: all of D's, or the most of
// 4, 2 and 1 that fits beside the whole-D query tile. 0: the body does not
// serve the shape (D % 4 != 0, or no stage fits).
inline int grouped_scan_stage_boxes(int qt, int D) {
  if (D % 4 != 0) return 0;
  for (int nbs = 4; nbs >= 1; nbs >>= 1) {
    const int NBS = nbs < tile_boxes(D) ? nbs : tile_boxes(D);
    if (grouped_scan_mma_smem(qt, D, NBS) <= kSmemLimit) return NBS;
  }
  return 0;
}

inline bool grouped_scan_uses_mma(int qt, int D) { return grouped_scan_stage_boxes(qt, D) > 0; }

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

int launch_grouped_scan_mma(const void* gp, const void* gsize, const void* qg, const void* codes,
                            const void* normsT, void* out, int Gn, int qt, int D, int P, int C,
                            int kk, float slot_mult, float levels, cudaStream_t st) {
  const int NBS = grouped_scan_stage_boxes(qt, D);
  const size_t smem = grouped_scan_mma_smem(qt, D, NBS);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D);
  if (me != 0) return me;
#define QK_GROUPED_MMA(QT)                                                              \
  case QT: {                                                                            \
    cudaError_t e = allow_smem(grouped_scan_mma_kernel<QT>, smem);                      \
    if (e != cudaSuccess) return (int)e;                                                \
    grouped_scan_mma_kernel<QT><<<grid, kThreads, smem, st>>>(                          \
        cmap, (const int*)gp, (const int*)gsize, (const float*)qg, (const float*)normsT, \
        (float*)out, Gn, D, tile_boxes(D), NBS, C, kk, slot_mult, levels);              \
    break;                                                                              \
  }
  switch (qt) {
    QK_GROUPED_MMA(8)
    QK_GROUPED_MMA(16)
    QK_GROUPED_MMA(32)
    QK_GROUPED_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_GROUPED_MMA
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// 1 when the launcher runs the tensor-core body at this shape, 0 for the
// CUDA-core body.
int qk_grouped_scan_uses_mma(int qt, int D) { return grouped_scan_uses_mma(qt, D) ? 1 : 0; }

int qk_grouped_scan(const void* gp, const void* gsize, const void* qg, const void* codes,
                    const void* normsT, void* out, int Gn, int qt, int D, int P, int C, int kk,
                    float slot_mult, float levels, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (grouped_scan_uses_mma(qt, D))
    return launch_grouped_scan_mma(gp, gsize, qg, codes, normsT, out, Gn, qt, D, P, C, kk,
                                   slot_mult, levels, st);
  const int Dp = padded_dim(D);
  const size_t smem = (size_t)(qt * Dp + kFold * (Dp + 1)) * sizeof(float);
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
