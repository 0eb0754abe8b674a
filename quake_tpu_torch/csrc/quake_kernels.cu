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
// 5-step shuffle reduction. K2 and the CUDA-core bodies of K1 and K3 do all
// arithmetic in f32 on the CUDA cores; the main bodies of K1 and K3 take their
// products on the tensor cores, as split TF32 operands that keep f32 accuracy
// (common.cuh, mma_tile).
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
// write -1. At another fold width (the JAX package's "f{fold}" names: 32, 64
// or 128 m; the launchers' `fold`) both bodies keep the same 128-column state:
// at 32 and 64 it folds further at the group's end, at 128 m the segments run
// in fold-block order and each block's rounds also run over the row's list of
// the blocks before it (common.cuh). The products do not change, so neither
// does the bound.
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
// aligned): one block per group, each thread R x 4 dot products and (m1, m2)
// pairs in registers, D streamed in depth chunks (chunk_dots below), so it
// serves every D at every qt.
//
// bf16 codes (the JAX package's precision="bf16"; the scaled queries rounded
// to bf16 as it rounds them, normsT in f32): the same two bodies on bf16
// operands, the launcher's entry qk_grouped_scan_bf16. The tensor-core body
// takes one mma.sync.m16n8k16 bf16 product a depth-16 step where the f32 one
// takes three TF32 products a depth-8 step: six times fewer tensor-core
// operations and half the slab bytes, through the same ring (a TMA box is
// 128 bytes of a row either way: 64 bf16 columns). Its bound is 2 qt C D
// flops over 989 TFLOP/s or the bytes at 2 an element. It serves D % 8 == 0
// (the copies' 16-byte rows) where the tile fits; the CUDA-core body reads
// bf16 (converted to f32 as it loads, exact) and serves every other D.
// ---------------------------------------------------------------------------

// The CUDA-core bodies of K1 and K3 take D in depth chunks of up to
// kDepthChunk columns: a [rows][dcp] query chunk and a [128][dcp + 1] segment
// chunk in shared memory, whatever D is.
constexpr int kDepthChunk = 128;

inline __host__ __device__ int depth_chunk(int D) {
  return padded_dim(D < kDepthChunk ? D : kDepthChunk);
}

// Shared memory of a CUDA-core body with a query tile of `rows` rows, in bytes.
inline size_t chunk_dots_smem(int rows, int D) {
  const int dcp = depth_chunk(D);
  return (size_t)(rows * dcp + kFold * (dcp + 1)) * sizeof(float);
}

// Columns [d0, d0 + dcp) of rows [0, rows) of a [*, D] f32 or bf16 matrix
// into shared memory as f32 at row stride `stride`, zero-filling columns >= D
// and rows >= nrows.
template <typename T>
__device__ __forceinline__ void load_depth_chunk(float* dst, const T* src, int rows, int nrows,
                                                 int D, int d0, int dcp, int stride) {
  for (int i = threadIdx.x; i < rows * dcp; i += kThreads) {
    const int r = i / dcp;
    const int d = d0 + i - r * dcp;
    dst[r * stride + d - d0] = (d < D && r < nrows) ? to_f32(src[(size_t)r * D + d]) : 0.0f;
  }
}

// acc = the products of the [8 R, D] query tile (nq real rows at q) with the
// 128 rows at `rows` (all inside the matrix: N and C are multiples of 128),
// over D in chunks of dcp = depth_chunk(D) columns, in tile_dots' order
// whatever the chunking. Where one chunk covers
// D the caller has loaded the tile into qs once (load_depth_chunk at d0 = 0)
// and it stays there; a deeper D brings each chunk of the tile with the
// segment's.
template <int R, typename T>
__device__ __forceinline__ void chunk_dots(float (&acc)[R][4], float* qs, float* seg,
                                           const T* q, int nq, const T* rows, int D, int dcp) {
  for (int d0 = 0; d0 < D; d0 += dcp) {
    __syncthreads();  // the previous chunk is consumed (and the query tile written)
    if (D > dcp) load_depth_chunk(qs, q, kWarps * R, nq, D, d0, dcp, dcp);
    load_depth_chunk(seg, rows, kFold, kFold, D, d0, dcp, dcp + 1);
    __syncthreads();
    tile_dots<R>(acc, qs, seg, dcp, d0 == 0);
  }
}

// kBlocks: fold = 128 m with m > 1 (fold blocks, common.cuh); the other
// instantiation serves folds 32, 64 and 128 with F = 128's code.
template <int R, typename T, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const int* __restrict__ gp, const int* __restrict__ gsize,
                    const T* __restrict__ qg, const T* __restrict__ codes,
                    const float* __restrict__ normsT, float* __restrict__ out,
                    int D, int C, int kk, float slot_mult, float levels, int fold) {
  constexpr int qt = kWarps * R;
  extern __shared__ __align__(16) float smem[];
  const int dcp = depth_chunk(D);
  float* qs = smem;                         // [qt][dcp]
  float* seg = smem + qt * dcp;             // [128][dcp + 1]
  float* lists = seg + kFold * (dcp + 1);   // [qt][kk] where fold > 128
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int size = min(gsize[g], C);
  float* og = out + (size_t)g * qt * kk;
  if (size <= 0) {
    for (int i = threadIdx.x; i < qt * kk; i += kThreads) og[i] = -1.0f;
    return;
  }
  const int p = gp[g];
  const T* qsrc = qg + (size_t)g * qt * D;
  if (D <= dcp) load_depth_chunk(qs, qsrc, qt, qt, D, 0, dcp, dcp);
  const T* slab = codes + (size_t)p * C * D;
  const float* nrm = normsT + (size_t)p * C;

  const int nseg = (size + kFold - 1) / kFold;
  const int fb = kBlocks ? fold_blocks(fold) : 1;
  for (int b = 0; b < fb && b < nseg; ++b) {  // the fold blocks (common.cuh)
    float m1[R][4], m2[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) m1[r][j] = m2[r][j] = -1.0f;
    for (int s = b; s < nseg; s += fb) {
      float acc[R][4];
      chunk_dots<R>(acc, qs, seg, qsrc, qt, slab + (size_t)s * kFold * D, D, dcp);
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
    fold_narrow<R>(m1, m2, fold);
    if (kBlocks && b > 0) {  // the rounds also run over the list of the blocks before
      load_lists<R>(lists, og, kk);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + kWarps * r;
        int h = 0;
        for (int i = 0; i < kk; ++i) {
          const float v = select_round_list(m1[r], m2[r], lists + row * kk, h, kk);
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
}

// Built with -DQK_PRODUCT_ONLY (a timing aid, never the package's build) the
// body keeps its loads and products and drops the keys, the fold and the
// rounds: a running maximum stands in for them, and what it writes is no result.
//
// kBf16: bf16 codes and query tiles, the tiles read as 32-bit words (two bf16
// values a word) and multiplied by mma_tile_bf16; qg then points at the bf16
// tiles and D counts bf16 columns. Everything else is the f32 body's: a box
// is 128 bytes of a row, and a box holds four depth steps in both.
//
// kBlocks: fold = 128 m with m > 1 (fold blocks, common.cuh); the other
// instantiation serves folds 32, 64 and 128 with F = 128's code.
template <int QT, bool kBf16, bool kBlocks>
__global__ void __launch_bounds__(kThreads, 1)
grouped_scan_mma_kernel(const __grid_constant__ CUtensorMap cmap, const int* __restrict__ gp,
                        const int* __restrict__ gsize, const void* __restrict__ qg_raw,
                        const float* __restrict__ normsT, float* __restrict__ out, int Gn,
                        int D, int NB, int NBS, int C, int kk, float slot_mult, float levels,
                        int fold) {
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
  const int fb = kBlocks ? fold_blocks(fold) : 1;          // fold blocks (common.cuh)
  float* lists = tile + QT * kTileStride;                  // [QT][kk] where fb > 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(lists + (fb > 1 ? QT * kk : 0));  // a stage's
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int row0 = (warp / NW) * (16 * MT), col0 = (warp % NW) * (8 * NT);
  const int W = kBf16 ? D >> 1 : D;                        // 32-bit words of a row
  const int ksteps = kBf16 ? (D + 15) >> 4 : (D + 7) >> 3;  // depth steps, four a box
  const int box_cols = kBf16 ? 2 * kBox : kBox;            // elements of a box row
  const float* qg = static_cast<const float*>(qg_raw);     // the tiles' words
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
  // consumer, across segments (in fold-block order) and groups.
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
                         min(NBS, NB - pd * NBS), bars + stage, box_cols);
      if (++pd < ND) return;
      pd = 0;
      ps = next_fold_segment(ps, pnseg, fb);
      if (ps < 0) {
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
      query_tile_load(qs, qg + (size_t)cg * QT * W, QT, QR, W, NB);
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
    if constexpr (kBf16)
      mma_tile_bf16<MT, NT>(acc, qs + cd * NBS * QR * kBox, ring + stage * NBS * kSegBox, row0,
                            col0, QR, min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
    else
      mma_tile<MT, NT>(acc, qs + cd * NBS * QR * kBox, ring + stage * NBS * kSegBox, row0, col0,
                       QR, min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
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
    const int next = next_fold_segment(cs, nseg, fb);
    if (next >= 0 && next == cs + fb) {  // the fold block goes on
      cs = next;
      continue;
    }

    // A fold block's end (the group's, where m == 1): (m1, m2) into the
    // rounds' layout, then kk rounds, after the first block over the list of
    // the blocks before it too.
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
    fold_narrow<R>(r1, r2, fold);
    if (kBlocks && cs % fb != 0) {  // a block after the first: over the list too
      load_lists<R>(lists, og, kk);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + kWarps * r;
        int h = 0;
        for (int i = 0; i < kk; ++i) {
          const float b = select_round_list(r1[r], r2[r], lists + row * kk, h, kk);
          if (lane == 0) og[row * kk + i] = b;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = warp + kWarps * r;
        for (int i = 0; i < kk; ++i) {
          const float b = select_round(r1[r], r2[r]);
          if (lane == 0) og[row * kk + i] = b;
        }
      }
    }
#endif
    if (kBlocks && next >= 0) {  // the next fold block of the group
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e) m1[ti][e] = m2[ti][e] = -1.0f;
      cs = next;
      continue;
    }
    cg = next_live(cg + step);
    cs = 0;
  }
}

// Shared memory of the tensor-core body with ring stages of NBS boxes, rows
// of W 32-bit words (D f32 or 2 W bf16 values) and fold lists of lk values a
// row, in bytes: room to reach a 1024-byte boundary, ring, query tile, value
// tile, lists, the two stage barriers.
inline size_t grouped_scan_mma_smem(int qt, int W, int NBS, int lk) {
  return 1024 + 16 +
         (size_t)(2 * NBS * kSegBox + tile_boxes(W) * (qt < 16 ? 16 : qt) * kBox +
                  qt * kTileStride + qt * lk) *
             sizeof(float);
}

// Boxes of a ring stage of the tensor-core body: all of D's, or the most of
// 4, 2 and 1 that fits beside the whole-D query tile and the fold lists. 0:
// the body does not serve the shape (rows not 16-byte aligned, or no stage
// fits).
inline int grouped_scan_stage_boxes(int qt, int D, bool bf16, int lk) {
  const int W = row_words(D, bf16);
  if (W == 0) return 0;
  return ring_stage_boxes(W, [&](int NBS) { return grouped_scan_mma_smem(qt, W, NBS, lk); });
}

inline bool grouped_scan_uses_mma(int qt, int D, bool bf16, int fold, int kk) {
  return grouped_scan_stage_boxes(qt, D, bf16, fold_list_len(fold, kk)) > 0;
}

// ---------------------------------------------------------------------------
// K2: pool merge.
//
// Replaces quake_tpu/ops/pallas_grouped.py::_merge_positions_kernel (wrapper
// _merge_positions_pallas, called from _pool_tail), with the key step of
// _pool_tail before it. mp [B, pool] is the placed pool as the placement
// leaves it: packed key * slot_mult + slot values, -1 = none. Per column c:
// key = floor(m / slot_mult) (slot_mult a power of two: a multiplication by
// its inverse is exact), packed = key * lane_mult + c with lane_mult the pool
// padded to a 128 multiple, and the columns from pool to that width read as
// -1; fold-128 top-2, kfin rounds; out [B, kfin] = winning column (pool
// position), -1 for none.
//
// Bound on the H100: bytes (B pool 4 read, B kfin 4 written; a few
// operations per element) -- at the main path's shapes a few microseconds,
// near the time of an empty launch.
//
// What held the first design back: one warp a row, so each of the kfin rounds
// was a dependent 5-step shuffle chain with nothing beside it, over scalar
// loads of a pool padded and copied before the launch. Design: a row per 8
// lanes (4 rows a warp), lane l owning the 16 fold columns l v + 8 v t + e
// (v = the load width in floats, t < 16 / v, e < v), so that the loads of a
// row are contiguous: 8-byte loads where the pool is even and its rows 8-byte
// aligned (the main path's 90 columns), else 4-byte ones. A round is a local
// maximum over 16 registers and a 3-step shuffle chain, and the four rows of
// a warp run their chains side by side. With pool <= 128 a column holds at
// most one value, and the second of the top-2 is left out. No shared memory.
// 8-byte loads take 1-2% off the 4-byte ones; 16-byte loads, where pool % 4
// == 0, took about 1% more off and are not kept (scripts/body_times.py,
// PERF.md).
// ---------------------------------------------------------------------------
constexpr int kMergeLanes = 8;                   // lanes a row
constexpr int kMergeCols = kFold / kMergeLanes;  // fold columns a lane

template <int VEC, bool TOP2>
__global__ void __launch_bounds__(kThreads)
merge_positions_kernel(const float* __restrict__ mp, int* __restrict__ out, int B, int pool,
                       int kfin, int lane_mult, float inv_slot) {
  const int sub = threadIdx.x & (kMergeLanes - 1);
  const int b = (blockIdx.x * kThreads + threadIdx.x) / kMergeLanes;
  const bool live = b < B;  // the warp stays whole for the shuffles
  const float* row = mp + (size_t)(live ? b : 0) * pool;
  const float lm = (float)lane_mult;
  auto col = [&](int j) { return sub * VEC + (j / VEC) * (kMergeLanes * VEC) + j % VEC; };
  float m1[kMergeCols], m2[kMergeCols];
#pragma unroll
  for (int j = 0; j < kMergeCols; ++j) m1[j] = m2[j] = -1.0f;
  for (int s = 0; s < (TOP2 ? pool : 1); s += kFold) {
    float v[kMergeCols];  // pool % VEC == 0: a load's columns lie wholly below pool or not
#pragma unroll
    for (int j = 0; j < kMergeCols; j += VEC) {
      const float* at = row + s + col(j);
      if (!live || s + col(j) >= pool) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j + e] = -1.0f;
      } else if constexpr (VEC == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(at));
        v[j] = t.x, v[j + 1] = t.y;
      } else {
        v[j] = __ldg(at);
      }
    }
#pragma unroll
    for (int j = 0; j < kMergeCols; ++j) {
      const float p = v[j] >= 0.0f ? floorf(v[j] * inv_slot) * lm + (float)(s + col(j)) : -1.0f;
      if constexpr (TOP2) fold2(m1[j], m2[j], p);
      else m1[j] = p;
    }
  }
  for (int i = 0; i < kfin; ++i) {
    float t[kMergeCols / 2];  // the lane's maximum as a tree, 4 steps deep
#pragma unroll
    for (int j = 0; j < kMergeCols / 2; ++j) t[j] = fmaxf(m1[j], m1[j + kMergeCols / 2]);
#pragma unroll
    for (int w = kMergeCols / 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float best = t[0];
#pragma unroll
    for (int o = kMergeLanes / 2; o > 0; o >>= 1)
      best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
#pragma unroll
    for (int j = 0; j < kMergeCols; ++j) {
      const bool hit = m1[j] == best;
      m1[j] = hit ? (TOP2 ? m2[j] : -1.0f) : m1[j];
      if constexpr (TOP2) m2[j] = hit ? -1.0f : m2[j];
    }
    if (live && sub == (i & (kMergeLanes - 1)))
      out[(size_t)b * kfin + i] = best >= 0.0f ? (int)best % lane_mult : -1;
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
// 128 top-2; k rounds; out [B, k] = winning slot, -1 for none. This is kernel
// K5's function over one "partition" that holds the whole buffer, with a bias
// in place of -|x|^2 and validity read from the bias.
//
// Bound on the H100: tensor-core operations, 3 x 2 B N_valid D flops / 495
// TFLOP/s (the split product below takes three TF32 products per f32 one); at
// the main path's shape (B = 16384, N = 256 of which 160 valid, D = 128) that
// is 0.004 ms against 0.0025 ms of bytes (each query read once).
//
// What held the first design back: two passes of f32 products on the CUDA
// cores out of shared memory (pass 1 only for the row's min and max), short
// blocks of 32 queries that reloaded the buffer twice with synchronous loads
// and waited at a barrier on every segment, 82 KB of shared memory a block,
// and a whole-D query tile beside a [128][D + 1] segment, which ruled out
// D > 362.
//
// flat_topk_mma_kernel, the main body (D % 4 == 0): persistent, one block per
// SM, block b takes the 64-query tiles b, b + grid, .... A ring stage holds
// NBS boxes (32 columns each) of a 128-row segment of the buffer and the same
// boxes of the query tile, both brought by the Tensor Memory Accelerator from
// tensor maps over the buffer [N, D] and the queries [B, D] (rows past B read
// as zero); the next stage's copies start before the current one is
// multiplied, and D streams through the ring in depth chunks of NBS boxes, so
// no D is too wide. The product is mma_tile (common.cuh: 3xTF32 with the sums
// rounded on the CUDA cores, as in K1 and K4). Where the tile's scores fit
// beside the ring ([64][N + 8] floats: N up to 640), they stay in shared
// memory: each segment is multiplied once, the row's min and max are taken
// as the scores are produced, and the quantize, fold and rounds read them
// from there. A larger buffer is multiplied twice, min and max in the first
// pass and the selection in the second, by the same code in the same order,
// so the scores are bit-identical. The fold and the k rounds run in the
// rounds' layout (a warp owns whole rows) over a warp's 8 rows side by side.
//
// flat_topk_kernel, the CUDA-core body (D % 4 != 0: a row is not 16-byte
// aligned for the copies): one block per 32 queries, f32 products from shared
// memory in depth chunks (chunk_dots, as K1's CUDA-core body: the query tile
// loaded once where D <= 128), two passes as above.
//
// Both bodies run a warp's k rounds over its rows side by side, each row's
// maximum in one warp reduction instruction (select_rounds).
//
// A bf16 parent (the JAX package's parent_params precision="bf16"; the
// queries rounded to bf16, as pallas_flat.py::flat_topk_pallas rounds them,
// the bias in f32): the same two bodies on bf16 operands. The tensor-core
// body (kBf16) brings the buffer's and the queries' boxes by tensor maps of 2
// bytes an element (a box: 64 bf16 columns, 128 bytes of a row as in f32) and
// multiplies by mma_tile_bf16, one m16n8k16 bf16 product a depth-16 step; its
// bound is 2 B N D flops over 989 TFLOP/s, or the bytes at 2 an element. It
// serves D % 8 == 0 (the copies' 16-byte rows). The CUDA-core body converts
// bf16 to f32 as it loads (exact) and serves every other D. The tensor-core
// body stages the rounds' winners in the score tile and writes them out
// together: a store to device memory from within each round held the rounds
// up.
// ---------------------------------------------------------------------------
constexpr int kFlatRows = 4;  // rows per warp of the CUDA-core body
constexpr int kFlatQB = kWarps * kFlatRows;
constexpr int kFlatQT = 64;   // query tile of the tensor-core body

template <bool L2>
__device__ __forceinline__ float flat_score(float dot, float bias) {
  return L2 ? 2.0f * dot + bias : dot + bias;
}

template <bool L2, typename T>
__global__ void __launch_bounds__(kThreads)
flat_topk_kernel(const T* __restrict__ q, const T* __restrict__ codes,
                 const float* __restrict__ bias, int* __restrict__ out, int B, int N,
                 int D, int k, int slot_mult, float levels) {
  constexpr int R = kFlatRows;
  extern __shared__ __align__(16) float smem[];
  const int dcp = depth_chunk(D);
  float* qs = smem;                   // [32][dcp]
  float* seg = smem + kFlatQB * dcp;  // [128][dcp + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kFlatQB;
  const int nseg = N / kFold;
  const T* qb = q + (size_t)b0 * D;
  if (D <= dcp) load_depth_chunk(qs, qb, kFlatQB, B - b0, D, 0, dcp, dcp);
  // acc = the products of segment s.
  auto segment_dots = [&](float (&acc)[R][4], int s) {
    chunk_dots<R>(acc, qs, seg, qb, B - b0, codes + (size_t)s * kFold * D, D, dcp);
  };

  float mn[R], mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = INFINITY;
    mx[r] = -INFINITY;
  }
  for (int s = 0; s < nseg; ++s) {  // pass 1: row min / max over valid lanes
    float acc[R][4];
    segment_dots(acc, s);
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
    float acc[R][4];
    segment_dots(acc, s);
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
  select_rounds<R>(m1, m2, k, [&](int r, int i, float best) {
    const int b = b0 + warp + kWarps * r;
    if (lane == r && b < B) out[(size_t)b * k + i] = best >= 0.0f ? (int)best & (slot_mult - 1) : -1;
  });
}

// Shared memory of K3's tensor-core body in bytes, with ring stages of NBS
// boxes: room to reach a 1024-byte boundary, the ring (a stage: NBS boxes of
// the segment and of the query tile), the score tile ([64][N + 8] with the
// scores kept, else one segment's [64][136]), (rowmin, scale) per row, the
// cross-warp min / max exchange, the two stage barriers.
inline size_t flat_topk_mma_smem(int N, int NBS, bool resident) {
  const int sw = resident ? N + 8 : kTileStride;
  return 1024 + 16 +
         (size_t)(2 * NBS * (kSegBox + kFlatQT * kBox) + kFlatQT * sw + 2 * kFlatQT +
                  2 * kFlatQT * (kWarps / 2)) *
             sizeof(float);
}

// The tensor-core body's configuration at rows of W 32-bit words (D f32 or
// 2 W bf16 values): NBS boxes a ring stage (the row's boxes, or the most of
// 4, 2 and 1 that fits) and whether the scores stay in shared memory;
// preferred: scores kept, then the larger stage.
struct FlatMmaShape {
  int NBS;
  bool resident;
};
inline FlatMmaShape flat_topk_mma_shape(int N, int W) {
  for (int keep = 1; keep >= 0; --keep)
    for (int nbs = 4; nbs >= 1; nbs >>= 1) {
      const int NBS = nbs < tile_boxes(W) ? nbs : tile_boxes(W);
      if (flat_topk_mma_smem(N, NBS, keep != 0) <= kSmemLimit) return {NBS, keep != 0};
    }
  return {0, false};
}

// Which body serves a shape (qk_flat_topk_body names them): 2 the tensor
// cores with the scores kept, 1 the tensor cores in two passes, 0 the CUDA
// cores (rows not 16-byte aligned: D % 4 != 0 in f32, D % 8 != 0 in bf16).
inline int flat_topk_body(int N, int D, bool bf16) {
  const int W = row_words(D, bf16);
  if (W == 0) return 0;
  const FlatMmaShape sh = flat_topk_mma_shape(N, W);
  return sh.NBS == 0 ? 0 : (sh.resident ? 2 : 1);
}

template <bool L2, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
flat_topk_mma_kernel(const __grid_constant__ CUtensorMap cmap,
                     const __grid_constant__ CUtensorMap qmap, const float* __restrict__ bias,
                     int* __restrict__ out, int B, int N, int D, int NB, int NBS, int resident,
                     int k, int slot_mult, float levels) {
  constexpr int QT = kFlatQT;
  constexpr int MT = 2, MW = 2;        // m16-tiles per warp, warps along the query rows
  constexpr int NW = kWarps / MW;      // warps along the segment
  constexpr int NT = 16 / NW;          // n8-tiles per warp
  constexpr int T = MT * NT;           // accumulator tiles per warp
  constexpr int R = QT / kWarps;       // rows per warp in the selection
  extern __shared__ __align__(16) float smem[];
  const int stage_floats = NBS * (kSegBox + QT * kBox);
  const int sw = resident ? N + 8 : kTileStride;
  float* ring = smem_aligned(smem);      // 2 stages: NBS segment boxes, then NBS query boxes
  float* sc = ring + 2 * stage_floats;   // scores [QT][sw]
  float* rowp = sc + QT * sw;            // [QT][2] = (rowmin, levels / rng)
  float* red = rowp + 2 * QT;            // [QT][NW][2] = (min, max) per warp
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 2 * QT * NW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int wn = warp % NW;
  const int row0 = (warp / NW) * (16 * MT), col0 = wn * (8 * NT);
  const int ksteps = depth_steps(D, kBf16);
  const int box_cols = kBf16 ? 2 * kBox : kBox;  // elements of a box row
  const int ND = (NB + NBS - 1) / NBS;  // depth chunks a segment
  const int nseg = N / kFold;
  const int visits = resident ? nseg : 2 * nseg;  // segment visits a tile
  const int ntiles = (B + QT - 1) / QT;
  const float sm = (float)slot_mult;

  // The producer walks one stage (a depth chunk of a segment visit) ahead of
  // the consumer, across visits and tiles.
  mbar_init(bars);
  int pt = blockIdx.x, pv = 0, pd = 0;
  auto prefetch = [&](int stage) {
    if (pt >= ntiles) return;
    if (threadIdx.x == 0) {
      float* st = ring + stage * stage_floats;
      const int boxes = min(NBS, NB - pd * NBS);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bars + stage)),
                   "r"((uint32_t)(boxes * (kSegBox + QT * kBox) * sizeof(float)))
                   : "memory");
      fence_async_proxy();
      for (int b = 0; b < boxes; ++b) {
        const int c = (pd * NBS + b) * box_cols;
        box_load_async(st + b * kSegBox, &cmap, c, (pv % nseg) * kFold, bars + stage);
        box_load_async(st + NBS * kSegBox + b * QT * kBox, &qmap, c, pt * QT, bars + stage);
      }
    }
    if (++pd < ND) return;
    pd = 0;
    if (++pv < visits) return;
    pv = 0;
    pt += gridDim.x;
  };
  int ct = blockIdx.x, cv = 0, cd = 0, stage = 0;
  uint32_t parity = 0;  // bit s: the parity of stage s's next completed phase
  prefetch(0);

  float mn[2 * MT], mx[2 * MT];  // rows row0 + 16 i + g4 + 8 h at [2 i + h]
  float acc[T][4];               // tile (i, j) at i NT + j
  float f1[R][4], f2[R][4];      // fold state of rows warp + 8 r, columns lane + 32 j

  // Folds segment s of each of this warp's rows, read from src (the
  // segment's first column of row 0 of a tile of stride sw).
  auto fold_segment = [&](const float* src, int s) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp + kWarps * r;
      const float rmin = rowp[2 * row], scale = rowp[2 * row + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = src[row * sw + lane + 32 * j];
        const float key = floorf((v - rmin) * scale);
        fold2(f1[r][j], f2[r][j], v > -INFINITY ? key * sm + (float)(s * kFold + lane + 32 * j)
                                                : -1.0f);
      }
    }
  };

  while (ct < ntiles) {
    float* st = ring + stage * stage_floats;
    prefetch(stage ^ 1);
    if (cv == 0 && cd == 0) {
#pragma unroll
      for (int m = 0; m < 2 * MT; ++m) {
        mn[m] = INFINITY;
        mx[m] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) f1[r][j] = f2[r][j] = -1.0f;
    }
    const int s = cv % nseg;
    // This thread's biases, asked for before the product so that they arrive
    // under it (N % 128 == 0 and even columns: 8-byte aligned).
    const int lnb = s * kFold + col0 + 2 * t4;
    float2 bv[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) bv[j] = __ldg(reinterpret_cast<const float2*>(bias + lnb + 8 * j));
    mbar_wait(bars + stage, (parity >> stage) & 1u);  // the stage has landed
    parity ^= 1u << stage;
    mma_tile_any<kBf16, MT, NT>(acc, st + NBS * kSegBox, st, row0, col0, QT,
                                min(4 * NBS, ksteps - 4 * NBS * cd), cd == 0);
    __syncthreads();  // the stage is consumed: its buffer may be refilled
    stage ^= 1;
    if (++cd < ND) continue;  // the segment's next depth chunk adds to acc
    cd = 0;
#pragma unroll
    for (int ti = 0; ti < T; ++ti)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 b = bv[ti % NT];
        acc[ti][e] = flat_score<L2>(acc[ti][e], (e & 1) ? b.y : b.x);
      }
    // The scores into the tile: all segments (kept) in pass 1, one at a time
    // in pass 2 (two passes).
    if (resident ? cv < nseg : cv >= nseg) {
      float* dst = sc + (resident ? s * kFold : 0) + col0 + 2 * t4;
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 16 * (ti / NT) + g4 + 8 * h;
          *reinterpret_cast<float2*>(dst + row * sw + 8 * (ti % NT)) =
              make_float2(acc[ti][2 * h], acc[ti][2 * h + 1]);
        }
    }
    if (cv < nseg) {  // pass 1: each row's min and max over its valid lanes
#pragma unroll
      for (int ti = 0; ti < T; ++ti)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (acc[ti][e] > -INFINITY) {
            const int m = 2 * (ti / NT) + (e >> 1);
            mn[m] = fminf(mn[m], acc[ti][e]);
            mx[m] = fmaxf(mx[m], acc[ti][e]);
          }
      if (cv == nseg - 1) {  // the ranges are complete
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
        __syncthreads();
        if (threadIdx.x < QT) {
          const int row = threadIdx.x;
          float rmin = INFINITY, rmax = -INFINITY;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            rmin = fminf(rmin, red[(row * NW + w) * 2]);
            rmax = fmaxf(rmax, red[(row * NW + w) * 2 + 1]);
          }
          rowp[2 * row] = rmin;
          rowp[2 * row + 1] = levels / fmaxf(rmax - rmin, 1e-20f);
        }
        __syncthreads();  // rowp, and the kept scores, are in place
        if (resident)
          for (int s2 = 0; s2 < nseg; ++s2) fold_segment(sc + s2 * kFold, s2);
      }
    } else {  // pass 2: fold the segment's scores
      __syncthreads();
      fold_segment(sc, s);
    }
    if (++cv < visits) continue;

    // The tile's end: k rounds over the warp's rows, side by side, their
    // winners staged in the warp's own rows of the score tile (no longer read)
    // and written out together, at most sw rounds at a time: a store of each
    // round's winner from within the rounds held them up.
    for (int i0 = 0; i0 < k; i0 += sw) {
      const int n = min(sw, k - i0);
      select_rounds<R>(f1, f2, n, [&](int r, int i, float best) {
        if (lane == r) sc[(warp + kWarps * r) * sw + i] = best;
      });
      __syncwarp();
      for (int e = lane; e < R * n; e += 32) {
        const int r = e / n, i = e - r * n;
        const int b = ct * QT + warp + kWarps * r;
        const float best = sc[(warp + kWarps * r) * sw + i];
        if (b < B) out[(size_t)b * k + i0 + i] = best >= 0.0f ? (int)best & (slot_mult - 1) : -1;
      }
      __syncwarp();
    }
    ct += gridDim.x;
    cv = 0;
  }
}

template <bool kBf16>
int launch_grouped_scan_mma(const void* gp, const void* gsize, const void* qg, const void* codes,
                            const void* normsT, void* out, int Gn, int qt, int D, int P, int C,
                            int kk, float slot_mult, float levels, int fold, cudaStream_t st) {
  const int W = row_words(D, kBf16);
  const int lk = fold_list_len(fold, kk);
  const int NBS = grouped_scan_stage_boxes(qt, D, kBf16, lk);
  const size_t smem = grouped_scan_mma_smem(qt, W, NBS, lk);
  const int grid = Gn < sm_count() ? Gn : sm_count();
  CUtensorMap cmap;
  const int me = slab_tensor_map(&cmap, codes, (unsigned long long)P * C, D, kFold,
                                 kBf16 ? 2 : 4);
  if (me != 0) return me;
#define QK_GROUPED_MMA_LAUNCH(QT, B)                                                      \
  {                                                                                       \
    cudaError_t e = allow_smem(grouped_scan_mma_kernel<QT, kBf16, B>, smem);              \
    if (e != cudaSuccess) return (int)e;                                                  \
    grouped_scan_mma_kernel<QT, kBf16, B><<<grid, kThreads, smem, st>>>(                  \
        cmap, (const int*)gp, (const int*)gsize, qg, (const float*)normsT, (float*)out, Gn, \
        D, tile_boxes(W), NBS, C, kk, slot_mult, levels, fold);                           \
  }
#define QK_GROUPED_MMA(QT)                                                                \
  case QT:                                                                                \
    if (lk > 0) QK_GROUPED_MMA_LAUNCH(QT, true) else QK_GROUPED_MMA_LAUNCH(QT, false)     \
    break;
  switch (qt) {
    QK_GROUPED_MMA(8)
    QK_GROUPED_MMA(16)
    QK_GROUPED_MMA(32)
    QK_GROUPED_MMA(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_GROUPED_MMA
#undef QK_GROUPED_MMA_LAUNCH
  return (int)cudaGetLastError();
}

// K1 on f32 codes (T = float) and on bf16 codes (T = __nv_bfloat16): qg and
// codes in T, normsT and out in f32.
template <typename T>
int grouped_scan(const void* gp, const void* gsize, const void* qg, const void* codes,
                 const void* normsT, void* out, int Gn, int qt, int D, int P, int C, int kk,
                 float slot_mult, float levels, int fold, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (Gn <= 0) return (int)cudaGetLastError();
  if (grouped_scan_uses_mma(qt, D, kBf16, fold, kk))
    return launch_grouped_scan_mma<kBf16>(gp, gsize, qg, codes, normsT, out, Gn, qt, D, P, C,
                                          kk, slot_mult, levels, fold, st);
  const int lk = fold_list_len(fold, kk);
  const size_t smem = chunk_dots_smem(qt, D) + (size_t)qt * lk * sizeof(float);
#define QK_GROUPED_LAUNCH(R, B)                                                         \
  {                                                                                     \
    cudaError_t e = allow_smem(grouped_scan_kernel<R, T, B>, smem);                     \
    if (e != cudaSuccess) return (int)e;                                                \
    grouped_scan_kernel<R, T, B><<<Gn, kThreads, smem, st>>>(                           \
        (const int*)gp, (const int*)gsize, (const T*)qg, (const T*)codes,               \
        (const float*)normsT, (float*)out, D, C, kk, slot_mult, levels, fold);          \
  }
#define QK_GROUPED(R)                                                                   \
  case 8 * R:                                                                           \
    if (lk > 0) QK_GROUPED_LAUNCH(R, true) else QK_GROUPED_LAUNCH(R, false)             \
    break;
  switch (qt) {
    QK_GROUPED(1)
    QK_GROUPED(2)
    QK_GROUPED(4)
    QK_GROUPED(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QK_GROUPED
#undef QK_GROUPED_LAUNCH
  return (int)cudaGetLastError();
}

// K3 on operands of type T (f32 or bf16): q and codes in T, bias f32.
template <typename T>
int flat_topk(const void* q, const void* codes, const void* bias, void* out, int B, int N, int D,
              int k, int is_l2, int slot_mult, float levels, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (flat_topk_body(N, D, kBf16) > 0) {
    const int W = row_words(D, kBf16);
    const FlatMmaShape sh = flat_topk_mma_shape(N, W);
    const size_t smem = flat_topk_mma_smem(N, sh.NBS, sh.resident);
    const int ntiles = (B + kFlatQT - 1) / kFlatQT;
    const int grid = ntiles < sm_count() ? ntiles : sm_count();
    const int eb = kBf16 ? 2 : 4;
    CUtensorMap cmap, qmap;
    int me = slab_tensor_map(&cmap, codes, (unsigned long long)N, D, kFold, eb);
    if (me == 0) me = slab_tensor_map(&qmap, q, (unsigned long long)B, D, kFlatQT, eb);
    if (me != 0) return me;
#define QK_FLAT_MMA(L2)                                                                      \
  {                                                                                          \
    cudaError_t e = allow_smem(flat_topk_mma_kernel<L2, kBf16>, smem);                       \
    if (e != cudaSuccess) return (int)e;                                                     \
    flat_topk_mma_kernel<L2, kBf16><<<grid, kThreads, smem, st>>>(                           \
        cmap, qmap, (const float*)bias, (int*)out, B, N, D, tile_boxes(W), sh.NBS,           \
        sh.resident ? 1 : 0, k, slot_mult, levels);                                          \
  }
    if (is_l2) QK_FLAT_MMA(true) else QK_FLAT_MMA(false)
#undef QK_FLAT_MMA
    return (int)cudaGetLastError();
  }
  const size_t smem = chunk_dots_smem(kFlatQB, D);
  const int grid = (B + kFlatQB - 1) / kFlatQB;
#define QK_FLAT(L2)                                                                          \
  {                                                                                          \
    cudaError_t e = allow_smem(flat_topk_kernel<L2, T>, smem);                               \
    if (e != cudaSuccess) return (int)e;                                                     \
    flat_topk_kernel<L2, T><<<grid, kThreads, smem, st>>>(                                   \
        (const T*)q, (const T*)codes, (const float*)bias, (int*)out, B, N, D, k, slot_mult,  \
        levels);                                                                             \
  }
  if (is_l2) QK_FLAT(true) else QK_FLAT(false)
#undef QK_FLAT
  return (int)cudaGetLastError();
}

#ifdef QK_PRODUCT_ONLY
// A timing aid of the same build: a kernel that does nothing, launched on a
// grid of `grid` blocks of kThreads, the floor under any launch of that shape.
__global__ void empty_kernel() {}
#endif

}  // namespace

extern "C" {

#ifdef QK_PRODUCT_ONLY
int qk_empty(int grid, void* stream) {
  empty_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif

const char* qk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// 1 when the launcher runs the tensor-core body at this shape, fold width
// and kk (the fold lists of F = 128 m, m > 1, take shared memory), 0 for the
// CUDA-core body: f32 codes, and bf16 codes.
int qk_grouped_scan_uses_mma(int qt, int D, int fold, int kk) {
  return grouped_scan_uses_mma(qt, D, false, fold, kk) ? 1 : 0;
}
int qk_grouped_scan_bf16_uses_mma(int qt, int D, int fold, int kk) {
  return grouped_scan_uses_mma(qt, D, true, fold, kk) ? 1 : 0;
}

// fold: 32, 64 or 128 m, dividing C (the Python wrapper checks).
int qk_grouped_scan(const void* gp, const void* gsize, const void* qg, const void* codes,
                    const void* normsT, void* out, int Gn, int qt, int D, int P, int C, int kk,
                    float slot_mult, float levels, int fold, void* stream) {
  return grouped_scan<float>(gp, gsize, qg, codes, normsT, out, Gn, qt, D, P, C, kk, slot_mult,
                             levels, fold, stream);
}

// K1 on bf16 codes: qg and codes bf16, the rest as qk_grouped_scan's.
int qk_grouped_scan_bf16(const void* gp, const void* gsize, const void* qg, const void* codes,
                         const void* normsT, void* out, int Gn, int qt, int D, int P, int C,
                         int kk, float slot_mult, float levels, int fold, void* stream) {
  return grouped_scan<__nv_bfloat16>(gp, gsize, qg, codes, normsT, out, Gn, qt, D, P, C, kk,
                                     slot_mult, levels, fold, stream);
}

int qk_merge_positions(const void* mp, void* out, int B, int pool, int kfin, int lane_mult,
                       float inv_slot, void* stream) {
  if (B <= 0 || kfin <= 0) return (int)cudaGetLastError();
  const int rows = kThreads / kMergeLanes;
  const int grid = (B + rows - 1) / rows;
  cudaStream_t st = (cudaStream_t)stream;
  const bool pairs = pool % 2 == 0 && (uintptr_t)mp % 8 == 0;
#define QK_MERGE(V, TOP2)                                                                   \
  merge_positions_kernel<V, TOP2><<<grid, kThreads, 0, st>>>((const float*)mp, (int*)out, B, \
                                                             pool, kfin, lane_mult, inv_slot)
  if (pool > kFold) {
    if (pairs) QK_MERGE(2, true);
    else QK_MERGE(1, true);
  } else {
    if (pairs) QK_MERGE(2, false);
    else QK_MERGE(1, false);
  }
#undef QK_MERGE
  return (int)cudaGetLastError();
}

// The body qk_flat_topk runs at this shape and element size (4 f32, 2 bf16).
int qk_flat_topk_body(int N, int D, int elem_bytes) {
  return flat_topk_body(N, D, elem_bytes == 2);
}

// K3: replaces quake_tpu/ops/pallas_flat.py::_flat_topk_kernel; q and codes
// f32, bias f32.
int qk_flat_topk(const void* q, const void* codes, const void* bias, void* out, int B, int N,
                 int D, int k, int is_l2, int slot_mult, float levels, void* stream) {
  return flat_topk<float>(q, codes, bias, out, B, N, D, k, is_l2, slot_mult, levels, stream);
}

// K3 on bf16 q and codes, the rest as qk_flat_topk's.
int qk_flat_topk_bf16(const void* q, const void* codes, const void* bias, void* out, int B,
                      int N, int D, int k, int is_l2, int slot_mult, float levels,
                      void* stream) {
  return flat_topk<__nv_bfloat16>(q, codes, bias, out, B, N, D, k, is_l2, slot_mult, levels,
                                  stream);
}

}  // extern "C"
