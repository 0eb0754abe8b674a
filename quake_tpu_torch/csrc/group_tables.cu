// Hand-written kernels of the search plan's grouping prologue: the
// partition-major group tables of the v10, v11 and v10b scans and kernel
// K1's inputs (ops/grouped_scan.py::group_tables_kernel), in four launches.
//
// They replace no TPU kernel. The JAX package builds these tables with XLA
// operations (quake_tpu/ops/grouped.py::build_groups_scatter and
// build_groups_budget; pallas_grouped.py::_global_bounds and the
// pre-transforms before grouped_scan_pallas_v10/_v11/_v10b's kernel), and
// the port's plain version (group_tables_plain) takes about a hundred small
// PyTorch operations, one sort among them: the host's time to issue them,
// not the device's to run them, held back every search, since K1 cannot
// start before the tables exist.
//
// The outputs equal the plain version's bit for bit. The tables are exact
// integers: each valid pair (0 <= pid < P) lands in its partition's run in
// flat pair order (the stable order of the plain version's sort), the runs
// in partition order; with a pair budget the sorted order is cut at n_bud
// pairs. The floats follow global_scale's f32 operations one by one, each
// rounded on its own (__f*_rn: no contraction), and torch's order where a
// PyTorch operation decides it: the wrapper sums |q|^2 with torch.sum, and
// ginv = float(levels) / grange is PyTorch's reciprocal times levels.
//
//   group_count    one warp per tile of `tile` pairs: the histogram of its
//                  pids in shared memory, written to hist[t][p]. The blocks
//                  past the tiles reduce max |q|^2 and max |x|^2 to per-block
//                  partial maxima (no atomics, so no buffer to clear first).
//   group_scan     one block: per partition the exclusive prefix of the tile
//                  counts (in place) and the run length, cut at the budget;
//                  each run's first group; gmin and ginv.
//   group_scatter  one warp per tile: each pair's stable rank among the
//                  tile's pairs of its partition (__match_any_sync in steps
//                  of 32 pairs, a counter per partition in shared memory)
//                  gives its rank in the run, hence its group and row:
//                  tgt[g][r] = flat pair index.
//   group_tables   one block per group: gp, group_size, the rows of no pair
//                  (tgt = n, query 0), and the query tile qg, the queries
//                  scaled by q_coef and rounded to the codes' dtype; the
//                  blocks past the groups write normsT.
//
// Bound: bytes. The query tiles (Gn qt D elements) are most of them, written
// once, as the plain version's gather writes them; the rest is integer work
// on tables of a few hundred thousand entries, which a few microseconds
// cover. Each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 1024;
constexpr int kTableThreads = 256;
constexpr int kUnroll = 8;  // pids a lane loads ahead in the tile kernels
constexpr int kMaxQt = 64;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Exclusive prefix of v over the block's threads (blockDim.x = kScanThreads);
// sums is kScanThreads / 32 ints of shared memory.
__device__ int block_exclusive_scan(int v, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = sums[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += t;
    }
    sums[lane] = wi - w;
  }
  __syncthreads();
  const int out = sums[warp] + incl - v;
  __syncthreads();
  return out;
}

__global__ void group_count_kernel(const int* __restrict__ pids, const float* __restrict__ rowsq,
                                   const float* __restrict__ norms, int* __restrict__ hist,
                                   float* __restrict__ partials, int n, int P, int tile,
                                   int ntiles, int B, int PC, int nred) {
  extern __shared__ int counts[];
  const int lane = threadIdx.x;
  if ((int)blockIdx.x < ntiles) {
    const int t = blockIdx.x;
    for (int p = lane; p < P; p += 32) counts[p] = 0;
    __syncwarp();
    const int lo = t * tile, hi = min(n, lo + tile);
    for (int base = lo; base < hi; base += 32 * kUnroll) {
      int pv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * 32 + lane;
        pv[u] = i < hi ? pids[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (pv[u] >= 0 && pv[u] < P) atomicAdd(&counts[pv[u]], 1);
    }
    __syncwarp();
    for (int p = lane; p < P; p += 32) hist[(size_t)t * P + p] = counts[p];
    return;
  }
  const int r = blockIdx.x - ntiles;
  float mq = -INFINITY, mx = -INFINITY;
  for (int i = r * 32 + lane; i < B; i += nred * 32) mq = fmaxf(mq, rowsq[i]);
#pragma unroll 4
  for (long long i = r * 32 + lane; i < PC; i += nred * 32) mx = fmaxf(mx, norms[i]);
  mq = warp_max(mq);
  mx = warp_max(mx);
  if (lane == 0) {
    partials[r] = mq;
    partials[nred + r] = mx;
  }
}

__global__ void __launch_bounds__(kScanThreads)
group_scan_kernel(int* __restrict__ hist, int* __restrict__ run, int* __restrict__ gbase,
                  int* __restrict__ gend, const float* __restrict__ partials,
                  const float* __restrict__ sampled_gmin, const float* __restrict__ sampled_grange,
                  float* __restrict__ scale, int ntiles, int P, int n_bud, int qt, int l2,
                  float levels, int nred) {
  __shared__ int sums[kScanThreads / 32];
  __shared__ float red[2][kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The key scale (global_scale, global_bounds "analytic"), or the sampled
  // bounds the wrapper computed.
  float mq = -INFINITY, mx = -INFINITY;
  for (int i = tid; i < nred; i += kScanThreads) {
    mq = fmaxf(mq, partials[i]);
    mx = fmaxf(mx, partials[nred + i]);
  }
  mq = warp_max(mq);
  mx = warp_max(mx);
  if (lane == 0) {
    red[0][warp] = mq;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    float maxq2 = red[0][0], maxx2 = red[1][0];
    for (int w = 1; w < kScanThreads / 32; ++w) {
      maxq2 = fmaxf(maxq2, red[0][w]);
      maxx2 = fmaxf(maxx2, red[1][w]);
    }
    float gmin, grange;
    if (sampled_gmin != nullptr) {
      gmin = *sampled_gmin;
      grange = *sampled_grange;
    } else {
      maxx2 = fmaxf(maxx2, 1e-12f);
      const float maxqx = __fmul_rn(__fsqrt_rn(maxq2), __fsqrt_rn(maxx2));
      const float gmax = l2 ? maxq2 : maxqx;
      gmin = l2 ? -__fadd_rn(maxx2, __fmul_rn(2.0f, maxqx)) : -maxqx;
      grange = fmaxf(__fsub_rn(gmax, gmin), 1e-20f);
    }
    scale[0] = gmin;
    scale[1] = __fmul_rn(__frcp_rn(grange), levels);
  }

  // Per partition, the exclusive prefix of its tile counts: `tpp` lanes of a
  // warp share a partition, each summing a contiguous chunk of the tiles.
  int tpp = 1;
  while (tpp < 32 && tpp * 2 * P <= kScanThreads) tpp *= 2;
  const int sub = tid % tpp, groups = kScanThreads / tpp;
  const int chunk = (ntiles + tpp - 1) / tpp;
  const int t0 = min(ntiles, sub * chunk), t1 = min(ntiles, t0 + chunk);
  for (int p0 = 0; p0 < P; p0 += groups) {
    const int p = p0 + tid / tpp;
    int s = 0;
    if (p < P) {
#pragma unroll 4
      for (int t = t0; t < t1; ++t) s += hist[(size_t)t * P + p];
    }
    int incl = s;
    for (int o = 1; o < tpp; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o, tpp);
      if (sub >= o) incl += v;
    }
    if (p < P) {
      int acc = incl - s;
      for (int t = t0; t < t1; ++t) {
        const int c = hist[(size_t)t * P + p];
        hist[(size_t)t * P + p] = acc;
        acc += c;
      }
      if (sub == tpp - 1) run[p] = incl;
    }
  }
  __syncthreads();

  // Across partitions: each run's start in the sorted order, its length cut
  // at the budget, its first group and the group after its last.
  const int per = (P + kScanThreads - 1) / kScanThreads;
  const int pa = min(P, tid * per), pb = min(P, pa + per);
  int local = 0;
  for (int p = pa; p < pb; ++p) local += run[p];
  int start = block_exclusive_scan(local, sums);
  int local_groups = 0;
  for (int p = pa; p < pb; ++p) {
    const int c = run[p];
    const int kept = n_bud > 0 ? max(0, min(c, n_bud - start)) : c;
    start += c;
    run[p] = kept;
    local_groups += (kept + qt - 1) / qt;
  }
  int g = block_exclusive_scan(local_groups, sums);
  for (int p = pa; p < pb; ++p) {
    gbase[p] = g;
    g += (run[p] + qt - 1) / qt;
    gend[p] = g;
  }
}

__global__ void group_scatter_kernel(const int* __restrict__ pids, const int* __restrict__ hist,
                                     const int* __restrict__ run, const int* __restrict__ gbase,
                                     int* __restrict__ tgt, int n, int P, int tile, int qt) {
  extern __shared__ int next[];  // the run rank of the tile's next pair of each partition
  const int lane = threadIdx.x, t = blockIdx.x;
  for (int p = lane; p < P; p += 32) next[p] = hist[(size_t)t * P + p];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int lo = t * tile, hi = min(n, lo + tile);
  for (int base = lo; base < hi; base += 32 * kUnroll) {
    int pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      pv[u] = i < hi ? pids[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = pv[u];
      const bool ok = p >= 0 && p < P;
      const unsigned peers = __match_any_sync(kFull, ok ? p : -1);
      const int r = ok ? next[p] + __popc(peers & below) : 0;
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) next[p] += __popc(peers);
      __syncwarp();
      if (ok && r < run[p])
        tgt[(size_t)(gbase[p] + r / qt) * qt + r % qt] = base + u * 32 + lane;
    }
  }
}

template <typename T>
__device__ __forceinline__ T to_operand(float v);
template <>
__device__ __forceinline__ float to_operand<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_operand<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kTableThreads)
group_tables_kernel(const int* __restrict__ run, const int* __restrict__ gbase,
                    const int* __restrict__ gend, const int* __restrict__ sizes,
                    const float* __restrict__ q, const float* __restrict__ norms,
                    const float* __restrict__ scale, int* __restrict__ gp,
                    int* __restrict__ gsize, int* __restrict__ tgt, T* __restrict__ qg,
                    float* __restrict__ normsT, int P, int PC, int Gn, int qt, int n, int nprobe,
                    int D, int l2, int nnorm) {
  const float gmin = scale[0], ginv = scale[1];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= Gn) {
    for (long long i = (blockIdx.x - Gn) * kTableThreads + tid; i < PC;
         i += nnorm * kTableThreads)
      normsT[i] = __fmul_rn(__fadd_rn(l2 ? norms[i] : 0.0f, gmin), ginv);
    return;
  }
  __shared__ int live;
  __shared__ int qrow[kMaxQt];
  const int g = blockIdx.x;
  if (tid == 0) {
    int p = -1;
    if (g < gend[P - 1]) {  // the first partition whose groups end past g
      int lo = 0, hi = P - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (gend[mid] > g) hi = mid;
        else lo = mid + 1;
      }
      p = lo;
    }
    gp[g] = p;
    gsize[g] = p >= 0 ? sizes[p] : 0;
    live = p >= 0 ? min(qt, run[p] - (g - gbase[p]) * qt) : 0;
  }
  __syncthreads();
  for (int r = tid; r < qt; r += kTableThreads) {
    int b = 0;
    if (r < live) b = tgt[(size_t)g * qt + r] / nprobe;
    else tgt[(size_t)g * qt + r] = n;
    qrow[r] = b;
  }
  __syncthreads();
  const float coef = l2 ? __fmul_rn(2.0f, ginv) : ginv;
  T* out = qg + (size_t)g * qt * D;
  for (int e = tid; e < qt * D; e += kTableThreads) {
    const int r = e / D, d = e - r * D;
    out[e] = to_operand<T>(__fmul_rn(q[(size_t)qrow[r] * D + d], coef));
  }
}

int smem_limit(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// pids [n] int32, rowsq [B] f32 (|q|^2 a row), norms [PC] f32; writes hist
// [ntiles, P] int32 and partials [2 nred] f32. nred 0 (rowsq may be null)
// under the sampled bounds, which need no maxima.
int qk_group_count(const void* pids, const void* rowsq, const void* norms, void* hist,
                   void* partials, int n, int P, int tile, int ntiles, int B, int PC, int nred,
                   void* stream) {
  const size_t smem = (size_t)P * sizeof(int);
  const int rc = smem_limit((const void*)group_count_kernel, smem);
  if (rc != (int)cudaSuccess) return rc;
  group_count_kernel<<<ntiles + nred, 32, smem, (cudaStream_t)stream>>>(
      (const int*)pids, (const float*)rowsq, (const float*)norms, (int*)hist, (float*)partials,
      n, P, tile, ntiles, B, PC, nred);
  return (int)cudaGetLastError();
}

// n_bud 0: every valid pair; sampled_gmin and sampled_grange null for the
// analytic bounds. Writes hist in place, run, gbase, gend [P] int32 and scale
// [2] f32 (gmin, ginv).
int qk_group_scan(void* hist, void* run, void* gbase, void* gend, const void* partials,
                  const void* sampled_gmin, const void* sampled_grange, void* scale, int ntiles,
                  int P, int n_bud, int qt, int l2, float levels, int nred, void* stream) {
  group_scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (int*)hist, (int*)run, (int*)gbase, (int*)gend, (const float*)partials,
      (const float*)sampled_gmin, (const float*)sampled_grange, (float*)scale, ntiles, P, n_bud,
      qt, l2, levels, nred);
  return (int)cudaGetLastError();
}

// Writes the rows of tgt [Gn, qt] int32 that hold a pair.
int qk_group_scatter(const void* pids, const void* hist, const void* run, const void* gbase,
                     void* tgt, int n, int P, int tile, int ntiles, int qt, void* stream) {
  const size_t smem = (size_t)P * sizeof(int);
  const int rc = smem_limit((const void*)group_scatter_kernel, smem);
  if (rc != (int)cudaSuccess) return rc;
  group_scatter_kernel<<<ntiles, 32, smem, (cudaStream_t)stream>>>(
      (const int*)pids, (const int*)hist, (const int*)run, (const int*)gbase, (int*)tgt, n, P,
      tile, qt);
  return (int)cudaGetLastError();
}

// q [B, D] f32; qg [Gn, qt, D] of elem_bytes (4 f32, 2 bf16); gp, gsize [Gn]
// int32; the rest of tgt; normsT [PC] f32.
int qk_group_tables(const void* run, const void* gbase, const void* gend, const void* sizes,
                    const void* q, const void* norms, const void* scale, void* gp, void* gsize,
                    void* tgt, void* qg, void* normsT, int P, int PC, int Gn, int qt, int n,
                    int nprobe, int D, int elem_bytes, int l2, int nnorm, void* stream) {
  if (qt > kMaxQt) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = Gn + nnorm;
#define QK_TABLES(T)                                                                        \
  group_tables_kernel<T><<<grid, kTableThreads, 0, st>>>(                                   \
      (const int*)run, (const int*)gbase, (const int*)gend, (const int*)sizes,              \
      (const float*)q, (const float*)norms, (const float*)scale, (int*)gp, (int*)gsize,     \
      (int*)tgt, (T*)qg, (float*)normsT, P, PC, Gn, qt, n, nprobe, D, l2, nnorm)
  if (elem_bytes == 2) QK_TABLES(__nv_bfloat16);
  else QK_TABLES(float);
#undef QK_TABLES
  return (int)cudaGetLastError();
}

}  // extern "C"
