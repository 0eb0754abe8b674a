#!/usr/bin/env python3
"""Full-width run of quake_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. card    — needs torch.cuda; prints nvidia-smi's name and power limit.
2. build   — compiles the CUDA kernels from quake_tpu_torch/csrc with nvcc.
3. parity  — holds kernels K1 (grouped scan), K2 (pool merge), K3 (parent
             ranking), K4 (per-row-scale grouped scan, exact top-kk; also
             with the v4 scan's chunk table), K5 (per-row-scale grouped scan,
             fold-128), K6 (exact-score grouped scan, by slot and by id), K7
             (chunked per-row-scale scan with the cross-chunk merge), K8 (raw
             scores), K9 (packed top-kk) and the sized and multi scans'
             kernels against their plain PyTorch versions on the card at
             small shapes; K1, K4-K9, sized_topk and multi_topk, which
             multiply on the tensor cores with split TF32 operands where
             D % 4 == 0, also at the shapes that stress their tiles (more
             groups than blocks, D below and at the tile depth, sizes around
             a 128-row segment, kk 1, 10 and 100, D 200 and 256 that a ring
             stage holds only in depth chunks; K7 with chunks of one and two
             segments; sized_topk with the rows past each size poisoned with
             999, +inf and NaN), against the f32 plain versions and (K1,
             K4-K9, sized_topk) against the plain versions run on
             ops/split_product.py's model of the split product; K4 with
             chunk tables of ct 128 and 256 and all of them at D = 30 (the
             CUDA-core bodies) against the f32 plain versions.
             K9 is also held equal to the top kk of K8's scores, packed, in
             the arithmetic of the body K9 ran (k8_as_k9). K1 on bf16 codes
             (its bf16 bodies) against its plain version (bf16 operands
             upcast, multiplied in f32) at D = 128 and 768 (tensor cores,
             768 in depth chunks) and D = 100 (D % 8 != 0: the CUDA-core
             body), each asserting the body.
4. main    — the fixed-nprobe main path at full width: a 1,000,000 x 128
             synthetic-manifold corpus (seed 1), nlist=160, niter=25, l2, f32
             codes, built and searched through QuakeIndex. Recall@10 on 1024
             queries against an exact ground truth on the card picks the
             smallest nprobe reaching 0.90; batches of B=16384 (argsort
             placement) and B=4096 (sorted placement) are then timed with
             CUDA events, with each stage span's device ms (stage_ms, under
             profiling.device_trace). The kernels' launch
             counts are zeroed just before this phase and read just after it.
             Then 5 B=16384 batches traced with torch.profiler (idle_share:
             the device's busy ms, the idle share, the five longest device
             operations; an `[idle]` line).
5. by name — the grouped scans chosen by name through QUAKE_TPU_KERNEL
             (v3p, v3p4, v7g4, v8g4, v11g4f256, which lands on v3pN at
             C % 256 != 0, then xla, v3, v2, v6, v5, v4 and v10g4) on the
             main phase's index at its nprobe: recall@10 on the same 1024
             queries (the exact-score paths xla, v3 and v2 within 0.001 of
             the exact scan of the probed partitions, the per-row-scale paths
             at most 0.01 below it, v8 and v10 within 0.005 of the v11 path),
             ms per B=16384 batch with a stage breakdown, and each path's
             kernel launches (counts zeroed just before the path, read just
             after); then the default v11 path with
             QUAKE_TPU_V11_PLACEMENT=argsort, timed at B=4096 (where the
             default placement is sorted), within 0.005 of the v11 path.
6. direct  — the four grouped scans with entry points of their own
             (grouped_scan_approx, _sized with ct=256, _packed, _multi with
             gb=8) called with the main index's tensors at the main nprobe and
             qt=64, the probe lists from the parent ranking: recall@10 on the
             1024 queries (approx, sized and multi within 0.001 of the exact
             scan of the probed partitions, packed at most 0.01 below it), ms
             per B=16384 batch with stages, and each path's launches.
7. latency — QuakeIndex.search on the main index query-major: B=1, B=8, and
             B=64 with batched_scan=False, ids against the exact scan of the
             same probed partitions, ms per search on the host clock (the
             search ends in a copy to the host); and a flat index (nlist=0)
             over the same corpus searched with the 1024 queries, recall@10
             against the exact ground truth >= 0.999.
8. check   — the results are finite and of the expected shape, and a small
             index searched on the card agrees with the same store searched
             on the CPU through the plain versions, for v11 and for each
             name of phase 5.
9. wide    — the default search at D = 768 (65,536 x 768 manifold corpus,
             nlist=64, B=1024, nprobe 8): K1 at the query-tile height the
             index picks (32), K3 streaming the depth, K2; ids against the
             exact scan of the probed partitions (overlap >= 0.99).
10. kernels — each kernel against its plain version again, at the shapes the
             main path (K1-K3 and the grouping kernels; K3 also with 16,384
             corpus rows as its buffer; K2 beside an empty kernel on its
             grid, the launch floor), the by-name paths (K4 through v3p, v3pN,
             v6 and v4, K5 through v7, K1 through v8, K6 through v3 and v2,
             K7 through v5) and the direct paths (K8, K9, sized_topk,
             multi_topk) gave it, with times and bounds (K1, K3, K4 on whole
             partitions, K5-K9, sized_topk and multi_topk, against the
             tensor cores' TF32 peak at three products per f32 one, the
             others against the CUDA cores' f32 peak; K8's bytes outweigh its
             operations there; no kernel may beat its bound; the rows of
             K4-K9 and sized_topk also against their plain versions on the
             split product's model, K9 equal to the top kk of K8's scores,
             packed, and the rows of K4-K9, sized_topk and multi_topk name
             the body the launcher picked, which must be the tensor-core
             one), and the share of K1's time that its selection takes (K1
             against a build of its body without the selection). Then K1
             under bounds="sampled" (the key's scale from a sample of real
             scores, an option of v8-v11 and v10b) at the main shapes
             against its plain version, timed beside the analytic scale,
             and v11's recall@10 of the 1024 queries at the main nprobe
             under both bounds (a `[sampled]` line; the grouped_scan entry
             of the kernels line carries it as "sampled").
11. headline bf16 — bench.py's headline serving mode: the same corpus
             built through QuakeIndex with precision="bf16" (bf16 codes,
             the f32 parent: K1's bf16 body, K2, K3), the smallest nprobe
             of the grid reaching recall@10 0.90 with exact_distances=False
             (dequantized scores) on the 1024 queries against the exact
             ground truth over the f32 vectors; B=16384 and B=4096 batches
             timed with CUDA events and stage spans, beside the f32 index's
             exact_distances=False and the bf16 index's exact search at the
             same nprobe; the launch counts zeroed just before the headline
             path's run and read just after (K1 bf16, K2, K3 must launch,
             the f32 K1 must not); K1's bf16 body against its plain version
             at the headline shapes (overlap >= 0.99, common keys within
             one level; the launcher must pick the tensor-core body), with
             its time and bound (2 bytes an element, bf16 tensor-core peak);
             a save and a load of the bf16 index (codes equal bit for bit,
             the checkpoint about half the f32 one's, search ids equal); 5
             headline B=16384 batches traced as in phase 4.
12. aps    — recall-target search in bench_suite.py::run_aps_batch's
             configuration: the same corpus built through QuakeIndex with
             default IndexBuildParams (nlist=1024, niter 5, f32, so
             calibrate_aps runs: build seconds with its share, the
             calibrated fields); one B=4096 batch each of aps_mode auto,
             oneshot (the parents ranked by K3 inside, budgeted; where the
             calibration left the budget off, the JAX package's formula sets
             it first), planned and loop with the launch counts zeroed just
             before and read just after (K3, K2, K1, and K1 on the budget
             grid, grouped_scan_budget, must launch); every K1, K2 and K3
             call of each mode's batch, recorded in a second run, held
             against its plain version; per mode recall@10 on the 1024 queries (auto and
             oneshot >= 0.87, planned and loop >= 0.85), ms per B=4096 batch
             (CUDA events; the loop, which reads a flag from the device each
             step, host-paced), mean partitions scanned, the loop's steps and
             syncs; the fixed-nprobe anchor (the first of 16, 32, 64 reaching
             0.90) and the fixed/APS(auto) QPS ratio; auto at B=64 on the
             host clock; at the pinned oneshot's plan, K1 on the budget grid
             (the tensor-core body) against its plain version with its time
             and bound, v10b's ids equal to v10's with every valid pair in
             the budget; then the headline bf16 index calibrated and one
             pinned-oneshot exact_distances=False batch on it (run_deep's
             serving mode), its launches counted alone (K1's bf16 body on
             the budget grid, grouped_scan_budget_bf16, once, and no other
             K1), its K1, K2 and K3 calls held against their plain
             versions, and its budget-grid K1 timed against its bound.
13. spill  — SOAR spill (IndexBuildParams.spill: every vector stored twice,
             the second copy in the partition soar_assign picks): the main
             corpus built with spill=True, soar_lambda=1.0 (build seconds
             with soar_assign's share, C, P, the store's bytes; the sizes
             sum to 2 N, validate(), and on the card every id twice in two
             different partitions, the two id maps naming them). Recall@10
             of the 1024 queries at nprobe 3, 4, 5, 6, 7, 9, 12, 16, 24
             beside the unspilled f32 index of phase 4 (the spilled one
             above it at nprobe 6 and at its own 0.90 nprobe through v11,
             and through the exact scan of the probed partitions at nprobe
             6 and 12, as tests/test_spill.py:59 gates one nprobe); the
             smallest nprobe reaching 0.90 and 0.95 for each index, B=16384
             timed there with stages, QPS at equal recall; the spilled
             batch launches K1 and K3 once each and no K2 (the dedup tail's
             top-2k replaces it), no id twice in any row, and every K1 and
             K3 call of that counted batch against its plain version; K1
             under bounds="sampled" on the spilled store and v11's recall@10
             at nprobe 9 under both bounds (a `[sampled]` line). B=8
             query-major (grouped_scan_xla with dedup) on the host clock;
             APS planned and loop at target 0.9 (recall@10 gates 0.85,
             B=4096 ms, launches), every K1 and K2 call of each counted
             batch against its plain version. Then add 100,000 vectors (seed 29, ids from 3 N),
             remove 50,000 ids, modify 1,000, each timed (vectors/s) and
             followed by validate(), the invariant, contract 6 with both
             maps and a B=1024 search with no id twice; a save and a load
             (arrays equal, the invariant, search ids equal). Maintenance
             at a cut depth (it runs on the host for a spilled store): a
             spilled index over the first 100,000 vectors, nlist 16 (the
             same partition size), one maintenance() after a 1024-query
             window (stage ms, splits, deletes) and a delete of the 4
             smallest partitions with reassignment, each followed by the
             same gates. `[spill]` lines on stderr.
14. mutation — the mutation path on the main index, after every phase
             that reads the built store, on the native id map (the
             phase fails on another): through the store, 40% of the
             resident ids removed (seeded), then 200,000 fresh manifold
             vectors (seed 13, ids from 1,000,000) appended to their nearest
             active centroid. Then through QuakeIndex, while C is still
             7552: a flood of tight copies of the largest partition's
             centroid (0.1 of its rms spread a coordinate), sized by the
             JAX package's rule to need 512 rows past both C and the split
             cap, which the index splits instead of growing C; the flood
             removed and 100,000 fresh vectors (seed 19, ids from 2,000,000)
             added; a save and a load through a temporary directory (the
             loaded arrays, free rows and generations equal the live ones
             at both levels, its default search returns the same ids, K1-K3
             pass their gates on it). Then, through the store, a flood of
             jittered copies of the then largest partition's centroid that
             pushes it past C, so that C doubles (7552 -> 15104, new
             tensors). Removal, adds, appends, save and load are timed on
             the host clock. On the reduced, the split and the grown store:
             contract 6 (ids >= 0 exactly below the sizes, norms equal to
             the codes' squared norms, the id map's count equal to the sizes'
             sum), then the default (K1, K2, K3), sized and multi paths at
             B=16384 (ms per batch, launches; recall@10 against an exact
             ground truth of the store's vectors, sized and multi within
             0.001 of the exact scan of the probed partitions), and K1, K2,
             K3, sized_topk and multi_topk against their plain versions at
             those paths' inputs with the gates of phase 10.
15. maintenance — cost-based maintenance, last, after the earlier indexes
             are freed: the main configuration built afresh (the same corpus,
             nlist=160, niter=25, f32) with profile_maintenance_latency=True,
             so that the build times K1 and K2 (the default v11 scan) at every
             point of the latency grid in device time (the profile's seconds
             and launches; the analytic / profiled and the packaged /
             profiled ratios at n = 1024, 4096, 16384, k = 16; K1 and K2 of
             the grid point n = 4096, k = 16 against their plain versions
             with phase 10's gates). A save and a load carry the profiled
             grid into the loaded index's policy (read from its CSV, the grid
             equal at rtol 1e-5). The index then takes the policy a default
             build sets on the card, on the packaged H100 grid
             (packaged(d=128,scale=1.000)).
             Traffic: the 4 smallest
             partitions age out through QuakeIndex.remove (16 vectors left in
             each: below min_partition_size, so no delete rejection runs for
             them); one B=1024 search at the main nprobe, 90% jittered copies
             of vectors of the 8 largest partitions and 10% of the uniform
             queries, fills the default 1000-query window through the search
             path (K3, K1 and K2 launch once each). Round A: maintenance()
             on the packaged grid (splits, deletes, delete
             candidates simulated, each stage's time). Round B: the
             mechanisms on named rows, each timed: the aged partitions
             deleted with reassignment, split_partitions of the 8 largest
             (the batched 2-means on the card), local_refinement of the new
             rows (the batched refinement). After each round: ntotal and the
             id set unchanged, validate(), contract 6 at both levels, one
             parent centroid per active partition. Before round A and after
             round B: the default B=16384 batch ms and recall@10 of the 1024
             uniform queries and of the skewed batch against an exact ground
             truth of the store's vectors. Then K1, K2 and K3 against their
             plain versions at the maintained store's inputs, and a save and
             a load (the loaded index has a fresh policy on the packaged
             grid). `[maintenance]` lines on stderr.
16. workload — (run after phase 13, while the corpus lives)
             regression/configs/sift1m_balanced.yaml's dynamic workload
             through the port's tooling: DynamicWorkloadGenerator over the
             corpus as the base pool (its clustering index of nc 1000 built
             on the card) and the main queries, insert / delete / query
             0.33 / 0.33 / 0.34, update batch 1000, query batch 100,
             initial 100,000, uniform, seed 1738, WORKLOAD_OPS operations;
             WorkloadEvaluator with QuakeWrapper (nc 1024; k 10, nprobe 32;
             the initial index built and saved, then loaded by the
             evaluation; default MaintenancePolicyParams, maintenance()
             after every operation, batched search). Gates: n_total equal
             to the runbook's n_resident after every operation, validate(),
             contract 6 and one parent centroid a partition at the end, K1
             and K3 once on every query op and K2 once where the v11 pool
             merges on it (key x lane must fit 24 bits: at nprobe 32 only
             once C passes 256; else a top-k of the keys, as in the JAX
             package), every K1, K2 and K3 call of the last query op
             against its plain version (K1 overlap >= 0.9999, K2 and K3
             equal), mean recall@10 > 0.5. Then 8 threads
             search the final index at once (ids equal to the serial
             search's, no launch lost), and a B=1024 search under debug
             mode runs clean while a NaN produced on the card raises.
             `[workload]` lines: generation and build seconds, ms per
             insert, delete and query, maintenance ms, splits and deletes
             (under the policy's default latency grid, which the line names:
             the packaged H100 grid on the card), recall@10, launches per
             query op.
17. multilevel — (run after phase 12) multi-level parents: the corpus built
             with default IndexBuildParams at nlist 4096 under an IVF parent
             of nlist 64 (parent_params; three levels), beside the same
             nlist under the default flat parent. For each: build seconds,
             validate() and contract 6 at every level; recall@10 of the 1024
             queries against the exact ground truth and ms per B=4096 batch
             at nprobe 16, 32 and 64; the launches of one fixed-nprobe batch
             (over the flat parent the fused path: K3 at N = 4096, K1, and
             K2 where the pool merges on it; over the IVF parent none, the
             leaf on the "xla" scan as in the JAX package); APS at target
             0.9 in aps_mode auto and planned (recall, ms, partitions
             scanned, launches); every K1, K2 and K3 call of a planned batch
             (and of the fused batch) against its plain version. Then the
             3-level index's add / remove round: a flood that splits the
             largest leaf partition with C held, which changes the mid
             level's centroids, the flood removed, the gates of every level
             after each step; a save and a load that return the same ids.
             `[multilevel]` lines on stderr.

18. shard — (run after phase 7, while its flat index lives) sharding on
             the card, four shards on one card (shard(4, devices=[cuda:0] *
             4)): the main corpus built afresh (nlist=160, calibrate_aps=
             False), searched unsharded and then sharded (C 7552 -> 7680, a
             local C of 1920; each shard a contiguous copy of its slot slice,
             equal to the primary's bit for bit, contract 6 on each). The
             fixed-nprobe batch at B=16384 and the main nprobe: ms and stages
             beside the unsharded batch (K1 summed over the shards, the
             gather and merge), launches of one counted batch (K1 and K2 four
             times each, K3 never: the sharded route ranks the parents by the
             flat scan, as the JAX package's does), each of its K1 and K2
             calls against its plain version, ids overlapping the exact scan
             of the unsharded probe lists >= 0.99 (the local C's keys are
             finer than the unsharded ones: the sharded ids come nearer the
             exact scan), recall@10 at most 0.005 below the unsharded, the
             host syncs of a batch; APS planned and loop at 0.9 on B=4096
             (recall at most 0.01 below the unsharded, ms, launches, every
             K1 and K2 call held); the latency phase's flat index sharded
             four ways (B=1024 ids equal to its unsharded search's); 10,000
             vectors added and 10,000 removed through the sharded index,
             after each the shards equal to the primary, contract 6 on each,
             validate() and a counted batch. `[shard]` lines on stderr.

19. bf16 by name — (run after phase 11, on its bf16 index) every scan by
             name whose kernels have bf16 bodies (v3p, v3p4, v7g4, v11g4f256,
             v3, v2, v6, v5, v4) and the four direct scans on the headline
             bf16 index at the headline nprobe, each with its launches (its
             _bf16 kernel launched, the f32 twin not), recall@10 against the
             exact scan of the bf16 codes' probed partitions under phase 5's
             and 6's gates, and ms per B=16384 batch; then the kernels
             line's rows of those bf16 bodies at the paths' shapes, each
             held to its plain version (the launcher's body asserted: the
             tensor cores, v4's chunk table the CUDA cores), with its time
             and bound (2 bytes an element, the bf16 tensor-core peak).
             `[bf16 by name]`, `[bf16 direct]` and `[kernel]` lines.
20. bf16 parent — (run after phase 12) the main corpus under a bf16 parent
             (IndexBuildParams(parent_params=IndexBuildParams(precision=
             "bf16"))): build, each parent row the bf16 rounding of its
             centroid, a B=16384 batch at the main nprobe (K1, K2 and K3's
             bf16 body must launch, the f32 K3 must not; recall@10 at most
             0.005 below the f32 parent's), save and load (the parent bf16 bit
             for bit, ids equal); K3's bf16 body against its plain version at
             the parent ranking's shape and at N = 16384, with its bound.
             `[bf16 parent]` lines. Phase 3 also holds the bf16 bodies of
             K3-K9, sized_topk and multi_topk to their plain versions at D =
             128 and 768 (tensor cores) and 100 (CUDA cores).
21. fold — (run after phase 12, on its index, the main f32 index and the
             headline bf16 index) folds other than 128 on kernels K1 and K5:
             on phase 12's index (nlist 1024, C 1536) at its fixed-nprobe
             anchor 32, the names v11g4f128, v11g4f256, v11g4f384,
             v11g4f512, v10g4f256, v8g4f256 and v7g4f256 through
             QUAKE_TPU_KERNEL; on the main and the headline bf16 index (C
             7552) at their nprobes v11g4f64 and v7g4f64. For each: recall@10
             of the 1024 queries beside the exact scan of the probed
             partitions (at most FOLD_RECALL_TOL below it), ms per B=16384
             batch with stages, the launches of one counted batch (K1 or K5
             and K3 must launch, K4, the v3pN fallback, must not) and every
             K1, K2, K3 and K5 call of it held to its plain version at the
             name's fold. The pinned oneshot under v11g4f256 (K1 on the
             budget grid at fold 256, its calls held alike). The kernels
             line's fold entries (grouped_scan/f64, /f256, /f384, /f512,
             grouped_scan/v8f256, grouped_scan_budget/f256,
             rowscale_fold/v7f64, /v7f256 and the bf16 index's
             grouped_scan_bf16/f64 and rowscale_fold_bf16/v7f64), each
             timed beside the same kernel at fold 128 on the same inputs.
             merge="xla" (the pool merge in tensor operations) against K2 on
             the main index at B=16384: ids, scores and scanned equal, no K2
             launch, each merge's stage ms. profile_scan_latency on the card
             at the default grid: its seconds and L(n, 16) at n = 1024,
             4096, 16384 beside the packaged grid's and the grouped scan's
             profile. `[fold]` lines. Phase 3 also holds K1 and K5 at folds
             32, 64, 256, 384 and 512 to their plain versions at small
             shapes (K1's and K5's f32 tensor-core and CUDA-core bodies and
             their bf16 bodies, K1 also on the budget grid).

The grouping kernels (group_count, group_scan, group_scatter, group_tables:
csrc/group_tables.cu, one call of ops/grouped_scan.py::group_tables_kernel)
build K1's tables on every v10, v11 and v10b call, so wherever a phase counts
a path's launches they launch once with each such K1 call, and wherever it
holds the recorded K1, K2 and K3 calls to their plain versions it holds each
recorded grouping call to group_tables_plain on the same card tensors, every
output to every bit. Phases 10 and 11 add their rows to the kernels line
(group_tables/f32 and /bf16: time, plain time, a bound by bytes).

Progress goes to stderr. Standard output holds three lines: the JSON list
of kernels, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

K, NLIST, NITER, N, D = 10, 160, 25, 1_000_000, 128
NQ_GT, BATCH, BATCH_SORTED = 1024, 16384, 4096
NPROBE_GRID = (9, 10, 11, 12, 14, 16, 24, 48)
RECALL_GATE = 0.90
OVERLAP_TOL = 0.99  # K1, K3-K7: winner overlap with the plain version
# Folds other than 128 (K1, K5): the small parity phase's folds, on a C that
# all of them divide.
SMALL_FOLDS = (32, 64, 256, 384, 512)
FOLD_SMALL_C = 1536
STATS_TOL = 1e-4  # K4, K5 per-row (rowmin, range): rtol = atol (f32 sums in another order)
# K6 and K7 scores, rank by rank: rtol = atol. K6's are f32 dot products
# summed in another order than torch.bmm's. K7's are dequantized keys, which
# the other order can also move by one level: atol grows by key_level(), a
# bound on a row's range / levels. A swap of two near-ties moves a rank's
# score by less than that and costs overlap, not score agreement.
SCORE_TOL = 1e-4
# Recall@10 gates of the scans chosen by name. The global-scale key (v8)
# must stay within V11_TOL of the v11 path, which quantizes the same way;
# the per-row-scale keys (v3p, v3pN, v7) quantize each row on its own range
# and must stay within EXACT_TOL of the exact scan of the same probed
# partitions (their measured gap is 0.0046, see PERF.md). The exact-score
# paths (xla, v3, v2) select on f32 scores and must reach that scan's recall
# within CEILING_TOL.
V11_TOL = 0.005
EXACT_TOL = 0.01
CEILING_TOL = 0.001
# The grouping prologue's launches (ops/grouped_scan.py::group_tables_kernel,
# csrc/group_tables.cu), one name for f32 and bf16 codes: every v10, v11 and v10b
# call (every K1 call through _placed_scan) launches each of them once, and
# check_recorded holds each recorded call to its plain version bit for bit.
GROUPING = ("group_count", "group_scan", "group_scatter", "group_tables")
# Scan name -> (the kernels that path must launch besides K3 (parent
# ranking), the recall it is held to: "ceiling", "exact" or "v11", timed
# batches).
BY_NAME = (("v3p", ("rowscale_topk",), "exact", 5), ("v3p4", ("rowscale_topk",), "exact", 5),
           ("v7g4", ("rowscale_fold",), "exact", 5),
           ("v8g4", ("grouped_scan", "merge_positions"), "v11", 5),
           ("v11g4f256", ("rowscale_topk",), "exact", 5),
           ("xla", (), "ceiling", 2), ("v3", ("exact_topk",), "ceiling", 5),
           ("v2", ("exact_topk",), "ceiling", 5), ("v6", ("rowscale_topk",), "exact", 5),
           ("v5", ("chunk_merge",), "exact", 5), ("v4", ("rowscale_topk",), "exact", 3),
           ("v10g4", ("grouped_scan", "merge_positions") + GROUPING, "v11", 5))
# The v11 placement forced to argsort where the sort key fits
# (QUAKE_TPU_V11_PLACEMENT), timed at B=BATCH_SORTED, where the default
# placement is sorted: same kernels, held within V11_TOL of the v11 path.
PLACEMENT_KNOB = {"QUAKE_TPU_V11_PLACEMENT": "argsort"}
# The wide-vector case through the default search: a D whose tensor-core
# body K1 runs only from qt = 32 down, and K3 streams in depth chunks.
WIDE_N, WIDE_D, WIDE_NLIST, WIDE_B, WIDE_NPROBE = 65_536, 768, 64, 1024, 8
K3_WIDE_N = 16_384  # K3's second shape: that many corpus rows as the buffer
MAIN_KERNELS = ("grouped_scan", "merge_positions", "flat_topk")
# The headline bf16 path: K1's bf16 body, K2, and K3 on the f32 parent.
BF16_MAIN_KERNELS = ("grouped_scan_bf16", "merge_positions", "flat_topk")
BF16_CHECKPOINT_RATIO = 0.55  # a bf16 checkpoint's bytes / the f32 one's: codes halve
# Direct path -> (its kernel, the recall it is held to, timed batches).
DIRECT = (("approx", "raw_scores", "ceiling", 3), ("sized", "sized_topk", "ceiling", 5),
          ("packed", "packed_topk", "exact", 5), ("multi", "multi_topk", "ceiling", 5))
DIRECT_QT, SIZED_CT, MULTI_GB = 64, 256, 8
LATENCY = ((1, None), (8, None), (64, False))  # (queries, batched_scan) of the query-major runs
# The mutation phase: the share of resident ids removed, the fresh vectors
# appended (and their make_manifold seed), how far past C the flood pushes one
# partition, and the seed of the removal's choice and the flood's jitter.
MUTATION_REMOVE, MUTATION_APPEND, MUTATION_APPEND_SEED = 0.4, 200_000, 13
MUTATION_FLOOD_OVER, MUTATION_SEED = 512, 17
# Its index-level step: the flood's jitter (a share of its partition's rms
# spread a coordinate), and the fresh vectors added through QuakeIndex.add
# after the flood is removed (their make_manifold seed; their ids start at 2 N).
MUTATION_JITTER, MUTATION_FRESH, MUTATION_FRESH_SEED = 0.1, 100_000, 19
# The dict id map's removal rate on this phase (H100 80GB HBM3, 700 W), for
# the log beside the native map's.
DICT_REMOVE_RATE = "0.64-0.84 M vectors/s"
FLAT_RECALL = 0.999
# The APS phase, bench_suite.py::run_aps_batch's configuration: nlist, the
# batch, the target, the modes driven (auto first: the fixed/APS ratio's
# denominator), the recall@10 gates (tests/test_aps.py:150 and :416's
# margins) and the fixed-nprobe anchor's grid.
APS_NLIST, APS_BATCH, APS_TARGET = 1024, 4096, 0.9
APS_MODES = ("auto", "oneshot", "planned", "loop")
APS_RECALL_GATES = {"auto": 0.87, "oneshot": 0.87, "planned": 0.85, "loop": 0.85}
APS_ANCHOR = (16, 32, 64)
# The maintenance phase: the partitions that age out (the smallest, all but
# MAINT_KEEP vectors removed: below min_partition_size, so no delete
# rejection runs for them), the hot partitions the skewed batch reads (the
# largest), the skewed share of that batch, its jitter (a share of the hot
# vectors' spread) and seed, the n of the analytic / profiled ratio (k = 16)
# and the queries of a latency-grid point.
MAINT_AGED, MAINT_KEEP, MAINT_HOT = 4, 16, 8
MAINT_SKEW, MAINT_JITTER, MAINT_SEED = 0.9, 0.1, 23
MAINT_RATIO_N = (1024, 4096, 16384)
MAINT_PACKAGED = "packaged(d=128,scale=1.000)"  # the default grid of a CUDA index at D = 128
MAINT_GRID_QUERIES = 1024
# The spill phase: SOAR's weight; the nprobe grids on which the spilled and
# the unspilled index read their recall (the unspilled one's wider: it needs
# more probes for the same recall); the nprobes at which the spilled index
# must beat the unspilled one, with the v11 scan (tests/test_spill.py:59's
# nprobe 6) and with the exact scan of the probed partitions (the
# "reference" scan: the candidate sets); the recall targets QPS is compared at;
# the APS modes run on the spilled index (oneshot runs planned there: a
# spilled build does not calibrate); the mutation's adds, removes and
# modifies and their seed; the query-major batch; the partitions deleted.
ML_NLIST, ML_PARENT_NLIST = 4096, 64  # the multilevel phase's leaf and mid level
ML_NPROBES = (16, 32, 64)
ML_BATCH = 4096
ML_TARGET = 0.9
ML_APS_MODES = ("auto", "planned")
ML_SEED = 41
SPILL_LAMBDA = 1.0
SPILL_NPROBES = (3, 4, 5, 6, 7, 9, 12, 16, 24)
UNSPILLED_NPROBES = (3, 4, 5, 6, 7, 9, 10, 11, 12, 14, 16, 24)
SPILL_GATE_NPROBE, SPILL_EXACT_NPROBES = 6, (6, 12)
SPILL_TARGETS = (0.90, 0.95)
SPILL_SAMPLED_NPROBE = 9  # v11 under both bounds on the spilled store, at the f32 headline nprobe
SPILL_APS_MODES = ("planned", "loop")
SPILL_ADD, SPILL_REMOVE, SPILL_MODIFY, SPILL_SEED = 100_000, 50_000, 1_000, 29
SPILL_SMALL_B, SPILL_DELETE = 8, 4
# Maintenance of a spilled store runs on the host (as in the JAX package):
# at full width maintenance() split all 160 partitions and refined the 320
# halves' neighbourhood in 204 s on an H100 80GB HBM3 at 700 W (PERF.md), so
# the phase runs it on a spilled index over the corpus's first vectors at
# the same partition size (mean 12,500 residencies), with fewer partitions.
SPILL_MAINT_N, SPILL_MAINT_NLIST, SPILL_MAINT_NPROBE = 100_000, 16, 4
# The kernels of the spilled fixed-nprobe path: K3 ranks the parents, the
# grouping kernels build K1's tables, K1 scans, and the dedup tail (a top-2k of
# the pool) takes K2's place.
SPILL_KERNELS = ("grouped_scan", "flat_topk") + GROUPING
# The dynamic workload (phase 16): regression/configs/sift1m_balanced.yaml's
# traffic and method on the synthetic corpus (the base pool) and the main
# queries, through the port's generator, evaluator and QuakeWrapper.
WORKLOAD = dict(metric="l2", insert_ratio=0.33, delete_ratio=0.33, query_ratio=0.34,
                update_batch_size=1000, query_batch_size=100, initial_size=100_000,
                cluster_size=1000, cluster_sample_distribution="uniform", seed=1738)
WORKLOAD_OPS = 250  # of the config's 1000: the cut of PERF.md section 4
WORKLOAD_BUILD = {"nc": 1024, "metric": "l2"}
WORKLOAD_SEARCH = {"k": K, "nprobe": 32}
WORKLOAD_RECALL_GATE = 0.5  # tests/test_workload.py:75
WORKLOAD_K1_OVERLAP = 0.9999  # the last query op's K1 calls against the plain version
THREADS, THREAD_REPS = 8, 4  # concurrent searches of the final index, B = NQ_GT
TRACE_REPS = 5  # batches traced for the idle share
SHARDS = 4  # shard(4, devices=[cuda:0] * 4): four shards on the one card
# A sharded batch's launches: each shard's grouping, K1 and K2.
SHARD_KERNELS = dict.fromkeys(("grouped_scan", "merge_positions") + GROUPING, SHARDS)
# v11's key levels follow C: at the local C (C / SHARDS) the keys are SHARDS x finer, so the
# sharded ids come nearer the exact scan than the unsharded ones (NVIDIA H100 80GB HBM3, 700 W,
# this corpus at nprobe 9: 0.96 overlap between the two, +0.022 recall). The sharded batch is held to the exact scan of the unsharded probe lists (the
# "reference" scan; ids overlap, mean over rows), and its recall@10 may not fall below the
# unsharded one by more than the tolerance.
SHARD_OVERLAP = 0.99
SHARD_RECALL_TOL = 0.005  # recall@10 of the fixed-nprobe batch, below the unsharded
SHARD_APS_B, SHARD_APS_TOL = 4096, 0.01  # APS planned and loop at APS_TARGET, below the unsharded
SHARD_APS_MODES = ("planned", "loop")
SHARD_FLAT_B = 1024
SHARD_WRITES = 10_000  # added (seed 43, ids from 4 N), then removed (every 100th id)
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 FLOP/s on the tensor cores (data sheet)
BF16_PEAK = 989e12  # H100 SXM dense bf16 FLOP/s on the tensor cores (data sheet)
# Unit a kernel's product runs on -> (its operations per f32 flop of the
# function, its peak). The tensor-core bodies take three TF32 products per f32
# one; K1's bf16 body one bf16 product.
UNITS = {"f32 CUDA cores": (1.0, F32_PEAK), "TF32 tensor cores, 3 products": (3.0, TF32_PEAK),
         "bf16 tensor cores": (1.0, BF16_PEAK)}
CUDA_CORES, TENSOR_CORES, BF16_TENSOR_CORES = UNITS
# The bf16 by-name phase on the headline bf16 index: every scan of BY_NAME
# whose kernels take bf16 codes through a body of their own (v8-v11 run K1's,
# which the headline phase holds), with the f32 phase's gates and fewer timed
# batches; the direct scans as DIRECT. A path's kernels launch under their
# _bf16 names, and their f32 twins must not.
BF16_BY_NAME = tuple((name, tuple(f"{k}_bf16" for k in kernels), gate, min(reps, 3))
                     for name, kernels, gate, reps in BY_NAME
                     if name in ("v3p", "v3p4", "v11g4f256", "v6", "v7g4", "v3", "v2", "v5", "v4"))
BF16_DIRECT = tuple((name, f"{kernel}_bf16", gate, min(reps, 3))
                    for name, kernel, gate, reps in DIRECT)
# A bf16 parent: the same corpus under IndexBuildParams(parent_params=
# IndexBuildParams(precision="bf16")); its fixed-nprobe batch must launch K3's
# bf16 body and not the f32 one, and its recall@10 may fall below the f32
# parent's at the same nprobe by at most this much.
BF16_PARENT_KERNELS = ("grouped_scan", "merge_positions", "flat_topk_bf16")
BF16_PARENT_RECALL_TOL = 0.005
# Entries of the kernels line whose product runs on the tensor cores at the
# paths' shapes (D = 128): K1, K3, K4 on whole partitions (with v4's chunk
# table it runs in f32 on the CUDA cores), K5-K9, sized_topk and multi_topk
# (their rows check that the launcher picked the tensor-core body).
# The fold phase (21): the scans by name at folds other than 128 on phase
# 12's index (C 1536) at its fixed-nprobe anchor, and at fold 64 (the fold
# below 128 that divides C = 7552) on the main f32 and the headline bf16
# index; a folded name's recall@10 may fall at most FOLD_RECALL_TOL below
# the exact scan of the same probed partitions (a sanity gate that a broken
# selection fails: v11's global-scale key alone loses 0.021-0.026 of it at
# fold 128 and nprobe 9 on the main index, PERF.md; every K1 and K5 call is
# held to its plain version besides). The kernels line's fold entries and
# their paths.
FOLD_NPROBE = 32
FOLD_APS_NAMES = ("v11g4f128", "v11g4f256", "v11g4f384", "v11g4f512", "v10g4f256", "v8g4f256",
                  "v7g4f256")
FOLD_MAIN_NAMES = ("v11g4f64", "v7g4f64")
FOLD_ONESHOT = "v11g4f256"  # the pinned oneshot's name: K1 on the budget grid at fold 256
FOLD_RECALL_TOL = 0.04
# Fold entry -> its fold-128 twin, whose TPU kernel it replaces too.
FOLD_TWIN = {"grouped_scan/f64": "grouped_scan", "grouped_scan/f256": "grouped_scan",
             "grouped_scan/f384": "grouped_scan", "grouped_scan/f512": "grouped_scan",
             "grouped_scan/v8f256": "grouped_scan/v8",
             "grouped_scan_budget/f256": "grouped_scan_budget",
             "rowscale_fold/v7f64": "rowscale_fold/v7", "rowscale_fold/v7f256": "rowscale_fold/v7",
             "grouped_scan_bf16/f64": "grouped_scan_bf16",
             "rowscale_fold_bf16/v7f64": "rowscale_fold_bf16/v7"}
TENSOR_CORE_ENTRIES = tuple(FOLD_TWIN) + (
                       "grouped_scan", "grouped_scan_bf16", "grouped_scan_budget",
                       "grouped_scan/v8", "flat_topk",
                       "rowscale_topk/v3p",
                       "rowscale_topk/v3pn", "rowscale_topk/v6", "rowscale_fold/v7",
                       "exact_topk/v3", "exact_topk/v2", "chunk_merge/v5", "multi_topk",
                       "raw_scores", "packed_topk", "sized_topk")
# The same kernels' bf16 bodies at the bf16 paths' shapes: one bf16 product a
# depth-16 step on the tensor cores (v4's chunk table on the CUDA cores, in f32
# on the converted values, as in f32). Every bf16 entry, v4's too, is bounded
# at the bf16 peak (unit_of).
BF16_ENTRIES = ("flat_topk", "rowscale_topk/v3p", "rowscale_topk/v3pn", "rowscale_topk/v6",
                "rowscale_fold/v7", "exact_topk/v3", "exact_topk/v2", "chunk_merge/v5",
                "rowscale_topk/v4", "raw_scores", "sized_topk", "packed_topk", "multi_topk")


def bf16_entry(entry: str) -> str:
    """The kernels line's name of an entry's bf16 twin: its kernel's launch
    name with _bf16 (rowscale_topk/v3p -> rowscale_topk_bf16/v3p)."""
    kernel, _, path = entry.partition("/")
    return f"{kernel}_bf16" + (f"/{path}" if path else "")

HBM_RATE = 3.35e12  # H100 SXM bytes/s
QUEUE_CYCLES = 50_000_000  # ~25 ms of spinning at the H100's clock: room to enqueue the reps
# Entry of the kernels line -> (CUDA kernel, its source, the TPU kernel it
# replaces). One entry per ported TPU kernel; _v8_kernel computes
# _v9_kernel's function and runs on K1, _v6_kernel computes _v3pn_kernel's and
# runs on K4, _v4_kernel runs on K4 with a chunk table.
ENTRIES = {
    "grouped_scan": ("grouped_scan", "quake_tpu_torch/csrc/quake_kernels.cu",
                     "quake_tpu/ops/pallas_grouped.py:1180"),
    # K1 on bf16 codes (the headline bf16 phase): _v9_kernel on bf16 slabs.
    "grouped_scan_bf16": ("grouped_scan_bf16", "quake_tpu_torch/csrc/quake_kernels.cu",
                          "quake_tpu/ops/pallas_grouped.py:1180"),
    # K1 on the budget grid of the masked APS scans (grouped_scan_v10b):
    # grouped_scan_pallas_v10b's launch of _v9_kernel.
    "grouped_scan_budget": ("grouped_scan", "quake_tpu_torch/csrc/quake_kernels.cu",
                            "quake_tpu/ops/pallas_grouped.py:1942"),
    # The same on bf16 codes (the headline bf16 index's pinned oneshot).
    "grouped_scan_budget_bf16": ("grouped_scan_bf16", "quake_tpu_torch/csrc/quake_kernels.cu",
                                 "quake_tpu/ops/pallas_grouped.py:1942"),
    "merge_positions": ("merge_positions", "quake_tpu_torch/csrc/quake_kernels.cu",
                        "quake_tpu/ops/pallas_grouped.py:994"),
    "flat_topk": ("flat_topk", "quake_tpu_torch/csrc/quake_kernels.cu",
                  "quake_tpu/ops/pallas_flat.py:32"),
    "rowscale_topk/v3p": ("rowscale_topk", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                          "quake_tpu/ops/pallas_grouped.py:289"),
    "rowscale_topk/v3pn": ("rowscale_topk", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                           "quake_tpu/ops/pallas_grouped.py:652"),
    "rowscale_fold/v7": ("rowscale_fold", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                         "quake_tpu/ops/pallas_grouped.py:813"),
    "grouped_scan/v8": ("grouped_scan", "quake_tpu_torch/csrc/quake_kernels.cu",
                        "quake_tpu/ops/pallas_grouped.py:1051"),
    "exact_topk/v3": ("exact_topk", "quake_tpu_torch/csrc/grouped_exact.cu",
                      "quake_tpu/ops/pallas_grouped.py:161"),
    "exact_topk/v2": ("exact_topk", "quake_tpu_torch/csrc/grouped_exact.cu",
                      "quake_tpu/ops/pallas_grouped.py:51"),
    "rowscale_topk/v4": ("rowscale_topk", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                         "quake_tpu/ops/pallas_grouped.py:1963"),
    "chunk_merge/v5": ("chunk_merge", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                       "quake_tpu/ops/pallas_grouped.py:2145"),
    "rowscale_topk/v6": ("rowscale_topk", "quake_tpu_torch/csrc/grouped_rowscale.cu",
                         "quake_tpu/ops/pallas_grouped.py:2327"),
    "raw_scores": ("raw_scores", "quake_tpu_torch/csrc/grouped_variants.cu",
                   "quake_tpu/ops/pallas_grouped.py:2462"),
    "sized_topk": ("sized_topk", "quake_tpu_torch/csrc/grouped_variants.cu",
                   "quake_tpu/ops/pallas_grouped.py:2540"),
    "packed_topk": ("packed_topk", "quake_tpu_torch/csrc/grouped_variants.cu",
                    "quake_tpu/ops/pallas_grouped.py:2726"),
    "multi_topk": ("multi_topk", "quake_tpu_torch/csrc/grouped_variants.cu",
                   "quake_tpu/ops/pallas_grouped.py:2872"),
    # The grouping prologue's four launches as one call (group_tables_kernel)
    # on the main path's f32 index and on the headline bf16 index. They replace
    # no TPU kernel: the JAX package builds the tables with XLA operations
    # (build_groups_scatter, and _global_bounds and the pre-transforms of
    # grouped_scan_pallas_v11).
    "group_tables/f32": ("+".join(GROUPING), "quake_tpu_torch/csrc/group_tables.cu",
                         "quake_tpu/ops/grouped.py:199"),
    "group_tables/bf16": ("+".join(GROUPING), "quake_tpu_torch/csrc/group_tables.cu",
                          "quake_tpu/ops/grouped.py:199"),
}


# Each bf16 twin: its kernel's bf16 launch name, the f32 entry's source and
# the TPU kernel it replaces (the Pallas kernels are generic in the codes'
# dtype).
ENTRIES.update({bf16_entry(e): (f"{ENTRIES[e][0]}_bf16",) + ENTRIES[e][1:] for e in BF16_ENTRIES})
ENTRIES.update({e: ENTRIES[twin] for e, twin in FOLD_TWIN.items()})


def is_bf16(entry: str) -> bool:
    """Whether an entry of the kernels line is a bf16 body's."""
    return entry.partition("/")[0].endswith("_bf16")


def unit_of(entry: str) -> str:
    """The unit (a key of UNITS) whose peak bounds an entry of the kernels
    line. A bf16 entry is bounded at the bf16 peak, one product a step, even
    where its body multiplies on the CUDA cores (v4's chunk table keeps
    tile_dots' order there by choice, not by a limit of the card)."""
    if is_bf16(entry):
        return BF16_TENSOR_CORES
    return TENSOR_CORES if entry in TENSOR_CORE_ENTRIES else CUDA_CORES


def on_tensor_cores(entry: str) -> bool:
    """Whether an entry's kernel runs its tensor-core body at the paths'
    shapes (the body its row checks the launcher chose)."""
    if is_bf16(entry):
        return entry != bf16_entry("rowscale_topk/v4")
    return entry in TENSOR_CORE_ENTRIES


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_manifold(n, d, n_centers, seed, zdim=16, spread=1.5):
    """SIFT-like synthetic: clustered data on a low-dimensional manifold
    embedded in d dims (the benchmark family of the JAX package)."""
    rng = np.random.default_rng(99)  # shared manifold/centers across calls
    A = rng.standard_normal((zdim, d)).astype(np.float32) / np.sqrt(zdim)
    centers = rng.standard_normal((n_centers, zdim)).astype(np.float32) * spread
    r = np.random.default_rng(seed)
    z = centers[r.integers(0, n_centers, n)] + r.standard_normal((n, zdim)).astype(np.float32)
    return (z @ A + 0.05 * r.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def bound(nbytes: float, flops: float, unit: str = CUDA_CORES):
    """Least time (ms) the card needs for the work, and what sets it; the
    operations run on `unit` (a key of UNITS)."""
    per_flop, peak = UNITS[unit]
    tb, tf = nbytes / HBM_RATE, flops * per_flop / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(torch, fn, reps: int = 10, warmup: int = 2, queued: bool = True) -> float:
    """Mean device time of fn() over reps launches (CUDA events). With
    queued, the card first spins for QUEUE_CYCLES while the host enqueues
    the reps, so a launch whose host side outlasts its kernel is timed by
    the device alone; without it, the time is paced by the host where the
    host is slower."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def stage_ms(torch, fn, reps: int = 3) -> dict:
    """Device ms per run of each span that reps runs of fn() open: the span
    table of profiling.device_trace (its device_ms over reps), keyed by the
    span name's last part ("parent", "grouping", "scan", "placement",
    "merge", "rescore", "distances", "hits", "shard_merge")."""
    from quake_tpu_torch import profiling

    with tempfile.TemporaryDirectory() as logdir, profiling.device_trace(logdir):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name.rsplit(".", 1)[-1]: row["device_ms"] / reps
            for name, row in profiling.last_spans().items() if name.startswith("quake.")}


def timed(torch, fn):
    """fn() on the host clock between two synchronizations of the card:
    (its result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def overlap(a, b) -> float:
    """Mean over rows of the share of b's winners (>= 0) that a also has
    (a row's winners are distinct); 1 for a row where neither has any."""
    import torch

    tot = 0.0
    step = max(1, (1 << 26) // max(a.shape[1] * b.shape[1], 1))
    for r0 in range(0, a.shape[0], step):
        ra, rb = a[r0:r0 + step], b[r0:r0 + step]
        hit = ((ra[:, :, None] == rb[:, None, :]).any(1) & (rb >= 0)).sum(1)
        nb = (rb >= 0).sum(1)
        row = torch.where(nb > 0, hit.float() / nb.clamp(min=1).float(),
                          ((ra >= 0).sum(1) == 0).float())
        tot += float(row.sum())
    return tot / max(a.shape[0], 1)


def exact_gt(torch, x_dev, q_dev, k: int, chunk: int = 1 << 18):
    """Exact l2 top-k ids by brute force on the card (f32, no TF32)."""
    best_s = best_i = None
    for c0 in range(0, x_dev.shape[0], chunk):
        xc = x_dev[c0:c0 + chunk]
        s = 2.0 * (q_dev @ xc.T) - (xc * xc).sum(1)[None, :]
        sv, si = torch.topk(s, k, dim=1)
        si = si + c0
        if best_s is not None:
            sv, j = torch.topk(torch.cat([best_s, sv], 1), k, dim=1)
            si = torch.gather(torch.cat([best_i, si], 1), 1, j)
        best_s, best_i = sv, si
    return best_i.cpu().numpy()


# ------------------------------------------------------------------ phases


def phase_small_parity(torch, dev):
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_plain
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  merge_positions, merge_positions_plain,
                                                  packed_params)

    rng = np.random.default_rng(0)
    P, C, Dm, Gn, qt, kk = 6, 256, 32, 24, 32, 10
    codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
    gp = torch.from_numpy(rng.integers(-1, P, Gn).astype(np.int32)).to(dev)
    sizes = torch.tensor([256, 200, 0, 17, 130, 256], dtype=torch.int32, device=dev)
    gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    slot_mult, levels = packed_params(C)
    scale = levels / 200.0
    qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32) * scale).to(dev)
    normsT = (((codes * codes).sum(-1) * 0.5 - 100.0) * scale).contiguous()
    k1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, gp, gsize.contiguous(),
                    qg, codes, normsT, kk, slot_mult, levels)
    for pool in (90, 256):
        keys = rng.integers(-1, 500, size=(500, pool)).astype(np.float32)
        keys[rng.random(keys.shape) < 0.4] = -1.0
        m_packed = np.where(keys >= 0, keys * 256 + rng.integers(0, 256, keys.shape), -1.0)
        k2 = compare_k2(torch, merge_positions, merge_positions_plain,
                        torch.from_numpy(m_packed.astype(np.float32)).to(dev), 10, 256)
    cb = torch.from_numpy(rng.standard_normal((384, Dm)).astype(np.float32)).to(dev)
    qb = torch.from_numpy(rng.standard_normal((500, Dm)).astype(np.float32)).to(dev)
    bias = (-(cb * cb).sum(1)).contiguous()
    bias[-20:] = float("-inf")
    k3 = compare_k3(torch, flat_topk, flat_topk_plain, cb, bias, qb, 16, "l2")
    log(f"[parity small] K1 overlap={k1[0]:.4f} max_key_diff={k1[1]}; K2 equal; "
        f"K3 overlap={k3[0]:.4f} max_key_diff={k3[1]}")
    # K4 at odd C and C % 128 == 0, K5 at C % 128 == 0: ghost groups, an empty
    # partition, one-lane rows, partitions below kk.
    worst = [1.0, 0.0, 0.0]
    for select, C in (("topk", 200), ("topk", 384), ("fold", 384)):
        codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
        norms = (codes * codes).sum(-1).contiguous()
        for qt, kk in ((8, 10), (64, 10), (8, 100), (64, 100)):
            sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], dtype=torch.int32, device=dev)
            gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
            qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32)).to(dev)
            slot_mult, levels = packed_params(C)
            for metric in ("l2", "ip"):
                r = compare_rowscale(torch, (gp, gsize.contiguous(), qg, codes, norms, kk,
                                             slot_mult, levels, metric, select))
                worst = [min(worst[0], r[0]), max(worst[1], r[1]), max(worst[2], r[2])]
    log(f"[parity small] K4/K5 (C in 200, 384; qt in 8, 64; kk in 10, 100; l2, ip): "
        f"min overlap={worst[0]:.4f} max_key_diff={worst[1]} max_stats_err={worst[2]:.3g}")
    phase_small_parity_tensor_core(torch, dev, rng)
    phase_small_parity_exact_chunked(torch, dev, rng, gp)
    phase_small_parity_variants(torch, dev, rng, gp)
    phase_small_parity_bf16(torch, dev, rng)
    phase_small_parity_fold(torch, dev, rng)


def phase_small_parity_fold(torch, dev, rng):
    """K1 and K5 at the folds of SMALL_FOLDS against their plain versions
    at the same fold, on C = FOLD_SMALL_C (which all of them divide): 200
    groups, ghosts, sizes that end in every fold block, kk 10 and 100 (past
    the 2 x 32 winners a row of fold 32 can give). K1 on its f32 tensor-core
    body (D = 128; also on the budget grid), its CUDA-core body (D = 30) and
    its bf16 bodies (D = 128 tensor cores, 100 CUDA cores); K5 on the same
    four. The launcher's body is asserted; the gates are compare_k1's and
    compare_rowscale's."""
    from quake_tpu_torch.ops.grouped_family import MMA_BODY, rowscale_fold_body
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  grouped_scan_uses_mma, packed_params)

    C, Gn = FOLD_SMALL_C, 200
    sizes_l = [0, 1, 128, 129, 300, 555, 700, 1000, 1300, C]
    slot_mult, levels = packed_params(C)
    sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
    worst = {}
    for qt, Dm, dt, tc in ((64, 128, torch.float32, True), (8, 30, torch.float32, False),
                           (64, 128, torch.bfloat16, True), (16, 100, torch.bfloat16, False)):
        codes = torch.from_numpy(rng.standard_normal((len(sizes_l), C, Dm)).astype(np.float32))
        codes = codes.to(dev).to(dt)
        cf = codes.float()
        norms = (cf * cf).sum(-1).contiguous()
        gp = torch.from_numpy(rng.integers(-1, len(sizes_l), Gn).astype(np.int32)).to(dev)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        scale = levels / (10.0 * Dm ** 0.5)
        q = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32)).to(dev)
        qs = (q * scale).to(dt).contiguous()
        normsT = ((norms * 0.5 - 0.5 * Dm - 5.0 * Dm ** 0.5) * scale).contiguous()
        where = f"qt={qt}, D={Dm}, {str(dt)[len('torch.'):]}"
        for fold in SMALL_FOLDS:
            for kk in (10, 100):
                if grouped_scan_uses_mma(qt, Dm, dt, fold, kk) != tc:
                    raise AssertionError(f"K1 at {where}, fold {fold}: the launcher chose "
                                         "another body than expected")
                kernels = [("K1", grouped_scan_kernel)]
                if tc and dt == torch.float32:
                    kernels.append(("K1 budget grid",
                                    functools.partial(grouped_scan_kernel, budget=True)))
                for what, kernel in kernels:
                    ov, kd = compare_k1(torch, kernel, grouped_scan_plain, gp, gsize, qs, codes,
                                        normsT, kk, slot_mult, levels, fold)
                    w = worst.setdefault(what, [1.0, 0.0])
                    worst[what] = [min(w[0], ov), max(w[1], kd)]
                if (rowscale_fold_body(qt, Dm, kk, dt, fold) == MMA_BODY) != tc:
                    raise AssertionError(f"K5 at {where}, fold {fold}: the launcher chose "
                                         "another body than expected")
                ov, kd, _ = compare_rowscale(torch, (gp, gsize, q.to(dt).contiguous(), codes,
                                                     norms, kk, slot_mult, levels, "l2", "fold"),
                                             fold=fold)
                w = worst.setdefault("K5", [1.0, 0.0])
                worst["K5"] = [min(w[0], ov), max(w[1], kd)]
    log(f"[parity small] folds {SMALL_FOLDS} on C = {C} (K1 and K5: f32 D 128 tensor cores, "
        f"D 30 CUDA cores, bf16 D 128 tensor cores and 100 CUDA cores; K1 also on the budget "
        f"grid; kk 10, 100): min overlap / max key diff " + json.dumps(worst))


def phase_small_parity_bf16(torch, dev, rng):
    """K1 on bf16 codes against its plain version: 300 groups, the
    segment-stressing sizes (ghosts, partial segments), kk 10, qt 8 and 64;
    D = 128 and 768 on the tensor-core body (768 streams the depth through
    the ring), D = 100 (rows not 16-byte aligned in bf16) on the CUDA-core
    body. The launcher's body is asserted; the gates are compare_k1's."""
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  grouped_scan_uses_mma, packed_params)

    C, Gn, kk = 512, 300, 10
    sizes_l = [0, 1, 127, 128, 129, C]
    worst = [1.0, 0.0]
    for qt, Dm in ((8, 128), (64, 128), (8, 100), (64, 100), (32, 768), (64, 768)):
        if grouped_scan_uses_mma(qt, Dm, torch.bfloat16) != (Dm % 8 == 0):
            raise AssertionError(f"K1 bf16 at qt={qt}, D={Dm}: the launcher chose another body "
                                 "than expected")
        codes = torch.from_numpy(rng.standard_normal((len(sizes_l), C, Dm)).astype(np.float32))
        codes = codes.to(dev).to(torch.bfloat16)
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
        gp = torch.from_numpy(rng.integers(-1, len(sizes_l), Gn).astype(np.int32)).to(dev)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        scale = levels / (10.0 * Dm ** 0.5)
        qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32) * scale)
        qg = qg.to(dev).to(torch.bfloat16).contiguous()
        cf = codes.float()
        normsT = (((cf * cf).sum(-1) * 0.5 - 0.5 * Dm - 5.0 * Dm ** 0.5) * scale).contiguous()
        ov, kd = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, gp, gsize, qg, codes,
                            normsT, kk, slot_mult, levels)
        worst = [min(worst[0], ov), max(worst[1], kd)]
    log(f"[parity small] K1 bf16 (D 128, 768 tensor cores; D 100 CUDA cores; qt 8-64): min "
        f"overlap={worst[0]:.4f} max key diff={worst[1]}")
    phase_small_parity_bf16_scans(torch, dev, rng)


def phase_small_parity_bf16_scans(torch, dev, rng):
    """The bf16 bodies of K3-K9, sized_topk and multi_topk against their
    plain versions (bf16 operands upcast, multiplied in f32) at the shapes
    that stress their tiles: 300 groups, sizes 0, 1, 127, 128, 129, 256,
    300 and all of a C = 520 that no segment divides (K5 and K7: C = 512,
    K7 in chunks of ct 128 and 256), qt 8-64, l2 and ip, kk 10 and 100 for
    K4 (its candidate buffer) and 10 and 33 for the sorted lists (insert_rows
    up to 32, merge_rows past it); D = 128 and 768 (a ring stage of bf16
    holds 128 columns whole, 768 in depth chunks) on the tensor-core bodies,
    D = 100 (D % 8 != 0) on the CUDA-core bodies, each launcher's body
    asserted; K4's chunk table (ct 128) on its CUDA-core body; K9 equal to
    the top kk of K8's scores, packed; K3 at N = 384 (scores kept) and
    2048 (two passes). The gates are the f32 ones."""
    from quake_tpu_torch.ops import flat_topk as ft
    from quake_tpu_torch.ops import grouped_chunked as gc
    from quake_tpu_torch.ops import grouped_exact as ge
    from quake_tpu_torch.ops import grouped_variants as gv
    from quake_tpu_torch.ops.grouped_family import (CHUNK_BODY, GROUP_BODY, MMA_BODY,
                                                    rowscale_fold_body, rowscale_topk_body)
    from quake_tpu_torch.ops.grouped_scan import packed_params

    bf, Gn, worst = torch.bfloat16, 300, {}

    def fold_in(what, r):
        w = worst.setdefault(what, [1.0, 0.0, 0.0])
        r = tuple(r) + (0.0,) * (3 - len(r))
        w[:] = [min(w[0], r[0])] + [max(a, b) for a, b in zip(w[1:], r[1:])]

    def store(C, Dm, sizes_l):
        codes = torch.from_numpy(rng.standard_normal((len(sizes_l), C, Dm)).astype(np.float32))
        codes = codes.to(dev).to(bf)
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
        lane = torch.arange(C, device=dev)[None, :]
        ids = torch.where(lane < sizes[:, None],
                          torch.arange(len(sizes_l) * C, dtype=torch.int32,
                                       device=dev).reshape(-1, C), -1).to(torch.int32)
        return codes, (codes.float() ** 2).sum(-1).contiguous(), sizes, ids.contiguous()

    for qt, Dm in ((8, 128), (64, 128), (32, 768), (8, 100), (64, 100)):
        tc = Dm % 8 == 0
        where = f"D={Dm} " + ("tensor cores" if tc else "CUDA cores")
        bodies = {
            "K4": (rowscale_topk_body(qt, Dm, 100, dtype=bf), MMA_BODY if tc else GROUP_BODY),
            "K5": (rowscale_fold_body(qt, Dm, 10, bf), MMA_BODY if tc else GROUP_BODY),
            "K6": (ge.exact_topk_body(qt, Dm, 33, bf), ge.MMA_BODY if tc else ge.GROUP_BODY),
            "K7": (gc.chunk_merge_body(qt, Dm, 33, bf), gc.MMA_BODY if tc else gc.GROUP_BODY),
            "K8": (gv.raw_scores_body(qt, Dm, bf), gv.MMA_BODY if tc else gv.CUDA_CORE_BODY),
            "K9": (gv.packed_topk_body(qt, Dm, 33, bf), gv.MMA_BODY if tc else gv.CUDA_CORE_BODY),
            "sized_topk": (gv.sized_topk_body(qt, Dm, 33, bf),
                           gv.MMA_BODY if tc else gv.CUDA_CORE_BODY),
            "multi_topk": (gv.multi_topk_body(qt, Dm, 33, bf),
                           gv.MMA_BODY if tc else gv.CUDA_CORE_BODY)}
        if Dm <= 128:
            bodies["K4 chunk table"] = (rowscale_topk_body(qt, Dm, 10, True, bf), CHUNK_BODY)
        wrong = {k: v for k, v in bodies.items() if v[0] != v[1]}
        if wrong:
            raise AssertionError(f"bf16 at qt={qt}, D={Dm}: the launchers chose other bodies "
                                 f"than expected (got, want): {wrong}")
        q = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32))
        q = q.to(dev).to(bf).contiguous()
        # C % 128 == 0: K5, and K7 in chunks of one and two segments.
        C = 512
        codes, norms, sizes, _ = store(C, Dm, [0, 1, 127, 128, 129, C, 256, 300])
        gp = torch.from_numpy(rng.integers(-1, 8, Gn).astype(np.int32)).to(dev)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        for metric in ("l2", "ip"):
            fold_in(f"K5, {where}", compare_rowscale(torch, (gp, gsize, q, codes, norms, 10,
                                                             slot_mult, levels, metric, "fold")))
            for ct in (128, 256):
                sm, lv = packed_params(ct)
                for kk in (10, 33):
                    args7 = (gp, gsize, q, codes, norms, kk, ct, sm, lv, metric)
                    fold_in(f"K7, {where}", compare_pairs(
                        torch, f"K7 bf16 ({where})", gc.chunk_merge(*args7),
                        gc.chunk_merge_plain(*args7), level=key_level(q, norms, lv, metric)))
        # C = 520: a partition's last segment reads the next one's rows.
        C = 520
        codes, norms, sizes, ids = store(C, Dm, [0, 1, 127, 128, 129, C, 256, 300])
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        for metric in ("l2", "ip"):
            for kk in (10, 100):
                fold_in(f"K4, {where}", compare_rowscale(
                    torch, (gp, gsize, q, codes, norms, kk, slot_mult, levels, metric, "topk")))
            if Dm <= 128:  # K4 with a chunk table of ct 128: 60 (partition, tile) groups
                G, ct = 60, 128
                maxch = -(-C // ct)
                pid = torch.from_numpy(rng.integers(-1, 8, G).astype(np.int32)).to(dev)
                cg_pid = pid.repeat_interleave(maxch).contiguous()
                chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(G)
                cg_size = torch.where(cg_pid >= 0,
                                      (sizes[cg_pid.clamp(min=0).long()] - chunk * ct).clamp(0, ct),
                                      torch.zeros_like(cg_pid)).contiguous()
                qsrc = torch.arange(G, dtype=torch.int32, device=dev).repeat_interleave(maxch)
                sm, lv = packed_params(ct)
                fold_in(f"K4 chunk table, {where}", compare_rowscale(
                    torch, (cg_pid, cg_size, q[:G].contiguous(), codes, norms, 10, sm, lv, metric,
                            "topk"),
                    qsrc=qsrc.contiguous(), row_off=(chunk * ct).contiguous(), ct=ct))
            raw = gv.raw_scores(gp, q, codes, ids, metric)
            raw_p = gv.raw_scores_plain(gp, q, codes, ids, metric)
            fold_in(f"K8, {where} (score error / tolerance)", (1.0, compare_raw(torch, raw, raw_p)))
            del raw
            for kk in (10, 33):
                ref, _ = k8_as_k9(torch, gp, q, codes, ids, kk, metric)
                fold_in(f"K9, {where}", compare_packed(
                    torch, gv.packed_topk(gp, q, codes, ids, kk, metric),
                    gv.packed_topk_plain(gp, q, codes, ids, kk, metric, chunk=64), ref, raw_p,
                    gv.slot_bits_of(C), exact=True))
                fold_in(f"sized_topk, {where} (score error)", compare_pairs(
                    torch, "sized_topk bf16", gv.sized_topk(gp, gsize, q, codes, kk, metric),
                    gv.sized_topk_plain(gp, gsize, q, codes, kk, metric), ties=True))
                fold_in(f"multi_topk, {where} (score error)", compare_pairs(
                    torch, "multi_topk bf16",
                    multi_slots(gv.multi_topk(gp, q, codes, ids, kk, metric, gb=4), C),
                    multi_slots(gv.multi_topk_plain(gp, q, codes, ids, kk, metric), C),
                    ties="up"))
                for mode, kw in (("slot", dict(group_size=gsize, norms=norms)),
                                 ("id", dict(ids=ids))):
                    fold_in(f"K6 ({mode}), {where} (score error)", compare_pairs(
                        torch, f"K6 bf16 ({mode})", ge.exact_scan(gp, q, codes, kk, metric, mode,
                                                                  **kw),
                        ge.exact_scan_plain(gp, q, codes, kk, metric, mode, **kw), ties=True))
            del raw_p
        # K3: the scores of a 64-query tile kept (N = 384) and two passes (N = 2048).
        qb = torch.from_numpy(rng.standard_normal((500, Dm)).astype(np.float32)).to(dev).to(bf)
        for N in (384, 2048):
            cb = torch.from_numpy(rng.standard_normal((N, Dm)).astype(np.float32)).to(dev).to(bf)
            want = (ft.KEPT_BODY if N <= 384 else ft.TWO_PASS_BODY) if tc else ft.CUDA_CORE_BODY
            if ft.flat_topk_body(N, Dm, bf) != want:
                raise AssertionError(f"K3 bf16 at N={N}, D={Dm}: body "
                                     f"{ft.flat_topk_body(N, Dm, bf)}, expected {want}")
            bias = (-(cb.float() ** 2).sum(1)).contiguous()
            bias[-20:] = float("-inf")
            for metric, bb in (("l2", bias), ("ip", torch.where(bias > float("-inf"), 0.0,
                                                                 bias).contiguous())):
                fold_in(f"K3, {where}", compare_k3(torch, ft.flat_topk, ft.flat_topk_plain, cb,
                                                   bb, qb, 16, metric))
    log("[parity small] the bf16 bodies of K3-K9, sized_topk and multi_topk (300 groups; qt 8-64; "
        "D 128, 768 tensor cores, D 100 CUDA cores; l2, ip): "
        + "; ".join(f"{what}: min overlap={w[0]:.4f} max_key_diff={w[1]} max_stats_err={w[2]:.3g}"
                    for what, w in worst.items()))


def phase_small_parity_tensor_core(torch, dev, rng):
    """K1, K4-K9, sized_topk and multi_topk at the shapes that stress the
    tensor-core bodies' tiles: 300 groups (more than blocks: every block
    walks several groups and loads across their borders), qt 8 and 64,
    partitions of 0, 1, 127, 128, 129 and all rows (K4, K6, K8, K9,
    sized_topk and multi_topk also 256 and 300 of a C = 520 that no segment
    divides, so a partition's last segment reads the next one's rows, and
    segments without an id; sized_topk with every row past a size poisoned; K7 the same sizes
    of C = 512 in chunks of ct 128 and 256; K5 those of K1's C = 512), kk 1,
    10 and 100 (K7 1 and 10), l2 and ip but for K1; D 24, 100 and 128 (a ring
    stage holds all of D) and D 200 and 256 (a stage holds a depth chunk of
    two or four boxes and the accumulator carries over the chunks). Each
    against the f32 plain version and, all but multi_topk, against the plain
    version on the split product's model, at the same tolerances; K9 also
    equal to the top kk of K8's scores, packed (k8_as_k9: at kk = 100, qt =
    64, K9 keeps its CUDA-core body). D = 30 (rows not 16-byte aligned) takes
    the CUDA-core bodies. K4's chunk table with ct 128 and 256, laid out as
    the v4 scan lays it, takes a CUDA-core body at every D and is held to the
    f32 plain version."""
    from quake_tpu_torch.ops import grouped_chunked as gc
    from quake_tpu_torch.ops import grouped_exact as ge
    from quake_tpu_torch.ops import grouped_variants as gv
    from quake_tpu_torch.ops.grouped_family import (CHUNK_BODY, GROUP_BODY, MMA_BODY,
                                                    rowscale_fold_body, rowscale_topk_body)
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  grouped_scan_uses_mma, packed_params)
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    Gn = 300
    # worst[what] = [min overlap, max key difference of common winners, stats]
    worst = {}
    models = (("f32", False), ("split", True))

    def store(C, Dm, sizes_l):
        P = len(sizes_l)
        codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device=dev)
        return codes, (codes * codes).sum(-1).contiguous(), sizes

    def fold_in(what, r):
        w = worst.setdefault(what, [1.0, 0.0, 0.0])
        r = tuple(r) + (0.0,) * (3 - len(r))
        w[:] = [min(w[0], r[0])] + [max(a, b) for a, b in zip(w[1:], r[1:])]

    # (qt, D, the body a chunk table takes; None: no CUDA-core body fits it)
    for qt, Dm, chunk_body in ((8, 24, CHUNK_BODY), (8, 100, CHUNK_BODY), (8, 128, CHUNK_BODY),
                               (64, 24, CHUNK_BODY), (64, 100, CHUNK_BODY),
                               (64, 128, CHUNK_BODY), (8, 256, GROUP_BODY),
                               (64, 200, GROUP_BODY), (64, 256, None), (32, 30, CHUNK_BODY)):
        tensor_cores = Dm % 4 == 0
        shape = "one stage" if Dm <= 128 else "depth chunks"
        if (grouped_scan_uses_mma(qt, Dm) != tensor_cores
                or rowscale_topk_body(qt, Dm, 100) != (MMA_BODY if tensor_cores else GROUP_BODY)
                or rowscale_topk_body(qt, Dm, 100, chunked=True) != (chunk_body or GROUP_BODY)
                or gc.chunk_merge_body(qt, Dm, 10) != (gc.MMA_BODY if tensor_cores
                                                       else gc.GROUP_BODY)
                or gv.multi_topk_body(qt, Dm, 10) != (gv.MMA_BODY if tensor_cores
                                                      else gv.CUDA_CORE_BODY)
                or gv.packed_topk_body(qt, Dm, 10) != (gv.MMA_BODY if tensor_cores
                                                       else gv.CUDA_CORE_BODY)
                or gv.raw_scores_body(qt, Dm) != (gv.MMA_BODY if tensor_cores
                                                  else gv.CUDA_CORE_BODY)
                or gv.sized_topk_body(qt, Dm, 10) != (gv.MMA_BODY if tensor_cores
                                                      else gv.CUDA_CORE_BODY)
                or rowscale_fold_body(qt, Dm, 100) != (MMA_BODY if tensor_cores else GROUP_BODY)
                or ge.exact_topk_body(qt, Dm, 10) != (ge.MMA_BODY if tensor_cores
                                                      else ge.GROUP_BODY)):
            raise AssertionError(f"qt={qt}, D={Dm}: the launchers chose other bodies than expected")
        # K1: C % 128 == 0.
        C = 512
        codes, norms, sizes = store(C, Dm, [0, 1, 127, 128, 129, C])
        gp = torch.from_numpy(rng.integers(-1, 6, Gn).astype(np.int32)).to(dev)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        scale = levels / (10.0 * Dm ** 0.5)
        q = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32)).to(dev)
        normsT = ((norms * 0.5 - 0.5 * Dm - 5.0 * Dm ** 0.5) * scale).contiguous()
        for kk in (1, 10, 100):
            for m, model in models if tensor_cores else models[:1]:
                r = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, gp, gsize,
                               (q * scale).contiguous(), codes, normsT, kk, slot_mult, levels,
                               model=model)
                fold_in(f"K1, {shape}, {m} product" if tensor_cores else "K1, D=30", r)
        # K5 on K1's store (C % 128 == 0), unscaled queries.
        for kk in (1, 10, 100):
            for metric in ("l2", "ip"):
                for m, model in models if tensor_cores else models[:1]:
                    r = compare_rowscale(torch, (gp, gsize, q, codes, norms, kk, slot_mult,
                                                 levels, metric, "fold"), model=model)
                    fold_in(f"K5, {shape}, {m} product" if tensor_cores else "K5, D=30", r)
        # K4: a C that no segment divides, groups of one, two and more segments.
        C = 520
        codes, norms, sizes = store(C, Dm, [0, 1, 127, 128, 129, C, 256, 300])
        gp = torch.from_numpy(rng.integers(-1, 8, Gn).astype(np.int32)).to(dev)
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        slot_mult, levels = packed_params(C)
        for kk in (1, 10, 100):
            for metric in ("l2", "ip"):
                for m, model in models if tensor_cores else models[:1]:
                    r = compare_rowscale(torch, (gp, gsize, q, codes, norms, kk, slot_mult,
                                                 levels, metric, "topk"), model=model)
                    fold_in(f"K4, {shape}, {m} product" if tensor_cores else "K4, D=30", r)
        # K4 with a chunk table: 60 (partition, tile) groups of maxch chunks each.
        G = 60
        pid = torch.from_numpy(rng.integers(-1, 8, G).astype(np.int32)).to(dev)
        for ct in (128, 256) if chunk_body is not None else ():
            maxch = -(-C // ct)
            cg_pid = pid.repeat_interleave(maxch).contiguous()
            chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(G)
            cg_size = torch.where(cg_pid >= 0,
                                  (sizes[cg_pid.clamp(min=0).long()] - chunk * ct).clamp(0, ct),
                                  torch.zeros_like(cg_pid)).contiguous()
            qsrc = torch.arange(G, dtype=torch.int32, device=dev).repeat_interleave(maxch)
            slot_mult_c, levels_c = packed_params(ct)
            for kk in (1, 10, 100):
                for metric in ("l2", "ip"):
                    r = compare_rowscale(
                        torch, (cg_pid, cg_size, q[:G].contiguous(), codes, norms, kk,
                                slot_mult_c, levels_c, metric, "topk"),
                        qsrc=qsrc.contiguous(), row_off=(chunk * ct).contiguous(), ct=ct)
                    fold_in("K4 with a chunk table, " + ("the persistent body"
                                                         if chunk_body == CHUNK_BODY
                                                         else "one block a group"), r)
        # multi_topk on K4's store (the lanes past a partition's size hold no
        # id), where it serves the shape (multi_topk_serves).
        lane = torch.arange(C, device=dev)[None, :]
        ids = torch.where(lane < sizes[:, None],
                          torch.arange(codes.shape[0] * C, dtype=torch.int32,
                                       device=dev).reshape(-1, C),
                          torch.full_like(codes[:, :, 0], -1, dtype=torch.int32)).contiguous()
        for kk in (1, 10, 100) if gv.multi_topk_serves(qt, Dm, 100) else ():
            for metric in ("l2", "ip"):
                r = compare_pairs(
                    torch, "multi_topk",
                    multi_slots(gv.multi_topk(gp, q, codes, ids, kk, metric, gb=4), C),
                    multi_slots(gv.multi_topk_plain(gp, q, codes, ids, kk, metric), C), ties="up")
                fold_in(f"multi_topk, {shape} (score error)" if tensor_cores
                        else "multi_topk, D=30 (score error)", r)
        # K8 and K9 on the same store: every score, against the plain version
        # (f32, and on the split product's model where K8 runs the tensor
        # cores); the top kk packed, equal to the top kk of K8's scores in the
        # arithmetic of the body K9 ran, packed.
        for metric in ("l2", "ip"):
            raw = gv.raw_scores(gp, q, codes, ids, metric)
            raw_p = {}
            for m, model in models if tensor_cores else models[:1]:
                with bmm_as_split_product() if model else contextlib.nullcontext():
                    raw_p[m] = gv.raw_scores_plain(gp, q, codes, ids, metric)
                fold_in(f"K8, {shape}, {m} product (score error / tolerance)" if tensor_cores
                        else "K8, D=30 (score error / tolerance)",
                        (1.0, compare_raw(torch, raw, raw_p[m])))
            del raw
            for kk in (k for k in (1, 10, 100) if gv.packed_topk_serves(qt, Dm, k)):
                got = gv.packed_topk(gp, q, codes, ids, kk, metric)
                ref, body = k8_as_k9(torch, gp, q, codes, ids, kk, metric)
                for m, model in models if body == gv.MMA_BODY else models[:1]:
                    with bmm_as_split_product() if model else contextlib.nullcontext():
                        # chunk=64: raw_scores_plain's batches, so that raw_p holds
                        # the very scores this plain version packs.
                        want = gv.packed_topk_plain(gp, q, codes, ids, kk, metric, chunk=64)
                    r = compare_packed(torch, got, want, ref, raw_p[m], gv.slot_bits_of(C),
                                       exact=not model)
                    fold_in(f"K9, body {body}, {shape if tensor_cores else 'D=30'}, {m} product",
                            r)
        # sized_topk on the same store, every row past a size poisoned with
        # 999, +inf or NaN (the tensor-core body loads the segment that holds
        # the size-th row whole), equal scores by the larger slot. It serves
        # the shapes multi_topk does: the same two bodies' buffers
        # (multi_topk_serves).
        poisoned = codes.clone()
        for p, size in enumerate(sizes.tolist()):
            poisoned[p, size:] = (999.0, float("inf"), float("nan"))[p % 3]
        for kk in (k for k in (1, 10, 100) if gv.multi_topk_serves(qt, Dm, k)):
            for metric in ("l2", "ip"):
                got = gv.sized_topk(gp, gsize, q, poisoned, kk, metric)
                for m, model in models if tensor_cores else models[:1]:
                    with bmm_as_split_product() if model else contextlib.nullcontext():
                        want = gv.sized_topk_plain(gp, gsize, q, poisoned, kk, metric)
                    r = compare_pairs(torch, f"sized_topk ({m} product)", got, want, ties=True)
                    fold_in(f"sized_topk, {shape}, {m} product (score error)" if tensor_cores
                            else "sized_topk, D=30 (score error)", r)
        del poisoned
        # K6 in both modes on the same store, equal scores by the larger index.
        for kk in (k for k in (1, 10, 100) if ge.exact_topk_serves(qt, Dm, k)):
            for metric in ("l2", "ip"):
                for mode, kw in (("slot", dict(group_size=gsize, norms=norms)),
                                 ("id", dict(ids=ids))):
                    got = ge.exact_scan(gp, q, codes, kk, metric, mode, **kw)
                    for m, model in models if tensor_cores else models[:1]:
                        with bmm_as_split_product() if model else contextlib.nullcontext():
                            want = ge.exact_scan_plain(gp, q, codes, kk, metric, mode, **kw)
                        r = compare_pairs(torch, f"K6 ({mode}, {m} product)", got, want,
                                          ties=True)
                        fold_in(f"K6, {shape}, {m} product (score error)" if tensor_cores
                                else "K6, D=30 (score error)", r)
        # K7: chunks of one and of two segments; C = 512 keeps C % ct == 0.
        C = 512
        codes, norms, sizes = store(C, Dm, [0, 1, 127, 128, 129, C, 256, 300])
        gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                            torch.zeros_like(gp)).contiguous()
        for ct in (128, 256):
            slot_mult, levels = packed_params(ct)
            for kk in (1, 10):
                for metric in ("l2", "ip"):
                    args7 = (gp, gsize, q, codes, norms, kk, ct, slot_mult, levels, metric)
                    got = gc.chunk_merge(*args7)
                    for m, model in models if tensor_cores else models[:1]:
                        with bmm_as_split_product() if model else contextlib.nullcontext():
                            want = gc.chunk_merge_plain(*args7)
                        r = compare_pairs(torch, f"K7 ({m} product)", got, want,
                                          level=key_level(q, norms, levels, metric))
                        fold_in(f"K7, {shape}, {m} product (score error)" if tensor_cores
                                else "K7, D=30 (score error)", r)
    log("[parity small] K1, K4-K9, sized_topk and multi_topk at the tile-stressing shapes (300 "
        "groups; qt in 8, 64; sizes 0, 1, 127, 128, 129, full; kk in 1, 10, 100; l2, ip; one "
        "stage: D in 24, 100, 128; depth chunks: D in 200, 256; K7 with ct in 128, 256; K4's chunk "
        "tables with ct in 128, 256 on the CUDA cores): "
        + "; ".join(f"{what}: min overlap={w[0]:.4f} max_key_diff={w[1]} max_stats_err={w[2]:.3g}"
                    for what, w in worst.items()))


def phase_small_parity_variants(torch, dev, rng, gp):
    """K8, K9, sized_topk and multi_topk at small shapes: odd C, ghost
    groups, an empty partition, partitions below one segment and below kk,
    kk = 1 and kk > 32, a tile height that does not divide C, a gb that does
    not divide the group count (the groups are padded with ghosts, as the
    entry point pads them), and, for multi_topk, copies of one vector, whose
    equal scores must come out by the smaller slot."""
    from quake_tpu_torch.ops.grouped_variants import (multi_topk, multi_topk_plain, packed_topk,
                                                      packed_topk_plain, raw_scores,
                                                      raw_scores_plain, sized_topk,
                                                      sized_topk_plain, slot_bits_of)
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    P, Dm, Gn = 6, 32, gp.shape[0]
    worst = dict(raw=0.0, raw_model=0.0, packed=[1.0, 0], sized=[1.0, 0.0], multi=[1.0, 0.0])
    k9_bodies = set()
    for C, ct, gb in ((200, 64, 5), (384, 256, 7), (512, 128, 8)):
        codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
        dup = codes.clone()
        dup[0, 5::2] = dup[0, 5]  # copies of one vector
        ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
        lane = torch.arange(C, device=dev)[None, :]
        pad = -Gn % gb
        gpm = torch.nn.functional.pad(gp, (0, pad), value=-1).contiguous()
        for qt, kk in ((8, 1), (64, 10), (8, 40), (64, 100)):
            sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], dtype=torch.int32, device=dev)
            gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                                torch.zeros_like(gp)).contiguous()
            sids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
            qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32)).to(dev)
            qgm = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, pad)).contiguous()
            for metric in ("l2", "ip"):
                raw = raw_scores(gp, qg, dup, sids, metric)
                raw_p = raw_scores_plain(gp, qg, dup, sids, metric)
                worst["raw"] = max(worst["raw"], compare_raw(torch, raw, raw_p))
                with bmm_as_split_product():
                    raw_m = raw_scores_plain(gp, qg, dup, sids, metric)
                worst["raw_model"] = max(worst["raw_model"], compare_raw(torch, raw, raw_m))
                got = packed_topk(gp, qg, dup, sids, kk, metric)
                ref, body = k8_as_k9(torch, gp, qg, dup, sids, kk, metric)
                k9_bodies.add((qt, kk, body))
                r = compare_packed(torch, got,
                                   packed_topk_plain(gp, qg, dup, sids, kk, metric, chunk=64),
                                   ref, raw_p, slot_bits_of(C), exact=True)
                worst["packed"] = [min(worst["packed"][0], r[0]), max(worst["packed"][1], r[1])]
                r = compare_pairs(torch, "sized_topk",
                                  sized_topk(gp, gsize, qg, codes, kk, metric, ct=ct),
                                  sized_topk_plain(gp, gsize, qg, codes, kk, metric, ct=ct))
                worst["sized"] = [min(worst["sized"][0], r[0]), max(worst["sized"][1], r[1])]
                r = compare_pairs(torch, "multi_topk",
                                  multi_slots(multi_topk(gpm, qgm, dup, sids, kk, metric, gb=gb), C),
                                  multi_slots(multi_topk_plain(gpm, qgm, dup, sids, kk, metric), C),
                                  ties="up")
                worst["multi"] = [min(worst["multi"][0], r[0]), max(worst["multi"][1], r[1])]
    log(f"[parity small] K8 (C in 200, 384, 512; qt in 8, 64; l2, ip): max score error / "
        f"tolerance {worst['raw']:.3g} against the f32 plain version, {worst['raw_model']:.3g} "
        f"against it on the split product's model (rtol = atol = {SCORE_TOL}); K9 (kk in 1, 10, "
        f"40, 100): min overlap={worst['packed'][0]:.4f} max_key_diff={worst['packed'][1]}, equal "
        f"to the top-kk of K8's scores packed, on the bodies (qt, kk, body) "
        f"{sorted(k9_bodies)}; sized_topk (ct in 64, 256, 128): min overlap="
        f"{worst['sized'][0]:.4f} max_score_err={worst['sized'][1]:.3g}; multi_topk (gb in 5, 7, "
        f"8): min overlap={worst['multi'][0]:.4f} max_score_err={worst['multi'][1]:.3g}")


def multi_slots(out, C: int):
    """multi_topk's (scores, slots) with its empty sentinel C as -1."""
    s, i = out
    return s, i.masked_fill(i >= C, -1)


def compare_raw(torch, got, want, step: int = 128) -> float:
    """K8 against its plain version: the same -inf lanes, scores within
    rtol = atol = SCORE_TOL (f32 dot products summed in another order).
    Returns the worst error / tolerance."""
    torch.cuda.synchronize()
    worst = 0.0
    for g0 in range(0, got.shape[0], step):
        g, w = got[g0:g0 + step], want[g0:g0 + step]
        if not bool((torch.isneginf(g) == torch.isneginf(w)).all()):
            raise AssertionError("K8: the -inf lanes differ from the plain version's")
        ok = ~torch.isneginf(w)
        if bool(ok.any()):
            worst = max(worst, float(((g[ok] - w[ok]).abs()
                                      / (SCORE_TOL + SCORE_TOL * w[ok].abs())).max()))
    if worst > 1.0:
        raise AssertionError(f"K8 disagrees with its plain version: worst score error / "
                             f"tolerance {worst}")
    return worst


def k8_as_k9(torch, gp, qg, codes, ids, kk: int, metric: str):
    """K8's scores in the arithmetic of the body K9 runs at this shape, and
    that body. Where both launchers pick one body, K8 itself: the two compute
    their scores by one code in one order. Where K9 keeps its CUDA-core body
    (its lists crowd out the ring) and K8 takes the tensor cores, K8 on the
    same inputs with the depth padded by a zero column to a D % 4 != 0: its
    CUDA-core body then sums the same terms in the same order, plus zero
    terms (fmaf(0, 0, a) = a), as K9's CUDA-core body does."""
    from quake_tpu_torch.ops.grouped_variants import packed_topk_body, raw_scores, raw_scores_body

    qt, Dm = qg.shape[1], qg.shape[2]
    body = packed_topk_body(qt, Dm, kk, codes.dtype)
    if raw_scores_body(qt, Dm, codes.dtype) == body:
        return raw_scores(gp, qg, codes, ids, metric), body
    if raw_scores_body(qt, Dm + 1, codes.dtype) != body:
        raise AssertionError(f"K8 at D={Dm + 1} does not run K9's body {body}")
    qg1, codes1 = (torch.nn.functional.pad(t, (0, 1)).contiguous() for t in (qg, codes))
    return raw_scores(gp, qg1, codes1, ids, metric), body


def compare_packed(torch, got, want, raw, raw_p, slot_bits: int, exact: bool = False,
                   step: int = 128):
    """K9 against its plain version. raw: K8's scores in the arithmetic of
    the body K9 ran (k8_as_k9); raw_p: the scores the plain version packed
    (raw_scores_plain with packed_topk_plain's chunk of groups: cuBLAS may
    sum another batch of groups in another order). The packed
    value carries the top bits of the score's bit pattern, which the other
    order of summation moves in the last place, so: as many winners per row,
    descending, winner overlap >= OVERLAP_TOL, and every winner both sides
    share whose scores agree bit for bit carries the same packed value. With
    exact, the kernel's output must also equal the top kk of raw, packed
    (`step` groups at a time). Returns (overlap, max key difference of the
    shared winners)."""
    from quake_tpu_torch.ops.grouped_variants import pack_scores

    torch.cuda.synchronize()
    kk = got.shape[-1]
    mask = (1 << slot_bits) - 1
    if not bool(((got >= 0) == (want >= 0)).all()) or not bool((got >= -1).all()):
        raise AssertionError("K9: winners per row differ from the plain version's")
    if not bool((torch.diff(got, dim=-1)[got[..., 1:] >= 0] < 0).all()):
        raise AssertionError("K9: packed values are not strictly descending")
    gl, wl = (torch.where(t >= 0, t & mask, torch.full_like(t, -1)) for t in (got, want))
    ov = overlap(gl.reshape(-1, kk), wl.reshape(-1, kk))
    max_kd, step = 0, max(1, (1 << 22) // max(kk * kk * got.shape[1], 1))
    for g0 in range(0, got.shape[0], step):
        sl = slice(g0, g0 + step)
        same = (gl[sl][..., :, None] == wl[sl][..., None, :]) & (gl[sl][..., :, None] >= 0)
        pos = torch.nonzero(same)
        if pos.numel() == 0:
            continue
        g_, r_, a_, b_ = pos.unbind(1)
        gv, wv = got[sl][g_, r_, a_], want[sl][g_, r_, b_]
        lanes = (gv & mask).long()
        bitwise = raw[sl][g_, r_, lanes] == raw_p[sl][g_, r_, lanes]
        if not bool((gv[bitwise] == wv[bitwise]).all()):
            raise AssertionError("K9: a winner whose score both sides agree on bit for bit "
                                 "carries another packed value")
        max_kd = max(max_kd, int(((gv >> slot_bits) - (wv >> slot_bits)).abs().max()))
    for g0 in range(0, got.shape[0], step) if exact else ():
        r = raw[g0:g0 + step]
        ref = torch.where(torch.isneginf(r), -1, pack_scores(r, slot_bits))
        if not torch.equal(torch.topk(ref, kk, dim=2).values, got[g0:g0 + step]):
            raise AssertionError("K9 is not the top kk of K8's scores, packed")
    if ov < OVERLAP_TOL:
        raise AssertionError(f"K9 disagrees with its plain version: overlap {ov}")
    return ov, max_kd


def phase_small_parity_exact_chunked(torch, dev, rng, gp):
    """K4 with a chunk table, K6 in both modes and K7 at small shapes: odd C,
    ghost groups, an empty partition, partitions below kk and ending inside
    a chunk, kk = 1 and kk > 32, and copies of one vector, whose scores tie
    bit for bit and must come out in the kernel's order (the larger slot or
    id first)."""
    from quake_tpu_torch.ops.grouped_chunked import chunk_merge, chunk_merge_plain
    from quake_tpu_torch.ops.grouped_exact import exact_scan, exact_scan_plain
    from quake_tpu_torch.ops.grouped_scan import packed_params

    P, Dm, Gn = 6, 32, gp.shape[0]
    worst4, worst6, worst7 = [1.0, 0.0, 0.0], [1.0, 0.0], [1.0, 0.0]
    for C, ct in ((200, 100), (384, 128), (512, 256)):
        codes = torch.from_numpy(rng.standard_normal((P, C, Dm)).astype(np.float32)).to(dev)
        codes[0, 5::2] = codes[0, 5]  # copies of one vector
        codes[1, 10] = codes[1, 90]
        norms = (codes * codes).sum(-1).contiguous()
        ids = torch.from_numpy(rng.permutation(P * C).astype(np.int32).reshape(P, C)).to(dev)
        lane = torch.arange(C, device=dev)[None, :]
        maxch = C // ct
        for qt, kk in ((8, 1), (64, 10), (8, 40), (64, 100)):
            sizes = torch.tensor([C, C - 70, 0, 1, kk // 2, 150], dtype=torch.int32, device=dev)
            gsize = torch.where(gp >= 0, sizes[gp.clamp(min=0).long()],
                                torch.zeros_like(gp)).contiguous()
            sids = torch.where(lane < sizes[:, None], ids, torch.full_like(ids, -1)).contiguous()
            qg = torch.from_numpy(rng.standard_normal((Gn, qt, Dm)).astype(np.float32)).to(dev)
            slot_mult, levels = packed_params(ct)
            # One K4 group per (group, chunk); the chunks of a group share its tile.
            cg_pid = gp.repeat_interleave(maxch).contiguous()
            chunk = torch.arange(maxch, dtype=torch.int32, device=dev).repeat(Gn)
            cg_size = torch.where(cg_pid >= 0,
                                  (gsize.repeat_interleave(maxch) - chunk * ct).clamp(0, ct),
                                  torch.zeros_like(cg_pid)).contiguous()
            qsrc = torch.arange(Gn, dtype=torch.int32, device=dev).repeat_interleave(maxch)
            for metric in ("l2", "ip"):
                r = compare_rowscale(torch, (cg_pid, cg_size, qg, codes, norms, min(kk, ct),
                                             slot_mult, levels, metric, "topk"),
                                     qsrc=qsrc.contiguous(), row_off=(chunk * ct).contiguous(),
                                     ct=ct)
                worst4 = [min(worst4[0], r[0]), max(worst4[1], r[1]), max(worst4[2], r[2])]
                for mode, kw in (("slot", dict(group_size=gsize, norms=norms)),
                                 ("id", dict(ids=sids))):
                    r = compare_pairs(torch, f"K6 ({mode})",
                                      exact_scan(gp, qg, codes, kk, metric, mode, **kw),
                                      exact_scan_plain(gp, qg, codes, kk, metric, mode, **kw),
                                      ties=True)
                    worst6 = [min(worst6[0], r[0]), max(worst6[1], r[1])]
                # K7 keeps three more lists of kk pairs per row: 64 rows fit up to kk = 64.
                args7 = (gp, gsize, qg, codes, norms, min(kk, ct, 512 // qt * 8), ct, slot_mult,
                         levels, metric)
                r = compare_pairs(torch, "K7", chunk_merge(*args7), chunk_merge_plain(*args7),
                                  level=key_level(qg, norms, levels, metric))
                worst7 = [min(worst7[0], r[0]), max(worst7[1], r[1])]
    log(f"[parity small] K4 with a chunk table (C, ct in (200, 100), (384, 128), (512, 256); qt "
        f"in 8, 64; kk in 1, 10, 40, 100; l2, ip): min overlap={worst4[0]:.4f} "
        f"max_key_diff={worst4[1]} max_stats_err={worst4[2]:.3g}")
    log(f"[parity small] K6 (slot and id, C in 200, 384, 512, same qt and kk): min overlap="
        f"{worst6[0]:.4f} max_score_err={worst6[1]:.3g}; K7 (same C and ct, kk 64 for 100 at qt "
        f"64): min overlap="
        f"{worst7[0]:.4f} max_score_err={worst7[1]:.3g} (scores rtol = atol = {SCORE_TOL}, K7's "
        f"atol plus one key level)")


def key_level(qg, norms, levels: int, metric: str) -> float:
    """Upper bound on one quantization level of any row of a per-row-scale
    scan: (largest possible score range) / levels, from |<q, x>| <= |q| |x|."""
    qg = qg.float()
    qmax = float((qg * qg).sum(-1).max().sqrt())
    xmax = float(norms.max().sqrt())
    span = 4.0 * qmax * xmax + xmax * xmax if metric == "l2" else 2.0 * qmax * xmax
    return span / levels


def compare_pairs(torch, what, got, want, ties=False, level=0.0):
    """K6 or K7 against its plain version: as many winners per row with
    -inf / -1 tails, descending scores, scores rank by rank within
    rtol = SCORE_TOL and atol = SCORE_TOL + level (K7: one quantization
    level), winner overlap; with ties, runs of equal scores must come out
    index-descending (ties="up": index-ascending). Returns (overlap, max abs
    score error)."""
    (gs, gi), (ws, wi) = got, want
    torch.cuda.synchronize()
    kk = gi.shape[-1]
    if not (bool(((gi >= 0) == (wi >= 0)).all()) and bool((torch.isneginf(gs) == (gi < 0)).all())):
        raise AssertionError(f"{what}: winners per row, or the -inf / -1 tails, differ from the "
                             "plain version's")
    step = torch.diff(gs, dim=-1)  # nan where -inf follows -inf
    if not bool((step[~torch.isnan(step)] <= 0).all()):
        raise AssertionError(f"{what}: scores are not descending")
    if ties:
        run = torch.diff(gi, dim=-1)[(step == 0) & (gi[..., 1:] >= 0)]
        if not bool((run > 0).all() if ties == "up" else (run < 0).all()):
            raise AssertionError(f"{what}: equal scores must order by the "
                                 f"{'smaller' if ties == 'up' else 'larger'} index")
    ok = wi >= 0
    diff = (gs[ok] - ws[ok]).abs()
    err = float(diff.max()) if bool(ok.any()) else 0.0
    worst = (float((diff / (SCORE_TOL + level + SCORE_TOL * ws[ok].abs())).max())
             if bool(ok.any()) else 0.0)
    ov = overlap(gi.reshape(-1, kk), wi.reshape(-1, kk))
    if worst > 1.0 or ov < OVERLAP_TOL:
        raise AssertionError(f"{what} disagrees with its plain version: overlap {ov}, worst "
                             f"score error / tolerance {worst} (max abs {err})")
    return ov, err


def compare_rowscale(torch, args, model=False, fold=128, term_scale=False, **chunk_table):
    """K4 or K5 (args[-1] selects; chunk_table = K4's qsrc, row_off and ct;
    K5 at fold width `fold`) against its plain version (model: run on
    ops/split_product.py's model of the tensor-core product instead of the
    f32 one): winner overlap, key difference of common winners, ghost
    groups, stats (rowmin and range at rtol = atol = STATS_TOL; with
    term_scale, rtol counts against the row's product term as well, |q| x
    the largest |x| of the group's valid lanes, doubled for l2: another
    order of summation moves a score by a share of that term, and an l2
    score near 0 is a small difference of large terms)."""
    from quake_tpu_torch.ops.grouped_family import rowscale_scan, rowscale_scan_plain
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    gsize, kk, slot_mult, select = args[1], args[5], args[6], args[-1]
    what = ("K4" if select == "topk" else "K5") + (" (chunk table)" if chunk_table else "")
    got, got_stats = rowscale_scan(*args, fold=fold, **chunk_table)
    with bmm_as_split_product() if model else contextlib.nullcontext():
        want, want_stats = rowscale_scan_plain(*args, fold=fold, **chunk_table)
    torch.cuda.synchronize()
    alive = gsize > 0
    ghost_ok = (bool((got[~alive] == -1).all()) and bool((got_stats[~alive][:, :, 0] == 0).all())
                and bool((got_stats[~alive][:, :, 1] == np.float32(1e-20)).all()))
    if not ghost_ok:
        raise AssertionError(f"{what}: ghost groups must write -1 and stats (0, 1e-20)")
    mag = want_stats.abs()
    if term_scale:
        gp, qg, norms, metric = args[0], args[2], args[4], args[8]
        lane = torch.arange(norms.shape[1], device=norms.device)
        pn = norms[gp.clamp(min=0).long()]
        maxx = torch.sqrt(torch.where(lane[None, :] < gsize[:, None].long(), pn,
                                      torch.zeros_like(pn)).amax(1))
        term = (2.0 if metric == "l2" else 1.0) * qg.float().norm(dim=2) * maxx[:, None]
        mag = mag + term[..., None]
    err = (got_stats - want_stats).abs() / (STATS_TOL + STATS_TOL * mag)
    stats_err = float(err.max())
    if stats_err > 1.0:
        worst = int(err.reshape(-1).argmax())
        raise AssertionError(f"{what}: stats beyond rtol = atol = {STATS_TOL} "
                             f"(worst error / tolerance {stats_err}, at "
                             f"{('rowmin', 'range')[worst % 2]} {want_stats.reshape(-1)[worst]}"
                             f" against {got_stats.reshape(-1)[worst]})")
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    lanes = [torch.where(t >= 0, torch.remainder(t, slot_mult), torch.full_like(t, -1))
             for t in (g, w)]
    ov = overlap(lanes[0], lanes[1])
    same = (lanes[0] == lanes[1]) & (lanes[0] >= 0)
    kd = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    max_kd = float(kd[same].max()) if bool(same.any()) else 0.0
    if ov < OVERLAP_TOL or max_kd > 1.0:
        raise AssertionError(f"{what} disagrees with its plain version: overlap {ov}, "
                             f"key difference {max_kd}")
    max_abs = float((got_stats - want_stats).abs().max())
    return ov, max_kd, max_abs


def compare_k1(torch, kernel, plain, gp, gsize, qg, codes, normsT, kk, slot_mult, levels,
               fold=128, model=False):
    """K1 at fold width `fold` against its plain version (model: as in
    compare_rowscale)."""
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    got = kernel(gp, gsize, qg, codes, normsT, kk, slot_mult, levels, fold)
    with bmm_as_split_product() if model else contextlib.nullcontext():
        want = plain(gp, gsize, qg, codes, normsT, kk, slot_mult, levels, fold)
    torch.cuda.synchronize()
    alive = gsize > 0
    if not bool((got[~alive] == -1).all()):
        raise AssertionError("K1: ghost groups must be all -1")
    g, w = got[alive].reshape(-1, kk), want[alive].reshape(-1, kk)
    lanes = [torch.where(t >= 0, torch.remainder(t, slot_mult), torch.full_like(t, -1))
             for t in (g, w)]
    ov = overlap(lanes[0], lanes[1])
    both = (g >= 0) & (w >= 0)
    kd = (torch.floor(g / slot_mult) - torch.floor(w / slot_mult)).abs()
    max_kd = float(kd[both].max()) if bool(both.any()) else 0.0
    same = (lanes[0] == lanes[1]) & (lanes[0] >= 0)
    same_kd = float(kd[same].max()) if bool(same.any()) else 0.0
    if ov < OVERLAP_TOL or same_kd > 1.0:
        raise AssertionError(f"K1 disagrees with its plain version: overlap {ov}, key "
                             f"difference of common winners {same_kd}")
    return ov, max_kd


def compare_k2(torch, kernel, plain, m_packed, kfin, slot_mult):
    got = kernel(m_packed, kfin, slot_mult)
    want = plain(m_packed, kfin, slot_mult)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 disagrees with its plain version (must be equal)")
    return 0.0


def float_bits(torch, t):
    """A tensor as integers: floats by their bit patterns, so that equality
    holds to every bit (signed zeros and NaNs included)."""
    if t.is_floating_point():
        return t.reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t


def compare_grouping(torch, args) -> dict:
    """The grouping kernels (group_tables_kernel: group_count, group_scan,
    group_scatter, group_tables) against their plain version on the same
    card tensors: every output (gp, group_size, tgt, qg, normsT, gmin, ginv)
    equal to every bit. Returns the kernels' outputs."""
    from quake_tpu_torch.ops.grouped_scan import group_tables_kernel, group_tables_plain

    got = group_tables_kernel(*args)
    want = group_tables_plain(*args)
    torch.cuda.synchronize()
    bad = [key for key in want if got[key].dtype != want[key].dtype
           or got[key].shape != want[key].shape
           or not torch.equal(float_bits(torch, got[key]), float_bits(torch, want[key]))]
    if set(got) != set(want) or bad:
        raise AssertionError(f"the grouping kernels disagree with their plain version in {bad} "
                             "(must be equal to every bit)")
    return got


def compare_k3(torch, kernel, plain, codes2d, bias, q, k, metric):
    from quake_tpu_torch.ops.flat_topk import _packed_params

    got = kernel(codes2d, bias, q, k, metric)
    want = plain(codes2d, bias, q, k, metric)
    torch.cuda.synchronize()
    ov = overlap(got, want)
    if ov < OVERLAP_TOL:
        raise AssertionError(f"K3 disagrees with its plain version: overlap {ov}")
    # Quantized key (plain arithmetic) of each rank's pick, kernel vs plain.
    _, levels = _packed_params(codes2d.shape[0])
    prod = q.float() @ codes2d.float().T
    s = (2.0 * prod if metric == "l2" else prod) + bias[None, :]
    valid = s > float("-inf")
    mx = torch.where(valid, s, torch.full_like(s, float("-inf"))).amax(1, keepdim=True)
    mn = torch.where(valid, s, torch.full_like(s, float("inf"))).amin(1, keepdim=True)
    key = torch.floor((s - mn) * (levels / torch.clamp(mx - mn, min=1e-20)))
    both = (got >= 0) & (want >= 0)
    kg = torch.gather(key, 1, got.clamp(min=0).long())
    kw = torch.gather(key, 1, want.clamp(min=0).long())
    max_kd = float((kg - kw).abs()[both].max()) if bool(both.any()) else 0.0
    return ov, max_kd


def phase_main(torch, dev, x, queries):
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.utils import compute_recall

    out = {}
    t0 = time.perf_counter()
    idx = QuakeIndex(device=dev)
    bt = idx.build(x, np.arange(N, dtype=np.int64),
                   IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER, calibrate_aps=False))
    out["build_s"] = time.perf_counter() - t0
    st = idx.store.state
    out["store_bytes"] = sum(t.numel() * t.element_size()
                             for t in (st.codes, st.ids, st.norms, st.sizes))
    out.update(P=idx.store.P, C=idx.store.C, nlist=idx.nlist(),
               train_s=bt.train_time_us / 1e6, assign_s=bt.assign_time_us / 1e6)
    log(f"[main] build {out['build_s']:.2f} s (train {out['train_s']:.2f} s, store "
        f"{out['assign_s']:.2f} s): nlist={out['nlist']} P={out['P']} C={out['C']} "
        f"store={out['store_bytes'] / 1e9:.3f} GB")

    x_dev = torch.from_numpy(x).to(dev)
    q_gt = queries[:NQ_GT]
    gt = exact_gt(torch, x_dev, torch.from_numpy(q_gt).to(dev), K)
    del x_dev
    chosen = None
    for nprobe in NPROBE_GRID:
        res = idx.search(q_gt, SearchParams(k=K, nprobe=nprobe))
        r = compute_recall(res.ids, gt, K)
        log(f"[main] nprobe={nprobe} recall@10={r:.4f}")
        if r >= RECALL_GATE:
            chosen = (nprobe, r, res)
            break
    if chosen is None:
        raise AssertionError(f"no nprobe in {NPROBE_GRID} reaches recall {RECALL_GATE}")
    nprobe, recall, res = chosen
    out.update(nprobe=nprobe, recall=recall)
    if res.ids.shape != (NQ_GT, K) or not np.isfinite(res.distances[res.ids >= 0]).all():
        raise AssertionError("search results have the wrong shape or non-finite distances")

    sp = SearchParams(k=K, nprobe=nprobe)
    for B, placement in ((BATCH, "argsort"), (BATCH_SORTED, "sorted")):
        qt = idx._grouped_params(B, nprobe)[0]
        if placement_of(idx, B, nprobe) != placement:
            raise AssertionError(f"B={B} was expected to take the {placement} placement")
        out[f"B{B}"] = dict(time_batch(torch, idx, torch.from_numpy(queries[:B]).to(dev), sp, gt),
                            placement=placement, qt=qt)
        log(f"[main] B={B} ({placement} placement, qt={qt}): {batch_text(out[f'B{B}'])}")
    return idx, out, gt


def placement_of(idx, B: int, nprobe: int) -> str:
    """The v11 placement the default search takes at batch B: sorted while
    its sort key fits, else argsort."""
    from quake_tpu_torch.ops.grouped import group_layout
    from quake_tpu_torch.ops.grouped_scan import sort_key_fits

    qt = idx._grouped_params(B, nprobe)[0]
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    rows = -(-group_layout(B, nprobe, idx.store.P, qt) // gpb) * gpb * qt
    return "sorted" if sort_key_fits(B, rows) else "argsort"


def time_batch(torch, idx, q, sp, gt) -> dict:
    """A batch q through the default search (idx._search_device_full):
    device ms per batch (CUDA events, 10 reps), QPS, the device ms of each
    stage's span over 3 traced runs (stage_ms), and the recall@10 of its first NQ_GT
    queries against gt; fails unless every query gets K ids and finite
    distances."""
    from quake_tpu_torch.utils import compute_recall

    B = q.shape[0]
    ms = time_ms(torch, lambda: idx._search_device_full(q, sp), reps=10)
    stages = stage_ms(torch, lambda: idx._search_device_full(q, sp))
    _, ids32, _, dists = idx._search_device_full(q, sp)
    ids_np = ids32.cpu().numpy()
    if ids_np.shape != (B, K) or (ids_np < 0).any():
        raise AssertionError(f"B={B}: expected {K} ids per query")
    if not torch.isfinite(dists).all():
        raise AssertionError(f"B={B}: non-finite distances")
    return dict(ms=ms, qps=B / (ms / 1e3), recall_first_1024=compute_recall(ids_np[:NQ_GT], gt, K),
                stages_ms=stages)


def batch_text(r: dict) -> str:
    return (f"{r['ms']:.3f} ms/batch, {r['qps']:,.0f} QPS, recall(first 1024)="
            f"{r['recall_first_1024']:.4f}, stages(ms)="
            + json.dumps({k: round(v, 4) for k, v in r["stages_ms"].items()}))


def phase_by_name(torch, dev, idx, queries, gt, nprobe, recall_v11, paths=BY_NAME,
                  tag="by name", placement=True):
    """Each scan of `paths` (BY_NAME; BF16_BY_NAME on the headline bf16
    index, whose lines read `tag`) through QUAKE_TPU_KERNEL, on the index
    at the nprobe given: recall@10 of a search of the ground-truth queries
    (B=NQ_GT; the gates read it), ms per B=16384 batch, stages, the timed
    batch's own recall on its first NQ_GT queries, and the path's launches
    (zeroed just before the path runs, read just after); then, with
    placement, the v11 path with PLACEMENT_KNOB at B=BATCH_SORTED. The
    "reference" scan (exact top-k over the same probed partitions) gives
    the recall ceiling. Fails if the path's kernels did
    not launch, if another scan kernel did, or if recall misses the path's
    gate: within EXACT_TOL below the ceiling, or within V11_TOL of the v11
    path."""
    from quake_tpu_torch import SearchParams, _ext
    from quake_tpu_torch.utils import compute_recall

    sp = SearchParams(k=K, nprobe=nprobe)
    scan_kernels = set(_ext.KERNELS) - {"flat_topk"}
    if idx.store.C % 256 == 0:
        raise AssertionError(f"C={idx.store.C}: v11g4f256 was expected to fall back to v3pN")
    os.environ["QUAKE_TPU_KERNEL"] = "reference"
    try:
        ceiling = compute_recall(idx.search(queries[:NQ_GT], sp).ids, gt, K)
    finally:
        del os.environ["QUAKE_TPU_KERNEL"]
    log(f"[{tag}] reference (exact scan of the probed partitions): recall@10={ceiling:.4f}")
    out = {"reference": dict(recall=ceiling)}
    runs = [(name, {"QUAKE_TPU_KERNEL": name}, kernels, gate, reps, BATCH)
            for name, kernels, gate, reps in paths]
    if placement:
        runs.append(("v11/" + ",".join(f"{k}={v}" for k, v in PLACEMENT_KNOB.items()),
                     PLACEMENT_KNOB, ("grouped_scan", "merge_positions") + GROUPING, "v11", 5,
                     BATCH_SORTED))
    for name, env, kernels, gate, reps, batch in runs:
        qd = torch.from_numpy(queries[:batch]).to(dev)
        os.environ.update(env)
        try:
            torch.cuda.synchronize()
            _ext.reset_launches()
            res = idx.search(queries[:NQ_GT], sp)
            ms = time_ms(torch, lambda: idx._search_device_full(qd, sp), reps=reps,
                         warmup=min(reps, 2) - 1)
            stages = stage_ms(torch, lambda: idx._search_device_full(qd, sp), min(reps, 3))
            _, ids32, _, dists = idx._search_device_full(qd, sp)
            torch.cuda.synchronize()
            launches = dict(_ext.launches)
        finally:
            for var in env:
                del os.environ[var]
        r = compute_recall(res.ids, gt, K)
        r_batch = compute_recall(ids32[:NQ_GT].cpu().numpy(), gt, K)
        log(f"[{tag}] {name}: recall@10={r:.4f} (v11 {recall_v11:.4f}, exact "
            f"{ceiling:.4f}; B={batch}: recall(first {NQ_GT})={r_batch:.4f}), {ms:.3f} ms/batch "
            f"(B={batch}), {batch / (ms / 1e3):,.0f} QPS, stages(ms)="
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}, launches {launches}")
        ran = {k for k in scan_kernels if launches[k] > 0}
        if ran != set(kernels) or launches["flat_topk"] <= 0:
            raise AssertionError(f"{name}: expected the kernels {sorted(kernels)} and "
                                 f"flat_topk to launch, got {launches}")
        if ids32.shape != (batch, K) or bool((ids32 < 0).any()) or not bool(torch.isfinite(dists).all()):
            raise AssertionError(f"{name}: expected {K} ids and finite distances per query")
        if gate == "ceiling" and abs(r - ceiling) > CEILING_TOL:
            raise AssertionError(f"{name}: recall@10 {r} is not within {CEILING_TOL} of the "
                                 f"exact scan's {ceiling}")
        if gate == "exact" and r < ceiling - EXACT_TOL:
            raise AssertionError(f"{name}: recall@10 {r} is more than {EXACT_TOL} below "
                                 f"the exact scan's {ceiling}")
        if gate == "v11" and abs(r - recall_v11) > V11_TOL:
            raise AssertionError(f"{name}: recall@10 {r} is not within {V11_TOL} of the "
                                 f"v11 path's {recall_v11}")
        out[name] = dict(recall=r, recall_batch=r_batch, ms=ms, qps=batch / (ms / 1e3),
                         batch=batch, stages_ms=stages, launches=launches)
    return out


def phase_wide(torch, dev):
    """The default search at a D that no longer fits K1's qt = 64 bodies nor
    K3's first design: a WIDE_N x WIDE_D manifold corpus, nlist=WIDE_NLIST,
    WIDE_B queries at nprobe WIDE_NPROBE. K1 runs at the query-tile height
    the index picks (32), K3 streams the depth; the ids are held to the
    exact scan of the probed partitions (overlap >= OVERLAP_TOL). Then each
    of the path's kernels against its plain version at this path's shapes,
    with compare_k3, compare_k1 and compare_k2's gates: K3 on the parent's
    buffer and these queries, K1 on the path's groups at its qt, K2 on the
    pool as the path's placement leaves it."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, _ext
    from quake_tpu_torch.coordinator import rank_parents, reference_scan
    from quake_tpu_torch.ops.flat_topk import (KEPT_BODY, flat_topk, flat_topk_body,
                                               flat_topk_plain, parent_bias)
    from quake_tpu_torch.ops.grouped_scan import (PLACEMENTS, grouped_scan_kernel,
                                                  grouped_scan_plain, merge_positions,
                                                  merge_positions_plain, sort_key_fits,
                                                  v11_inputs)

    x = make_manifold(WIDE_N, WIDE_D, 1024, seed=11)
    q = make_manifold(WIDE_B, WIDE_D, 1024, seed=12)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=WIDE_NLIST, calibrate_aps=False))
    sp = SearchParams(k=K, nprobe=WIDE_NPROBE)
    qt = idx._grouped_params(WIDE_B, WIDE_NPROBE)[0]
    pst = idx.parent.store.state
    body = flat_topk_body(pst.codes.shape[0] * pst.codes.shape[1], WIDE_D)
    if qt != 32 or not idx._grouped_kernel().startswith("v11") or body != KEPT_BODY:
        raise AssertionError(f"D={WIDE_D}: expected v11 at qt=32 and K3's kept-score body, got "
                             f"{idx._grouped_kernel()} at qt={qt}, K3 body {body}")
    torch.cuda.synchronize()
    _ext.reset_launches()
    res = idx.search(q, sp)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    qd = torch.from_numpy(q).to(dev)
    ms = time_ms(torch, lambda: idx._search_device_full(qd, sp), reps=5)
    st = idx.store.state
    pids = rank_parents(pst.codes, pst.ids, pst.norms, qd, WIDE_NPROBE, "l2", "pallas")
    _, want, _ = reference_scan(st.codes, st.ids, st.norms, qd, pids, K, "l2")
    ov = overlap(torch.from_numpy(res.ids).to(dev), want.long())
    log(f"[wide] {WIDE_N} x {WIDE_D}, nlist={WIDE_NLIST} (C={idx.store.C}), B={WIDE_B}, nprobe="
        f"{WIDE_NPROBE}: qt={qt}, {ms:.3f} ms/batch, id overlap with the exact scan of the probed "
        f"partitions {ov:.4f}, launches {launches}")
    if (launches["grouped_scan"] != 1 or launches["flat_topk"] != 1
            or launches["merge_positions"] != 1):
        raise AssertionError(f"D={WIDE_D}: expected one launch each of K1, K2 and K3, got {launches}")
    if res.ids.shape != (WIDE_B, K) or ov < OVERLAP_TOL or not np.isfinite(res.distances).all():
        raise AssertionError(f"D={WIDE_D}: overlap {ov} with the exact scan of the probed partitions")

    Pp, Cp, _ = pst.codes.shape
    codes2d = pst.codes.reshape(Pp * Cp, WIDE_D).contiguous()
    ov3, kd3 = compare_k3(torch, flat_topk, flat_topk_plain, codes2d,
                          parent_bias(pst.ids, pst.norms, "l2"), qd, WIDE_NPROBE, "l2")
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    inp = v11_inputs(st.codes, st.sizes, st.norms, qd, pids, K, "l2", qt, gpb)
    args = (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], inp["kk"],
            inp["slot_mult"], inp["levels"])
    ov1, kd1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, *args)
    placement = "sorted" if sort_key_fits(WIDE_B, inp["gp"].shape[0] * qt) else "argsort"
    m_packed, _ = PLACEMENTS[placement](grouped_scan_kernel(*args), inp["tgt"],
                                        inp["group_size"], pids)
    compare_k2(torch, merge_positions, merge_positions_plain, m_packed,
               min(K, m_packed.shape[1]), inp["slot_mult"])
    log(f"[wide] against the plain versions: K3 (N={Pp * Cp}) overlap {ov3:.4f}, max key diff "
        f"{kd3}; K1 (qt={qt}, {inp['gp'].shape[0]} groups) overlap {ov1:.4f}, max key diff "
        f"{kd1}; K2 ({placement} pool of {m_packed.shape[1]} columns) equal")
    return dict(ms=ms, qt=qt, overlap=ov, C=idx.store.C, launches=launches,
                k3=dict(overlap=ov3, max_key_diff=kd3), k1=dict(overlap=ov1, max_key_diff=kd1),
                k2_placement=placement)


def phase_small_reference(torch, dev):
    """A small index searched on the card agrees with the same store
    searched on the CPU (plain versions of every kernel)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, index_from_numpy

    x = make_manifold(20_000, 32, 256, seed=3)
    q = make_manifold(512, 32, 256, seed=4)
    idx = QuakeIndex(device=dev)
    idx.build(x, None, IndexBuildParams(nlist=64, calibrate_aps=False))
    arrays = [{f: getattr(s.store.state, f).cpu().numpy()
               for f in ("codes", "ids", "sizes", "centroids", "active", "norms")}
              for s in (idx, idx.parent)]
    cpu = index_from_numpy(arrays[0], arrays[1], "l2", device="cpu")
    sp = SearchParams(k=K, nprobe=8)
    # The C % fold fallback needs a fold that does not divide this store's C.
    fold = 256
    while idx.store.C % fold == 0:
        fold *= 2
    names = [None] + [n.replace("f256", f"f{fold}") for n, *_ in BY_NAME]
    if idx.store.C % 128 == 0:  # the spellings that pin the chunk and the group padding
        names += ["v4c128g8", "v5c128g2", "v6c128"]
    worst = 1.0
    # Both sides rank parents with K3 (the card's default; the CPU's is "approx").
    os.environ["QUAKE_TPU_PARENT_KERNEL"] = "pallas"
    for name in names:
        if name is not None:
            os.environ["QUAKE_TPU_KERNEL"] = name
        try:
            a, b = idx.search(q, sp), cpu.search(q, sp)
        finally:
            os.environ.pop("QUAKE_TPU_KERNEL", None)
        ov = overlap(torch.from_numpy(a.ids), torch.from_numpy(b.ids))
        if ov < OVERLAP_TOL:
            raise AssertionError(f"{name or 'v11'}: card and CPU searches disagree: overlap {ov}")
        worst = min(worst, ov)
        log(f"[check] small index (C={idx.store.C}), {name or 'v11 (default)'}, card vs CPU "
            f"plain path: id overlap {ov:.4f}")
    del os.environ["QUAKE_TPU_PARENT_KERNEL"]
    # The query-major and the flat searches, card against CPU.
    flat = QuakeIndex(device=dev)
    flat.build(x, None, IndexBuildParams(nlist=0))
    st = flat.store.state
    flat_cpu = index_from_numpy({f: getattr(st, f).cpu().numpy() for f in arrays[0]}, None, "l2",
                                device="cpu")
    pairs = [("flat index", flat.search(q, sp), flat_cpu.search(q, sp))]
    for B, bs in LATENCY + ((8, True),):
        spq = SearchParams(k=K, nprobe=8, batched_scan=bs)
        pairs.append((f"B={B}, batched_scan={bs}", idx.search(q[:B], spq), cpu.search(q[:B], spq)))
    for what, a, b in pairs:
        ov = overlap(torch.from_numpy(a.ids), torch.from_numpy(b.ids))
        if ov < OVERLAP_TOL or not np.allclose(a.distances, b.distances, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{what}: card and CPU searches disagree: overlap {ov}")
        worst = min(worst, ov)
        log(f"[check] small index, {what}, card vs CPU: id overlap {ov:.4f}")
    return worst


def scan_bound(st, gp, gsize, real_q, q_bytes, qt, kk, D, extra=0, whole_slab=False,
               unit=CUDA_CORES):
    """Least time of one grouped-scan pass (K1, K4-K7): bytes = the query
    tiles (q_bytes), the 128-row segments of the probed partitions that hold
    vectors (whole_slab: all their rows, for the v2 scan, which has no
    sizes; at the codes' element size, 2 bytes in bf16) with a 4-byte norm
    or id per row, gp and sizes, a [groups, qt, kk]
    f32 output, and `extra` (a second output, a chunk table); flops =
    2 D (real query rows x valid lanes) summed over the live groups, on
    `unit`. Returns (bound, live groups, scanned rows)."""
    gs = gsize.long()
    alive = gs > 0
    used = gp[alive].long().unique()
    if whole_slab:
        read_rows = int(used.numel()) * st.codes.shape[1]
    else:
        read_rows = int((((st.sizes[used].long() + 127) // 128) * 128).sum())
    flops = 2.0 * D * float((real_q[alive] * gs[alive]).sum())
    nbytes = (q_bytes + read_rows * (D * st.codes.element_size() + 4) + gp.numel() * 8
              + gp.numel() * qt * kk * 4 + extra)
    return (bound(nbytes, flops, unit), int(alive.sum()),
            int((((gs + 127) // 128) * 128)[alive].sum()))


def exact_chunked_rows(torch, idx, q, pids, qt, kk, by_name):
    """Rows of the kernels phase for K6 (through v3 and v2), K7 (through v5)
    and K4 with a chunk table (through v4), at the inputs those paths build
    from the B=16384 batch. One pass over the slab bounds K6 and K7 (K7
    reads nothing twice from device memory); v4's bound counts each query
    tile once (a block keeps it across the chunks that share it), its chunk
    table and both outputs. On a bf16 index (q the batch rounded to bf16)
    the rows are the bf16 entries (bf16_entry), each kernel's bf16 body held
    to its plain version (the split product's model has no bf16 part)."""
    from quake_tpu_torch.coordinator import chunk_spec
    from quake_tpu_torch.ops.grouped import build_chunk_groups, build_groups
    from quake_tpu_torch.ops.grouped_chunked import MMA_BODY as K7_MMA_BODY
    from quake_tpu_torch.ops.grouped_chunked import chunk_merge, chunk_merge_body, chunk_merge_plain
    from quake_tpu_torch.ops.grouped_exact import MMA_BODY as K6_MMA_BODY
    from quake_tpu_torch.ops.grouped_exact import exact_scan, exact_scan_plain, exact_topk_body
    from quake_tpu_torch.ops.grouped_family import (CHUNK_BODY, rowscale_scan, rowscale_scan_plain,
                                                    rowscale_topk_body)
    from quake_tpu_torch.ops.grouped_scan import packed_params, pad_groups
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    st = idx.store.state
    P, C, Dd = st.codes.shape
    dt = st.codes.dtype
    bf16 = dt == torch.bfloat16
    ename = bf16_entry if bf16 else (lambda e: e)
    rows = []
    pair_tol = f"winner overlap >= {OVERLAP_TOL}, scores rtol = atol = {SCORE_TOL}"
    group_pid, qlist, _, _ = build_groups(pids, P, qt)
    real_q = (qlist >= 0).sum(1)
    qg = q[torch.clamp(qlist, min=0).long()].contiguous()
    gsize = torch.where(group_pid >= 0, st.sizes[group_pid.clamp(min=0).long()],
                        torch.zeros_like(group_pid)).to(torch.int32).contiguous()
    out_i = group_pid.numel() * qt * kk * 4  # the second output: slots or ids

    # K6 as v3 (mode slot) and v2 (mode id: the whole slab, no sizes) use it,
    # against the f32 plain version and against the plain version on the
    # split product's model.
    body = exact_topk_body(qt, Dd, kk, dt)
    for entry, path, mode, kw in (("exact_topk/v3", "v3", "slot",
                                   dict(group_size=gsize, norms=st.norms)),
                                  ("exact_topk/v2", "v2", "id", dict(ids=st.ids))):
        entry = ename(entry)
        if (body == K6_MMA_BODY) != on_tensor_cores(entry):
            raise AssertionError(f"{entry} at qt={qt}, D={Dd}: body {body} is not the kernels "
                                 "line's unit")
        got = exact_scan(group_pid, qg, st.codes, kk, "l2", mode, **kw)
        ov, err = compare_pairs(torch, f"K6 ({mode}, {dt})", got,
                                exact_scan_plain(group_pid, qg, st.codes, kk, "l2", mode, **kw),
                                ties=True)
        model = {}
        if not bf16:
            with bmm_as_split_product():
                model["model_overlap"], model["model_max_abs_err"] = compare_pairs(
                    torch, f"K6 ({mode}, split product's model)", got,
                    exact_scan_plain(group_pid, qg, st.codes, kk, "l2", mode, **kw), ties=True)
        del got
        b, groups, scanned = scan_bound(st, group_pid, gsize, real_q,
                                        qg.numel() * qg.element_size(), qt, kk, Dd,
                                        extra=out_i, whole_slab=mode == "id",
                                        unit=unit_of(entry))
        rows.append(dict(
            name=entry, tol=pair_tol, overlap=ov, max_abs_err=err, err_of="score error",
            body=body, **model,
            launches=by_name[path]["launches"][ENTRIES[entry][0]],
            ms=time_ms(torch, lambda: exact_scan(group_pid, qg, st.codes, kk, "l2", mode, **kw),
                       reps=5),
            plain_ms=time_ms(torch, lambda: exact_scan_plain(group_pid, qg, st.codes, kk, "l2",
                                                             mode, **kw), reps=2, warmup=1),
            bound=b, groups=groups, scanned_rows=scanned))

    # K7 as v5 uses it (gpb 4; ct by the dispatch's rule), against its plain
    # version on the f32 product and on the split product's model.
    ct, gpb = chunk_spec("v5", C, 4)
    slot_mult, levels = packed_params(ct)
    gp5, ql5, gsize5, safe_q5 = pad_groups(group_pid, qlist, st.sizes, gpb)
    args7 = (gp5, gsize5, q[safe_q5].contiguous(), st.codes, st.norms, min(kk, ct), ct,
             slot_mult, levels, "l2")
    level = key_level(args7[2], st.norms, levels, "l2")
    entry = ename("chunk_merge/v5")
    body = chunk_merge_body(qt, Dd, min(kk, ct), dt)
    if (body == K7_MMA_BODY) != on_tensor_cores(entry):
        raise AssertionError(f"K7 at qt={qt}, D={Dd}: body {body} is not the kernels line's unit")
    got = chunk_merge(*args7)
    ov, err = compare_pairs(torch, f"K7 ({dt})", got, chunk_merge_plain(*args7), level=level)
    model = {}
    if not bf16:
        with bmm_as_split_product():
            model["model_overlap"], model["model_max_abs_err"] = compare_pairs(
                torch, "K7 (split product's model)", got, chunk_merge_plain(*args7), level=level)
    log(f"[kernel] {entry} (body {body}): winner overlap {ov:.4f}, max score error {err:.3g} "
        f"against the plain version; against the plain version on the split product's model: "
        f"{model or 'no bf16 model'}")
    del got
    b, groups, scanned = scan_bound(st, gp5, gsize5, (ql5 >= 0).sum(1),
                                    args7[2].numel() * args7[2].element_size(), qt,
                                    kk, Dd, extra=gp5.numel() * qt * kk * 4, unit=unit_of(entry))
    rows.append(dict(name=entry, tol=f"{pair_tol}, atol + one key level <= {level:.3g}",
                     overlap=ov, max_abs_err=err, body=body, **model,
                     err_of="score error", launches=by_name["v5"]["launches"][ENTRIES[entry][0]],
                     ms=time_ms(torch, lambda: chunk_merge(*args7), reps=5),
                     plain_ms=time_ms(torch, lambda: chunk_merge_plain(*args7), reps=2, warmup=1),
                     bound=b, groups=groups, scanned_rows=scanned))

    # K4 with v4's chunk table (gpb 8).
    ct, gpb = chunk_spec("v4", C, 8)
    slot_mult, levels = packed_params(ct)
    cg_pid, cg_chunk, cg_qsrc, cg_size, _, _, _ = build_chunk_groups(pids, st.sizes, P, qt, ct, C)
    pad = -(-cg_pid.shape[0] // gpb) * gpb - cg_pid.shape[0]
    cg_pid = torch.nn.functional.pad(cg_pid, (0, pad), value=-1)
    cg_chunk, cg_qsrc, cg_size = (torch.nn.functional.pad(t, (0, pad))
                                  for t in (cg_chunk, cg_qsrc, cg_size))
    args4 = (cg_pid, cg_size, qg, st.codes, st.norms, min(kk, ct), slot_mult, levels, "l2", "topk")
    table = dict(qsrc=cg_qsrc, row_off=(cg_chunk * ct).contiguous(), ct=ct)
    entry = ename("rowscale_topk/v4")
    if rowscale_topk_body(qt, Dd, min(kk, ct), True, dt) != CHUNK_BODY:
        raise AssertionError(f"{entry} at qt={qt}, D={Dd}: the chunk table must take the "
                             "persistent CUDA-core body")
    ov, kd, serr = compare_rowscale(torch, args4, **table)
    b, groups, scanned = scan_bound(
        st, cg_pid, cg_size, real_q[cg_qsrc.long()], qg.numel() * qg.element_size(), qt, kk, Dd,
        extra=cg_pid.numel() * (qt * 2 * 4 + 8), unit=unit_of(entry))
    rows.append(dict(
        name=entry, overlap=ov, max_abs_err=kd, stats_err=serr, body=CHUNK_BODY,
        tol=(f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level, stats rtol = atol = "
             f"{STATS_TOL}"),
        launches=by_name["v4"]["launches"][ENTRIES[entry][0]],
        ms=time_ms(torch, lambda: rowscale_scan(*args4, **table), reps=5),
        plain_ms=time_ms(torch, lambda: rowscale_scan_plain(*args4, **table), reps=2, warmup=1),
        bound=b, groups=groups, scanned_rows=scanned))
    return rows


def direct_groups(torch, st, q, pids):
    """The groups the direct paths build from a batch at qt = DIRECT_QT,
    padded with ghosts to a multiple of MULTI_GB as grouped_scan_multi pads
    them: (gp, qg, gsize, real query rows of each group)."""
    from quake_tpu_torch.ops.grouped import build_groups

    gp, qlist, _, _ = build_groups(pids, st.codes.shape[0], DIRECT_QT)
    pad = -gp.shape[0] % MULTI_GB
    gp = torch.nn.functional.pad(gp, (0, pad), value=-1).contiguous()
    qlist = torch.nn.functional.pad(qlist, (0, 0, 0, pad), value=-1)
    qg = q[qlist.clamp(min=0).long()].contiguous()
    gsize = torch.where(gp >= 0, st.sizes[gp.clamp(min=0).long()], torch.zeros_like(gp))
    return gp, qg, gsize.to(torch.int32).contiguous(), (qlist >= 0).sum(1)


def variant_rows(torch, idx, q, pids, kk, direct):
    """Rows of the kernels phase for K8, K9, sized_topk and multi_topk, at
    the inputs the direct paths build from the B=16384 batch (qt = 64). The
    id-masked kernels read whole slabs; K8's bytes include its [G, qt, C]
    output. All four must run their tensor-core bodies there; K8, K9 and
    sized_topk are held to their f32 plain versions and to the plain
    versions on the split product's model (sized_topk also to its tie order,
    the larger slot first), and K9's output to the top kk of K8's scores,
    packed. K8's library time is the tensor-operation scan's score step
    (ops/grouped.py::group_scores: a torch.bmm per chunk of groups, without
    the top-k), which computes the same function. On a bf16 index (q the
    batch rounded to bf16) the rows are the bf16 entries, each bf16 body held
    to its plain version and K9 still to the top kk of K8's scores, packed
    (the split product's model has no bf16 part)."""
    from quake_tpu_torch.ops.grouped import group_scores
    from quake_tpu_torch.ops.grouped_variants import (MMA_BODY, multi_topk, multi_topk_body,
                                                      multi_topk_plain, packed_topk,
                                                      packed_topk_body, packed_topk_plain,
                                                      raw_scores, raw_scores_body,
                                                      raw_scores_plain, sized_topk,
                                                      sized_topk_body, sized_topk_plain,
                                                      slot_bits_of)
    from quake_tpu_torch.ops.split_product import bmm_as_split_product

    st = idx.store.state
    P, C, Dd = st.codes.shape
    dt = st.codes.dtype
    bf16 = dt == torch.bfloat16
    ename = bf16_entry if bf16 else (lambda e: e)
    qt = DIRECT_QT
    gp, qg, gsize, real_q = direct_groups(torch, st, q, pids)
    Gn = gp.shape[0]
    safe = gp.clamp(min=0).long()
    out_i = Gn * qt * kk * 4
    pair_tol = f"winner overlap >= {OVERLAP_TOL}, scores rtol = atol = {SCORE_TOL}"
    rows = []

    def row(name, fn, plain, whole_slab, extra, plain_reps=2, **fields):
        name = ename(name)
        b, groups, scanned = scan_bound(st, gp, gsize, real_q, qg.numel() * qg.element_size(),
                                        qt, kk, Dd, extra=extra, whole_slab=whole_slab,
                                        unit=unit_of(name))
        rows.append(dict(name=name, launches=direct[name]["launches"][name],
                         ms=time_ms(torch, fn, reps=5),
                         plain_ms=time_ms(torch, plain, reps=plain_reps, warmup=1),
                         bound=b, groups=groups, scanned_rows=scanned, **fields))

    bodies = {"raw_scores": raw_scores_body(qt, Dd, dt),
              "packed_topk": packed_topk_body(qt, Dd, kk, dt),
              "sized_topk": sized_topk_body(qt, Dd, kk, dt),
              "multi_topk": multi_topk_body(qt, Dd, kk, dt)}
    for entry, body in bodies.items():
        if (body == MMA_BODY) != on_tensor_cores(ename(entry)):
            raise AssertionError(f"{entry} at qt={qt}, D={Dd}, kk={kk}: body {body} is not the "
                                 "kernels line's unit")
    # K8, and its scores on both sides for K9's comparison; K9 runs K8's body
    # here, so K8's own scores are those in K9's arithmetic.
    raw = raw_scores(gp, qg, st.codes, st.ids, "l2")
    raw_p = raw_scores_plain(gp, qg, st.codes, st.ids, "l2")
    err8 = compare_raw(torch, raw, raw_p)
    got9 = packed_topk(gp, qg, st.codes, st.ids, kk, "l2")
    ov9, kd9 = compare_packed(torch, got9, packed_topk_plain(gp, qg, st.codes, st.ids, kk, "l2",
                                                             chunk=64),
                              raw, raw_p, slot_bits_of(C), exact=True)
    del raw_p
    model8, model9 = {}, {}
    if not bf16:
        with bmm_as_split_product():
            raw_m = raw_scores_plain(gp, qg, st.codes, st.ids, "l2")
            want9_m = packed_topk_plain(gp, qg, st.codes, st.ids, kk, "l2", chunk=64)
        model8 = dict(model_overlap=1.0, model_max_abs_err=compare_raw(torch, raw, raw_m))
        model9["model_overlap"], model9["model_max_abs_err"] = compare_packed(
            torch, got9, want9_m, raw, raw_m, slot_bits_of(C))
        del raw_m, want9_m
    log(f"[kernel] {ename('raw_scores')} (body {bodies['raw_scores']}): max score error / "
        f"tolerance {err8:.3g} against the plain version, {model8 or 'no bf16 model'} against "
        f"the split product's model; {ename('packed_topk')} (body {bodies['packed_topk']}): the "
        f"top kk of K8's scores, packed; overlap {ov9:.4f}, max key diff {kd9}, model {model9}")
    del got9
    group_chunk = idx._grouped_params(BATCH, pids.shape[1])[1]

    def library():
        for g0 in range(0, Gn, group_chunk):
            sl = slice(g0, g0 + group_chunk)
            sids = torch.where((gp[sl] >= 0)[:, None], st.ids[safe[sl]], -1)
            raw[sl] = group_scores(qg[sl], st.codes[safe[sl]], sids, "l2")

    lib_ms = time_ms(torch, library, reps=2, warmup=1)
    del raw
    row("raw_scores", lambda: raw_scores(gp, qg, st.codes, st.ids, "l2"),
        lambda: raw_scores_plain(gp, qg, st.codes, st.ids, "l2"), True,
        Gn * qt * (C - kk) * 4, tol=f"scores rtol = atol = {SCORE_TOL}, the same -inf lanes",
        overlap=1.0, max_abs_err=err8, err_of="score error / tolerance", library_ms=lib_ms,
        body=bodies["raw_scores"], **model8)
    got = sized_topk(gp, gsize, qg, st.codes, kk, "l2", ct=SIZED_CT)
    ov, err = compare_pairs(torch, f"sized_topk ({dt})", got,
                            sized_topk_plain(gp, gsize, qg, st.codes, kk, "l2", ct=SIZED_CT),
                            ties=True)
    model = {}
    if not bf16:
        with bmm_as_split_product():
            model["model_overlap"], model["model_max_abs_err"] = compare_pairs(
                torch, "sized_topk (split product's model)", got,
                sized_topk_plain(gp, gsize, qg, st.codes, kk, "l2", ct=SIZED_CT), ties=True)
    log(f"[kernel] {ename('sized_topk')} (body {bodies['sized_topk']}): winner overlap {ov:.4f}, "
        f"max score error {err:.3g} against the plain version; {model or 'no bf16 model'} "
        "against the plain version on the split product's model; equal scores by the larger slot")
    del got
    row("sized_topk", lambda: sized_topk(gp, gsize, qg, st.codes, kk, "l2", ct=SIZED_CT),
        lambda: sized_topk_plain(gp, gsize, qg, st.codes, kk, "l2", ct=SIZED_CT), False, out_i,
        plain_reps=1 if bf16 else 2,
        tol=f"{pair_tol}, equal scores by the larger slot", overlap=ov, max_abs_err=err,
        err_of="score error", body=bodies["sized_topk"], **model)
    row("packed_topk", lambda: packed_topk(gp, qg, st.codes, st.ids, kk, "l2"),
        lambda: packed_topk_plain(gp, qg, st.codes, st.ids, kk, "l2", chunk=64), True, 0,
        tol=(f"winner overlap >= {OVERLAP_TOL}, shared winners with bit-equal scores carry equal "
             "packed values, equal to the top kk of K8's scores, packed"), overlap=ov9,
        max_abs_err=kd9, body=bodies["packed_topk"], **model9)
    ov, err = compare_pairs(
        torch, "multi_topk",
        multi_slots(multi_topk(gp, qg, st.codes, st.ids, kk, "l2", gb=MULTI_GB), C),
        multi_slots(multi_topk_plain(gp, qg, st.codes, st.ids, kk, "l2"), C), ties="up")
    row("multi_topk", lambda: multi_topk(gp, qg, st.codes, st.ids, kk, "l2", gb=MULTI_GB),
        lambda: multi_topk_plain(gp, qg, st.codes, st.ids, kk, "l2"), True, out_i,
        tol=pair_tol, overlap=ov, max_abs_err=err, err_of="score error",
        body=bodies["multi_topk"])
    return rows


def phase_direct(torch, dev, idx, queries, gt, nprobe, ceiling, paths=DIRECT, tag="direct"):
    """The four entry points that no dispatch name reaches (`paths`: DIRECT;
    BF16_DIRECT on the headline bf16 index, whose lines read `tag`), called
    with the index's tensors: recall@10 on the ground-truth queries against the
    exact scan of the same probed partitions (`ceiling`), ms per B=16384
    batch and stages, and the path's launches (zeroed just before the path
    runs, read just after). Fails if the path's kernel did not launch, if
    another scan kernel did, or if recall misses its gate."""
    from quake_tpu_torch import _ext
    from quake_tpu_torch.ops import grouped_variants as gv
    from quake_tpu_torch.utils import compute_recall

    st = idx.store.state
    fns = {
        "approx": lambda q, p: gv.grouped_scan_approx(st.codes, st.ids, q, p, K, "l2",
                                                      qt=DIRECT_QT),
        "sized": lambda q, p: gv.grouped_scan_sized(st.codes, st.ids, st.sizes, q, p, K, "l2",
                                                    qt=DIRECT_QT, ct=SIZED_CT),
        "packed": lambda q, p: gv.grouped_scan_packed(st.codes, st.ids, q, p, K, "l2",
                                                      qt=DIRECT_QT),
        "multi": lambda q, p: gv.grouped_scan_multi(st.codes, st.ids, q, p, K, "l2",
                                                    qt=DIRECT_QT, gb=MULTI_GB),
    }
    batches = probe_batches(torch, dev, idx, queries, nprobe)
    scan_kernels = set(_ext.KERNELS) - {"flat_topk"}
    out = {}
    for name, kernel, gate, reps in paths:
        fn = fns[name]
        torch.cuda.synchronize()
        _ext.reset_launches()
        _, ids_gt, scanned = fn(*batches[NQ_GT])
        ms = time_ms(torch, lambda: fn(*batches[BATCH]), reps=reps, warmup=1)
        stages = stage_ms(torch, lambda: fn(*batches[BATCH]), min(reps, 3))
        scores, ids32, _ = fn(*batches[BATCH])
        torch.cuda.synchronize()
        launches = dict(_ext.launches)
        r = compute_recall(ids_gt.cpu().numpy(), gt, K)
        log(f"[{tag}] {name}: recall@10={r:.4f} (exact {ceiling:.4f}), {ms:.3f} ms/batch "
            f"(B={BATCH}, qt={DIRECT_QT}), {BATCH / (ms / 1e3):,.0f} QPS, stages(ms)="
            f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}, launches {launches}")
        if {k for k in scan_kernels if launches[k] > 0} != {kernel}:
            raise AssertionError(f"{name}: expected the kernel {kernel} alone to launch, got "
                                 f"{launches}")
        if (ids32.shape != (BATCH, K) or bool((ids32 < 0).any())
                or not bool(torch.isfinite(scores).all()) or not bool((scanned == nprobe).all())):
            raise AssertionError(f"{name}: expected {K} ids and finite scores per query")
        if gate == "ceiling" and abs(r - ceiling) > CEILING_TOL:
            raise AssertionError(f"{name}: recall@10 {r} is not within {CEILING_TOL} of the "
                                 f"exact scan's {ceiling}")
        if gate == "exact" and r < ceiling - EXACT_TOL:
            raise AssertionError(f"{name}: recall@10 {r} is more than {EXACT_TOL} below the "
                                 f"exact scan's {ceiling}")
        out[kernel] = dict(path=name, recall=r, ms=ms, qps=BATCH / (ms / 1e3), stages_ms=stages,
                           launches=launches)
    return out


def phase_latency(torch, dev, idx, x, queries, gt, nprobe):
    """The query-major and the flat searches through QuakeIndex.search. Each
    query-major run is held to the exact scan of the partitions it probed
    (the parent ranking in tensor operations, as that path ranks); the time
    is the host's, around a search that ends in a copy to the host. Returns
    (the summary, the flat index, which the shard phase shards)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, _ext
    from quake_tpu_torch.coordinator import rank_parents, reference_scan
    from quake_tpu_torch.utils import compute_recall

    st, pst = idx.store.state, idx.parent.store.state
    out = {}
    _ext.reset_launches()
    for B, bs in LATENCY:
        sp = SearchParams(k=K, nprobe=nprobe, batched_scan=bs)
        res = idx.search(queries[:B], sp)
        q = torch.from_numpy(queries[:B]).to(dev)
        pids = rank_parents(pst.codes, pst.ids, pst.norms, q, nprobe, "l2", "approx")
        _, want, _ = reference_scan(st.codes, st.ids, st.norms, q, pids, K, "l2")
        ov = overlap(torch.from_numpy(res.ids).to(dev), want.long())
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            idx.search(queries[:B], sp)
            times.append((time.perf_counter() - t0) * 1e3)
        r = compute_recall(res.ids, gt[:B], K)
        out[f"B{B}"] = dict(batched_scan=bs, ms_mean=float(np.mean(times)),
                            ms_min=float(np.min(times)), overlap=ov, recall=r)
        log(f"[latency] B={B} batched_scan={bs}: {np.mean(times):.3f} ms/search (min "
            f"{np.min(times):.3f}, host clock), id overlap with the exact scan of the probed "
            f"partitions {ov:.4f}, recall@10={r:.4f}")
        if res.ids.shape != (B, K) or ov < OVERLAP_TOL or not np.isfinite(res.distances).all():
            raise AssertionError(f"query-major search at B={B}: overlap {ov} with the exact scan")
    if any(_ext.launches.values()):
        raise AssertionError(f"the query-major path launched a kernel: {_ext.launches}")

    t0 = time.perf_counter()
    flat = QuakeIndex(device=dev)
    flat.build(x, np.arange(N, dtype=np.int64), IndexBuildParams(nlist=0, metric="l2"))
    build_s = time.perf_counter() - t0
    sp = SearchParams(k=K)
    res = flat.search(queries[:NQ_GT], sp)
    r = compute_recall(res.ids, gt, K)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        flat.search(queries[:NQ_GT], sp)
        times.append((time.perf_counter() - t0) * 1e3)
    one = []
    for _ in range(5):
        t0 = time.perf_counter()
        flat.search(queries[:1], sp)
        one.append((time.perf_counter() - t0) * 1e3)
    out["flat"] = dict(build_s=build_s, recall=r, ms_b1024=float(np.mean(times)),
                       ms_b1=float(np.mean(one)), C=flat.store.C)
    log(f"[latency] flat index (nlist=0, C={flat.store.C}, build {build_s:.2f} s): recall@10="
        f"{r:.4f}, {np.mean(times):.3f} ms per {NQ_GT}-query search, {np.mean(one):.3f} ms per "
        f"1-query search (host clock)")
    if r < FLAT_RECALL or res.ids.shape != (NQ_GT, K):
        raise AssertionError(f"flat index: recall@10 {r} below {FLAT_RECALL}")
    return out, flat


def shard_log(msg: str) -> None:
    """A `[shard]` line on stderr, beside the card's name and power limit."""
    log(f"[shard] ({card_line()}) {msg}")


def count_syncs(torch, fn) -> int:
    """The operations of fn() that synchronize the host with the card, as
    torch.cuda's sync debug mode counts them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def shard_gates(torch, idx, when: str) -> float:
    """Every slot shard of a sharded index against its primary store: the
    shard's codes, ids and norms contiguous and equal to the primary's slot
    slice bit for bit, its valid-slot counts the primary's sizes less the
    slots before the slice (clamped to the slice), and contract 6 on the
    shard (ids >= 0 exactly below those counts, the norms the codes'
    squared norms at rtol 1e-6). Returns the worst relative norm error."""
    store = idx.store
    st, sh = store.state, idx._shards()
    Cl = store.C // sh.ndev
    err = 0.0
    for s in range(sh.ndev):
        sl = slice(s * Cl, (s + 1) * Cl)
        for name in ("codes", "ids", "norms"):
            part = getattr(sh, name)[s]
            if not part.is_contiguous() or not torch.equal(part, getattr(st, name)[:, sl]):
                raise AssertionError(f"{when}: shard {s}'s {name} differ from the primary's "
                                     f"slots {sl.start}-{sl.stop}")
        local = torch.clamp(st.sizes - s * Cl, 0, Cl).to(torch.int32)
        below = torch.arange(Cl, device=st.ids.device)[None, :] < local[:, None]
        if not torch.equal(sh.local_sizes[s], local) or not torch.equal(sh.ids[s] >= 0, below):
            raise AssertionError(f"{when}: shard {s}'s valid slots are not its prefix")
        want = (sh.codes[s] * sh.codes[s]).sum(-1)[below]
        got = sh.norms[s][below]
        err = max(err, float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()))
    if err > 1e-6:
        raise AssertionError(f"{when}: a shard's norms are off its codes' by {err} (rtol 1e-6)")
    return err


def phase_shard(torch, dev, x, queries, gt, flat, nprobe) -> dict:
    """Sharding on the card: the main corpus built afresh (nlist 160,
    calibrate_aps=False), searched unsharded, then sharded with
    shard(SHARDS, devices=[dev] * SHARDS) (C re-bucketed to a multiple of
    128 * SHARDS; each shard a contiguous copy of its slot slice) and searched
    again. Fixed nprobe at B=BATCH: ms (CUDA events) and stages (K1's
    "scan" summed over the shards, the gather and merge as "shard_merge")
    beside the unsharded batch; one counted batch launching K1 and K2 once a
    shard and K3 never, each call held against its plain version
    (checked_batch); ids overlapping the exact scan of the unsharded probe
    lists ("reference") >= SHARD_OVERLAP (v11's keys are finer at the local
    C: see SHARD_OVERLAP), recall@10 of the first 1024 at most
    SHARD_RECALL_TOL below the unsharded; the host syncs of a batch each way.
    APS planned and loop at APS_TARGET on B=SHARD_APS_B: recall at most
    SHARD_APS_TOL below the unsharded, ms, launches, each batch's calls
    held. The flat index of the latency phase sharded alike:
    B=SHARD_FLAT_B ids equal to its unsharded search's. SHARD_WRITES added
    and then removed through the sharded index, shard_gates after each
    write and a counted batch on the rebuilt shards. `[shard]` lines."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.utils import compute_recall

    t_phase = time.perf_counter()
    idx = QuakeIndex(device=dev)
    _, build_s = timed(torch, lambda: idx.build(
        x, np.arange(N, dtype=np.int64),
        IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER, calibrate_aps=False)))
    C0 = idx.store.C
    qd = torch.from_numpy(queries[:BATCH]).to(dev)
    qa = qd[:SHARD_APS_B]
    sp = SearchParams(k=K, nprobe=nprobe)
    aps_sps = {m: SearchParams(k=K, recall_target=APS_TARGET, aps_mode=m)
               for m in SHARD_APS_MODES}
    out = {"unsharded": {}, "sharded": {}}

    def runs(key):
        r = out[key]
        r["batch"] = time_batch(torch, idx, qd, sp, gt)
        r["ids"] = idx._search_device_full(qd, sp)[1]
        r["syncs"] = count_syncs(torch, lambda: idx._search_device_full(qd, sp))
        r["aps"] = {}
        for m, asp in aps_sps.items():
            a = time_aps(torch, idx, qa, asp, loop=m == "loop")
            a["recall"] = compute_recall(idx._search_device_full(qa, asp)[1][:NQ_GT].cpu().numpy(),
                                         gt, K)
            r["aps"][m] = a

    runs("unsharded")
    os.environ["QUAKE_TPU_KERNEL"] = "reference"
    try:  # the exact scan of the unsharded probe lists
        ref_ids = idx._search_device_full(qd, sp)[1]
    finally:
        del os.environ["QUAKE_TPU_KERNEL"]
    ref_recall = compute_recall(ref_ids[:NQ_GT].cpu().numpy(), gt, K)
    _, shard_s = timed(torch, lambda: idx.shard(SHARDS, devices=[dev] * SHARDS))
    C = idx.store.C
    if C % (128 * SHARDS) or C < C0 or idx.mesh.size != SHARDS:
        raise AssertionError(f"shard({SHARDS}): C {C0} -> {C}, mesh {idx.mesh.devices}")
    sh = idx._shards()
    shard_bytes = sum(t.numel() * t.element_size() for t in sh.codes + sh.ids + sh.norms)
    norm_err = shard_gates(torch, idx, "sharded")
    shard_log(f"fresh build {build_s:.2f} s; shard({SHARDS}, devices=[{dev}] * {SHARDS}) "
              f"{shard_s:.3f} s: C {C0} -> {C}, local C {C // SHARDS}, the shards' copies "
              f"{shard_bytes / 1e9:.3f} GB beside the primary; gates hold (norm err {norm_err})")
    runs("sharded")
    u, s_ = out["unsharded"], out["sharded"]
    launches, ids32, checks = checked_batch(torch, "sharded",
                                            lambda: idx._search_device_full(qd, sp))
    if launches != SHARD_KERNELS:
        raise AssertionError(f"a sharded batch must launch K1 and K2 {SHARDS} times each and K3 "
                             f"never: {launches}")
    s_ids, u_ids = s_.pop("ids").long(), u.pop("ids").long()
    ov, ov_ref = overlap(s_ids, u_ids), overlap(s_ids, ref_ids.long())
    ov_ref_u = overlap(u_ids, ref_ids.long())
    del s_ids, u_ids, ref_ids
    dr = s_["batch"]["recall_first_1024"] - u["batch"]["recall_first_1024"]
    if ov_ref < SHARD_OVERLAP or dr < -SHARD_RECALL_TOL:
        raise AssertionError(f"sharded B={BATCH}: overlap {ov_ref} with the exact scan of the "
                             f"probed partitions, recall {dr:+.4f} against the unsharded")
    out.update(C0=C0, C=C, build_s=build_s, shard_s=shard_s, shard_bytes=shard_bytes,
               launches=launches, kernel_checks=checks, overlap=ov, overlap_exact=ov_ref,
               overlap_exact_unsharded=ov_ref_u, recall_diff=dr, exact_recall=ref_recall)
    for key in ("unsharded", "sharded"):
        b = out[key]["batch"]
        shard_log(f"{key} B={BATCH}, nprobe {nprobe}: {batch_text(b)}; host syncs a batch "
                  f"{out[key]['syncs']}")
    shard_log(f"K1 summed over the shards {s_['batch']['stages_ms'].get('scan', 0.0):.4f} ms "
              f"(unsharded {u['batch']['stages_ms'].get('scan', 0.0):.4f} ms), the gather and "
              f"merge {s_['batch']['stages_ms'].get('shard_merge', 0.0):.4f} ms; ids overlap "
              f"the unsharded {ov:.5f}, the exact scan of the probed partitions {ov_ref:.5f} "
              f"(unsharded {ov_ref_u:.5f}; its recall {ref_recall:.4f}), recall {dr:+.4f}; "
              f"launches {launches}; calls against their plain versions {json.dumps(checks)}")

    for m, asp in aps_sps.items():
        a, b = s_["aps"][m], u["aps"][m]
        if a["recall"] - b["recall"] < -SHARD_APS_TOL:
            raise AssertionError(f"sharded APS {m}: recall {a['recall']} against the "
                                 f"unsharded {b['recall']}")
        a["launches"], _, a["kernel_checks"] = checked_batch(
            torch, f"sharded APS {m}", lambda: idx._search_device_full(qa, asp))
        shard_log(f"APS {m} at {APS_TARGET}, B={SHARD_APS_B}: recall {a['recall']:.4f} "
                  f"(unsharded {b['recall']:.4f}), {a['ms']:.3f} ms (unsharded {b['ms']:.3f}), "
                  f"scanned {a['scanned']:.2f}, steps {a['steps']}, syncs {a['syncs']}, "
                  f"launches {a['launches']}; calls against their plain versions "
                  f"{json.dumps(a['kernel_checks'])}")

    fsp = SearchParams(k=K)
    fq = queries[:SHARD_FLAT_B]
    want = flat.search(fq, fsp).ids
    fms_u = time_ms(torch, lambda: flat._search_device_full(qd[:SHARD_FLAT_B], fsp), reps=3)
    flat.shard(SHARDS, devices=[dev] * SHARDS)
    got = flat.search(fq, fsp).ids
    fms_s = time_ms(torch, lambda: flat._search_device_full(qd[:SHARD_FLAT_B], fsp), reps=3)
    if not np.array_equal(got, want):
        raise AssertionError(f"sharded flat search: {int((got != want).any(1).sum())} rows "
                             f"differ from the unsharded search's")
    out["flat"] = dict(C=flat.store.C, ms=fms_s, unsharded_ms=fms_u)
    shard_log(f"flat index sharded (C {flat.store.C}): B={SHARD_FLAT_B} ids equal to the "
              f"unsharded search's; {fms_s:.3f} ms (unsharded {fms_u:.3f})")

    new = make_manifold(SHARD_WRITES, D, 4096, seed=43)
    writes = {}
    for what, write in (("add", lambda: idx.add(new, 4 * N + np.arange(SHARD_WRITES))),
                        ("remove", lambda: idx.remove(np.arange(0, N, N // SHARD_WRITES)))):
        _, sec = timed(torch, write)
        if not idx.validate():
            raise AssertionError(f"sharded {what}: validate() fails")
        _, rebuild_s = timed(torch, idx._shards)
        err = shard_gates(torch, idx, f"after {what}")
        n_launch, ids32, _ = checked_batch(torch, f"after {what}",
                                           lambda: idx._search_device_full(qd, sp))
        if n_launch != SHARD_KERNELS or (ids32 < 0).any():
            raise AssertionError(f"after {what}: launches {n_launch}, or a query without {K} ids")
        writes[what] = dict(s=sec, rebuild_s=rebuild_s, ntotal=idx.ntotal(), C=idx.store.C,
                            norm_err=err)
        shard_log(f"{what} {SHARD_WRITES} through the sharded index {sec:.3f} s, the shards "
                  f"rebuilt in {rebuild_s:.3f} s: ntotal {idx.ntotal()}, C {idx.store.C}, "
                  f"shards equal to the primary, contract 6 on each (norm err {err}), a batch "
                  f"launches {n_launch}")
    out["writes"] = writes
    out["phase_s"] = time.perf_counter() - t_phase
    shard_log(f"phase {out['phase_s']:.1f} s")
    return out


def start_product_only_build():
    """Starts a second build of csrc/quake_kernels.cu with -DQK_PRODUCT_ONLY
    (K1's bodies with their loads and products and without keys, fold and
    rounds: a timing aid, never the package's library) in a directory of its
    own. Returns what product_only_k1 needs; the caller cleans up its
    directory (the first item) after the last launch."""
    from quake_tpu_torch import _ext

    _ext.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=_ext.BUILD_DIR)
    so = os.path.join(tmp.name, "libk1_product_only.so")
    proc = subprocess.Popen(
        [_ext._nvcc(), *_ext.NVCC_FLAGS, "-DQK_PRODUCT_ONLY", "-shared",
         str(_ext.CSRC / "quake_kernels.cu"), "-ldl", "-o", so],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return tmp, so, proc


def product_only_k1(torch, build, gp, gsize, qg, codes, normsT, kk, slot_mult, levels):
    """A function that launches the product-only build of K1 (its f32 or
    bf16 entry, by the codes' dtype) on K1's arguments (what it writes is no
    result)."""
    from quake_tpu_torch import _ext

    _, so, proc = build
    if proc.returncode is None:  # the build's first use waits for it
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the product-only build of K1:\n{out}")
    name = "qk_grouped_scan_bf16" if codes.dtype == torch.bfloat16 else "qk_grouped_scan"
    entry = _ext.entry(ctypes.CDLL(so), name, product_only=True)
    (Gn, qt, Dd), (P, C, _) = qg.shape, codes.shape
    scratch = torch.empty((Gn, qt, kk), device=qg.device, dtype=torch.float32)

    def launch():
        _ext.check(entry(gp.data_ptr(), gsize.data_ptr(), qg.data_ptr(), codes.data_ptr(),
                         normsT.data_ptr(), scratch.data_ptr(), Gn, qt, Dd, P, C, kk,
                         float(slot_mult), float(levels), 128, _ext.stream_ptr(qg.device)),
                   "grouped_scan (product only)")

    return launch


def empty_launch(torch, build, rows: int):
    """A function that launches the product-only build's empty kernel on
    kernel K2's grid for `rows` rows (8 lanes a row): the floor under K2's
    time. The build was finished by product_only_k1."""
    from quake_tpu_torch import _ext

    _, so, _ = build
    entry = _ext.entry(ctypes.CDLL(so), "qk_empty", product_only=True)
    grid = -(-rows * 8 // 256)
    return lambda: _ext.check(entry(grid, _ext.stream_ptr(torch.device("cuda"))), "empty kernel")


def probe_lists(torch, idx, q, nprobe):
    """The probe lists of a batch as the main path ranks them (K3), a -1 pad
    replaced by the query's first probe."""
    from quake_tpu_torch.coordinator import rank_parents

    pst = idx.parent.store.state
    pids = rank_parents(pst.codes, pst.ids, pst.norms, q, nprobe, "l2", "pallas")
    return torch.where(pids >= 0, pids, pids[:, :1])


def probe_batches(torch, dev, idx, queries, nprobe):
    """{n: (the first n queries on the card, their probe lists)} for the
    ground-truth queries (n = NQ_GT) and the timed batch (n = BATCH)."""
    out = {}
    for n in (NQ_GT, BATCH):
        q = torch.from_numpy(queries[:n]).to(dev)
        out[n] = (q, probe_lists(torch, idx, q, nprobe))
    return out


def k1_args(idx, q, pids):
    """K1's query-tile height, v11_inputs' dict and K1's arguments on the
    main (v11) path of idx for the batch q with probe lists pids."""
    from quake_tpu_torch.ops.grouped_scan import v11_inputs

    st = idx.store.state
    qt = idx._grouped_params(q.shape[0], pids.shape[1])[0]
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    inp = v11_inputs(st.codes, st.sizes, st.norms, q, pids, K, "l2", qt, gpb)
    return qt, inp, (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], inp["kk"],
                     inp["slot_mult"], inp["levels"])


def sampled_bounds(torch, dev, idx, queries, gt, nprobe, what: str) -> dict:
    """bounds="sampled" (the key's scale from a sample of real scores, an
    option of v8-v11 and v10b that no index path sets): K1 at idx's B=BATCH
    v11 shapes under the sampled scale against its plain version
    (compare_k1's gates) and timed beside K1 under the analytic one; v11's
    recall@10 of the NQ_GT queries at nprobe under both bounds, called on
    idx's store (dedup on a spilled store), against the exact ground truth
    gt. Not a default: the JAX package's index never sets it."""
    from quake_tpu_torch.ops.grouped_scan import (global_bounds, grouped_scan_kernel,
                                                  grouped_scan_plain, grouped_scan_v11,
                                                  v11_inputs)
    from quake_tpu_torch.utils import compute_recall

    st = idx.store.state
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    pids = probe_lists(torch, idx, q, nprobe)
    qt = idx._grouped_params(BATCH, nprobe)[0]
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    out = {}
    for bounds in ("analytic", "sampled"):
        inp = v11_inputs(st.codes, st.sizes, st.norms, q, pids, K, "l2", qt, gpb, bounds)
        args = (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], inp["kk"],
                inp["slot_mult"], inp["levels"])
        r = dict(ms=time_ms(torch, lambda: grouped_scan_kernel(*args)))
        if bounds == "sampled":
            r["overlap"], r["max_abs_err"] = compare_k1(torch, grouped_scan_kernel,
                                                        grouped_scan_plain, *args)
        gmin, grange = global_bounds(q, st.norms, "l2", bounds, st.codes, st.sizes)
        r.update(gmin=float(gmin), grange=float(grange))
        q1 = q[:NQ_GT]
        _, ids, _ = grouped_scan_v11(st.codes, st.ids, st.sizes, st.norms, q1, pids[:NQ_GT], K,
                                     "l2", qt=idx._grouped_params(NQ_GT, nprobe)[0], gpb=gpb,
                                     dedup=idx.spill, bounds=bounds)
        r["recall"] = compute_recall(ids.cpu().numpy(), gt, K)
        out[bounds] = r
    a, b = out["analytic"], out["sampled"]
    log(f"[sampled] ({card_line()}) {what}, B={BATCH}, nprobe {nprobe}, C {st.codes.shape[1]}: "
        f"K1 under bounds=\"sampled\" against its plain version: overlap {b['overlap']:.4f}, "
        f"max key diff {b['max_abs_err']}; K1 {b['ms']:.4f} ms (analytic {a['ms']:.4f}); the "
        f"scale's range {b['grange']:.4g} (analytic {a['grange']:.4g}: "
        f"{a['grange'] / b['grange']:.2f}x the levels a unit of score); v11 recall@10 of "
        f"{NQ_GT} queries analytic {a['recall']:.4f}, sampled {b['recall']:.4f}")
    return out


def phase_kernels(torch, dev, idx, x, queries, nprobe, launches, by_name, direct, k1_build,
                  gt):
    """Each kernel against its plain version at the shapes of the path it
    runs on, with times and bounds: K1-K3 and the grouping kernels on the
    main (v11) path (K3 also with K3_WIDE_N rows of the corpus x as its
    buffer); on the by-name paths
    K4 through v3p, v3pN, v6 and v4, K5 through v7, K1 through v8, K6
    through v3 and v2, K7 through v5."""
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_body, flat_topk_plain, parent_bias
    from quake_tpu_torch.ops.grouped import build_groups
    from quake_tpu_torch.ops.grouped_scan import (argsort_placement, global_scale,
                                                  grouped_scan_kernel, grouped_scan_plain,
                                                  merge_positions, merge_positions_plain,
                                                  pad_groups)

    st, pst = idx.store.state, idx.parent.store.state
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    rows = []
    k1_tol = f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level"

    # K3 at the parent ranking's shape, and with K3_WIDE_N corpus rows as the
    # buffer (the parent of an index with a few thousand partitions).
    Pp, Cp, Dd = pst.codes.shape
    codes2d = pst.codes.reshape(Pp * Cp, Dd).contiguous()
    bias = parent_bias(pst.ids, pst.norms, "l2")
    wide = torch.from_numpy(x[:K3_WIDE_N]).to(dev)
    wide_bias = (-(wide * wide).sum(1)).contiguous()
    k3 = {}
    for shape, cb, bb in ((f"B={BATCH}, N={Pp * Cp}, D={Dd}", codes2d, bias),
                          (f"B={BATCH}, N={K3_WIDE_N}, D={Dd}", wide, wide_bias)):
        ov3, kd3 = compare_k3(torch, flat_topk, flat_topk_plain, cb, bb, q, nprobe, "l2")
        n_valid = int((bb > float("-inf")).sum())
        k3[shape] = dict(
            shape=shape, body=flat_topk_body(cb.shape[0], Dd), overlap=ov3, max_abs_err=kd3,
            ms=time_ms(torch, lambda: flat_topk(cb, bb, q, nprobe, "l2")),
            plain_ms=time_ms(torch, lambda: flat_topk_plain(cb, bb, q, nprobe, "l2"), reps=3,
                             warmup=1),
            bound=bound((q.numel() + cb.numel() + bb.numel() + BATCH * nprobe) * 4,
                        2.0 * BATCH * n_valid * Dd, unit_of("flat_topk")))
    main3, wide3 = k3.values()
    del wide, wide_bias
    wide3["bound_ms"], wide3["bound_by"] = wide3.pop("bound")
    if wide3["ms"] < wide3["bound_ms"]:
        raise AssertionError(f"flat_topk at {wide3['shape']}: {wide3['ms']} ms is below its "
                             f"bound of {wide3['bound_ms']} ms")
    log(f"[kernel] flat_topk at {wide3['shape']} (body {wide3['body']}): {wide3['ms']:.4f} ms "
        f"(plain {wide3['plain_ms']:.4f} ms, bound {wide3['bound_ms']:.4f} ms by "
        f"{wide3['bound_by']}, {100.0 * wide3['bound_ms'] / wide3['ms']:.1f}% of it reached), "
        f"overlap {wide3['overlap']:.4f}, max key diff {wide3['max_abs_err']}")
    rows.append(dict(main3, name="flat_topk", tol=f"winner overlap >= {OVERLAP_TOL}",
                     launches=launches["flat_topk"], wide=wide3))

    # K1 at the grouped scan's shape.
    pids = probe_lists(torch, idx, q, nprobe)
    qt, inp, args = k1_args(idx, q, pids)
    kk, slot_mult, levels = inp["kk"], inp["slot_mult"], inp["levels"]
    ov1, kd1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, *args)
    real_q = (inp["tgt"] < BATCH * nprobe).sum(1)  # query rows that are real pairs
    b1, groups, scanned = scan_bound(st, inp["gp"], inp["group_size"], real_q,
                                     inp["qg"].numel() * 4, qt, kk, Dd,
                                     unit=unit_of("grouped_scan"))
    rows.append(dict(name="grouped_scan", tol=k1_tol, overlap=ov1, max_abs_err=kd1,
                     launches=launches["grouped_scan"],
                     ms=time_ms(torch, lambda: grouped_scan_kernel(*args)),
                     plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args), reps=2, warmup=1),
                     bound=b1, groups=groups, scanned_rows=scanned))
    # The share of K1's time that is selection (keys, fold, rounds): K1 against
    # its own body built without them (the same loads and products).
    k1_ms = rows[-1]["ms"]
    launch = product_only_k1(torch, k1_build, *args)
    product_ms = time_ms(torch, launch)
    log(f"[kernel] grouped_scan: {k1_ms:.4f} ms, its loads and products alone "
        f"{product_ms:.4f} ms: selection share {1.0 - product_ms / k1_ms:.3f} of K1's time")
    rows[-1]["sampled"] = sampled_bounds(torch, dev, idx, queries, gt, nprobe, "the main index")

    # K2 at the pool merge's shape (argsort placement of the B=16384 batch),
    # on the placed pool as it is; the library call is a top-k of the same
    # pool, the floor an empty kernel on K2's grid (the product-only build).
    g_packed = grouped_scan_kernel(*args)
    m_packed, _ = argsort_placement(g_packed, inp["tgt"], inp["group_size"], pids)
    kfin = min(K, m_packed.shape[1])
    compare_k2(torch, merge_positions, merge_positions_plain, m_packed, kfin, slot_mult)
    bytes2 = (m_packed.numel() + BATCH * kfin) * 4
    rows.append(dict(name="merge_positions", tol="equal", overlap=1.0, max_abs_err=0.0,
                     launches=launches["merge_positions"],
                     ms=time_ms(torch, lambda: merge_positions(m_packed, kfin, slot_mult)),
                     paced_ms=time_ms(torch, lambda: merge_positions(m_packed, kfin, slot_mult),
                                      queued=False),
                     floor_ms=time_ms(torch, empty_launch(torch, k1_build, BATCH)),
                     plain_ms=time_ms(torch, lambda: merge_positions_plain(m_packed, kfin,
                                                                           slot_mult)),
                     library_ms=time_ms(torch, lambda: torch.topk(m_packed, kfin, dim=1)),
                     bound=bound(bytes2, 0.0)))
    torch.cuda.synchronize()
    rows.append(grouping_row(torch, idx, q, pids, launches))

    rows += rowscale_rows(torch, idx, q, pids, qt, kk, by_name)
    group_pid, qlist, _, _ = build_groups(pids, st.codes.shape[0], qt)

    # K1 through v8 (build_groups, gpb 4, global-scale queries and norms).
    gp, ql, gsize, safe_q = pad_groups(group_pid, qlist, st.sizes, 4)
    q_scaled, normsT, _, _ = global_scale(q, st.norms, "l2", levels)
    args8 = (gp, gsize, q_scaled[safe_q].contiguous(), st.codes, normsT, kk, slot_mult, levels)
    ov8, kd8 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, *args8)
    b8, groups, scanned = scan_bound(st, gp, gsize, (ql >= 0).sum(1), args8[2].numel() * 4, qt,
                                     kk, Dd, unit=unit_of("grouped_scan/v8"))
    rows.append(dict(name="grouped_scan/v8", tol=k1_tol, overlap=ov8, max_abs_err=kd8,
                     launches=by_name["v8g4"]["launches"]["grouped_scan"],
                     ms=time_ms(torch, lambda: grouped_scan_kernel(*args8)),
                     plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args8), reps=2, warmup=1),
                     bound=b8, groups=groups, scanned_rows=scanned))

    rows += exact_chunked_rows(torch, idx, q, pids, qt, kk, by_name)
    rows += variant_rows(torch, idx, q, pids, kk, direct)
    return [kernel_entry(r) for r in rows]


def rowscale_rows(torch, idx, q, pids, qt, kk, by_name):
    """Rows of the kernels phase for K4 (v3p: one group a step; v3pN: gpb
    4; v6, gpb 4, which runs K4 on v3pN's inputs: _v6_kernel computes
    _v3pn_kernel's function, and K4 reads only the segments below a
    partition's size) and K5 (v7, gpb 4) at the by-name paths' shapes:
    unscaled queries (rounded to bf16 on a bf16 index), raw norms; against
    the plain version and, on f32 codes, against the plain version on the
    split product's model. On a bf16 index the rows are the bf16 entries."""
    from quake_tpu_torch.ops.grouped import build_groups
    from quake_tpu_torch.ops.grouped_family import (MMA_BODY, rowscale_fold_body, rowscale_scan,
                                                    rowscale_scan_plain, rowscale_topk_body)
    from quake_tpu_torch.ops.grouped_scan import packed_params, pad_groups

    st = idx.store.state
    Dd, dt = st.codes.shape[2], st.codes.dtype
    bf16 = dt == torch.bfloat16
    slot_mult, levels = packed_params(st.codes.shape[1])
    k1_tol = f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level"
    group_pid, qlist, _, _ = build_groups(pids, st.codes.shape[0], qt)
    rows = []
    for entry, path, gpb_n, select in (("rowscale_topk/v3p", "v3p", 1, "topk"),
                                       ("rowscale_topk/v3pn", "v3p4", 4, "topk"),
                                       ("rowscale_fold/v7", "v7g4", 4, "fold"),
                                       ("rowscale_topk/v6", "v6", 4, "topk")):
        entry = bf16_entry(entry) if bf16 else entry
        gp, ql, gsize, safe_q = pad_groups(group_pid, qlist, st.sizes, gpb_n)
        rargs = (gp, gsize, q[safe_q].contiguous(), st.codes, st.norms, kk, slot_mult, levels,
                 "l2", select)
        body = (rowscale_topk_body(qt, Dd, kk, dtype=dt) if select == "topk"
                else rowscale_fold_body(qt, Dd, kk, dt))
        if (body == MMA_BODY) != on_tensor_cores(entry):
            raise AssertionError(f"{entry} at qt={qt}, D={Dd}: body {body} is not the kernels "
                                 "line's unit")
        ov, kd, serr = compare_rowscale(torch, rargs)
        model = {}
        if not bf16:
            ov_m, kd_m, _ = compare_rowscale(torch, rargs, model=True)
            model = dict(model_overlap=ov_m, model_max_abs_err=kd_m)
        b, groups, scanned = scan_bound(st, gp, gsize, (ql >= 0).sum(1),
                                        rargs[2].numel() * rargs[2].element_size(),
                                        qt, kk, Dd, extra=gp.numel() * qt * 2 * 4,
                                        unit=unit_of(entry))
        rows.append(dict(name=entry, tol=f"{k1_tol}, stats rtol = atol = {STATS_TOL}",
                         overlap=ov, max_abs_err=kd, stats_err=serr, body=body, **model,
                         launches=by_name[path]["launches"][ENTRIES[entry][0]],
                         ms=time_ms(torch, lambda: rowscale_scan(*rargs), reps=5),
                         plain_ms=time_ms(torch, lambda: rowscale_scan_plain(*rargs), reps=2,
                                          warmup=1),
                         bound=b, groups=groups, scanned_rows=scanned))
    return rows


def grouping_row(torch, idx, q, pids, launches) -> dict:
    """The kernels line's row of the grouping kernels (group_tables_kernel's
    four launches, group_tables/f32 or /bf16 by the codes' dtype) on idx's
    default (v11) path for the batch q with probe lists pids: every output
    held to the plain version bit for bit (compare_grouping), the four
    launches' device time, the plain version's (its ~110 PyTorch operations,
    also timed on the device), and a bound by bytes: the probe lists, the
    queries, sizes and norms read once; the query tiles, normsT, tgt, gp and
    group_size written once. launches: the path's counts."""
    from quake_tpu_torch.ops.grouped_scan import (group_tables_kernel, group_tables_plain,
                                                  packed_params)

    st = idx.store.state
    P, C, Dd = st.codes.shape
    B, M = pids.shape
    qt = idx._grouped_params(B, M)[0]
    gpb = int(idx._grouped_kernel()[len("v11g"):])
    args = (st.codes, st.sizes, st.norms, q, pids, "l2", qt, gpb, packed_params(C)[1])
    got = compare_grouping(torch, args)
    Gn = got["gp"].shape[0]
    nbytes = (4 * (B * M + q.numel() + P + 2 * st.norms.numel() + Gn * qt + 2 * Gn)
              + got["qg"].numel() * got["qg"].element_size())
    dtype = str(st.codes.dtype)[len("torch."):]
    del got
    return dict(name=f"group_tables/{'bf16' if dtype == 'bfloat16' else 'f32'}",
                tol="equal to every bit", overlap=1.0, max_abs_err=0.0,
                launches=launches["group_tables"], body="CUDA cores",
                shape=f"B={B}, nprobe={M}, P={P}, C={C}, D={Dd}, qt={qt}, Gn={Gn}, {dtype}",
                ms=time_ms(torch, lambda: group_tables_kernel(*args)),
                plain_ms=time_ms(torch, lambda: group_tables_plain(*args), reps=3, warmup=1),
                bound=bound(nbytes, 0.0))


def kernel_entry(r: dict) -> dict:
    """A row of phase_kernels (or of the headline bf16 phase) checked
    against its bound, logged, and turned into its entry of the kernels
    line."""
    r["bound_ms"], r["bound_by"] = r.pop("bound")
    kernel, source, replaces = ENTRIES[r["name"]]
    lib = r.get("library_ms")
    unit = unit_of(r["name"])
    if r["ms"] < r["bound_ms"]:
        raise AssertionError(f"{r['name']}: {r['ms']} ms is below its bound of "
                             f"{r['bound_ms']} ms ({r['bound_by']}, {unit}): the bound is "
                             "not one of the card's peak for the operands")
    log(f"[kernel] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} on the {unit}, "
        f"{100.0 * r['bound_ms'] / r['ms']:.1f}% of it reached"
        + (f", library {lib:.4f} ms" if lib is not None else "")
        + (f", host-paced {r['paced_ms']:.4f} ms" if "paced_ms" in r else "")
        + (f", empty launch {r['floor_ms']:.4f} ms" if "floor_ms" in r else "")
        + (f", at {r['shape']} (body {r['body']})" if "shape" in r else "")
        + (f", body {r['body']}" if "body" in r and "shape" not in r else "")
        + f"), overlap {r['overlap']:.4f}, max {r.get('err_of', 'key diff')} {r['max_abs_err']}"
        + (f", max stats error {r['stats_err']:.3g}" if "stats_err" in r else "")
        + f" ({r['tol']}), launches on its path {r['launches']}"
        + (f", groups {r['groups']}, scanned rows {r['scanned_rows']}" if "groups" in r else ""))
    entry = {"name": r["name"], "kernel": kernel, "route": "cuda", "source": source,
             "replaces": replaces, "launches": r["launches"],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "bound_unit": unit, "library_ms": lib}
    for extra in ("shape", "floor_ms", "body", "model_overlap", "model_max_abs_err",
                  "sampled", "f128_ms"):
        if extra in r:
            entry[extra] = r[extra]
    if "wide" in r:
        entry["second_shape"] = {f: r["wide"][f] for f in ("shape", "ms", "plain_ms", "bound_ms",
                                                          "bound_by", "max_abs_err")}
    return entry


def phase_bf16_by_name(torch, dev, idx, queries, gt, nprobe, recall):
    """Phase 11b, "bf16 by name", on the headline bf16 index at the headline
    nprobe: every scan of BF16_BY_NAME through QUAKE_TPU_KERNEL and every
    direct scan of BF16_DIRECT, each with its recall@10 against the exact
    scan of the same probed partitions of the bf16 codes, ms per B=16384
    batch and its launches (the path's _bf16 kernels must launch, their f32
    twins must not), gated as in phases 5 and 6; then the rows of the
    kernels line for the bf16 bodies of K4-K9, sized_topk and multi_topk at
    those paths' shapes (the batch rounded to bf16, as the wrappers round
    it), each held to its plain version, its time and its bound (2 bytes an
    element; one bf16 product on the tensor cores, v4's chunk table on the
    CUDA cores). Returns (summary, the kernels line's bf16 entries)."""
    by_name = phase_by_name(torch, dev, idx, queries, gt, nprobe, recall, paths=BF16_BY_NAME,
                            tag="bf16 by name", placement=False)
    direct = phase_direct(torch, dev, idx, queries, gt, nprobe, by_name["reference"]["recall"],
                          paths=BF16_DIRECT, tag="bf16 direct")
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    pids = probe_lists(torch, idx, q, nprobe)
    qt, kk = idx._grouped_params(BATCH, nprobe)[0], min(K, idx.store.C)
    qb = q.to(torch.bfloat16)
    rows = rowscale_rows(torch, idx, qb, pids, qt, kk, by_name)
    rows += exact_chunked_rows(torch, idx, qb, pids, qt, kk, by_name)
    rows += variant_rows(torch, idx, qb, pids, kk, direct)
    return dict(by_name=by_name, direct=direct), [kernel_entry(r) for r in rows]


def k3_row(torch, name, cb, bb, q, nprobe, launches) -> dict:
    """K3 (flat_topk) against its plain version on the buffer cb with bias
    bb for the batch q (in cb's dtype), its time, plain time and bound:
    each input read once (at its element size), the slots written once,
    2 D flops a (query, valid row) on the unit of the entry `name`."""
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_body, flat_topk_plain

    ov, kd = compare_k3(torch, flat_topk, flat_topk_plain, cb, bb, q, nprobe, "l2")
    n_valid = int((bb > float("-inf")).sum())
    B, Dd = q.shape
    return dict(
        name=name, shape=f"B={B}, N={cb.shape[0]}, D={Dd}",
        body=flat_topk_body(cb.shape[0], Dd, cb.dtype), overlap=ov, max_abs_err=kd,
        tol=f"winner overlap >= {OVERLAP_TOL}", launches=launches,
        ms=time_ms(torch, lambda: flat_topk(cb, bb, q, nprobe, "l2")),
        plain_ms=time_ms(torch, lambda: flat_topk_plain(cb, bb, q, nprobe, "l2"), reps=3,
                         warmup=1),
        bound=bound((q.numel() + cb.numel()) * q.element_size() + (bb.numel() + B * nprobe) * 4,
                    2.0 * B * n_valid * Dd, unit_of(name)))


def phase_bf16_parent(torch, dev, x, queries, gt, f32_idx, nprobe):
    """Phase 11c, a bf16 parent: the main corpus built through QuakeIndex
    with IndexBuildParams(parent_params=IndexBuildParams(precision="bf16"))
    (f32 codes under a bf16 parent: each parent row the bf16 rounding of its
    partition's centroid); a B=16384 batch at the main nprobe with its
    launches counted (BF16_PARENT_KERNELS must launch: K3's bf16 body ranks
    the parents; the f32 K3 must not) and its recall@10 on the 1024 queries
    at most BF16_PARENT_RECALL_TOL below the f32 parent's; a save and a load
    (the parent bf16 bit for bit, search ids equal); then K3's bf16 body
    against its plain version at the parent ranking's shape and with
    K3_WIDE_N corpus rows (rounded to bf16) as its buffer, timed beside its
    bound. Returns (summary, the kernels line's flat_topk_bf16 entry)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, _ext
    from quake_tpu_torch.ops.flat_topk import parent_bias
    from quake_tpu_torch.utils import compute_recall

    out = {}
    t0 = time.perf_counter()
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(N, dtype=np.int64),
              IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER, calibrate_aps=False,
                               parent_params=IndexBuildParams(precision="bf16")))
    out["build_s"] = time.perf_counter() - t0
    st, pst = idx.store.state, idx.parent.store.state
    if st.codes.dtype != torch.float32 or pst.codes.dtype != torch.bfloat16:
        raise AssertionError("the index must hold f32 codes under a bf16 parent")
    live = pst.ids >= 0
    if not torch.equal(pst.codes[live].view(torch.int16),
                       st.centroids[pst.ids[live].long()].to(torch.bfloat16).view(torch.int16)):
        raise AssertionError("a bf16 parent row is not the rounding of its partition's centroid")

    sp = SearchParams(k=K, nprobe=nprobe)
    qd = torch.from_numpy(queries[:BATCH]).to(dev)
    torch.cuda.synchronize()
    _ext.reset_launches()
    res = idx.search(queries[:NQ_GT], sp)
    out["B16384"] = time_batch(torch, idx, qd, sp, gt)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    if any(launches[k] <= 0 for k in BF16_PARENT_KERNELS) or launches["flat_topk"] != 0:
        raise AssertionError(f"the bf16-parent path must launch {BF16_PARENT_KERNELS} and not "
                             f"the f32 K3: {launches}")
    r = compute_recall(res.ids, gt, K)
    r32 = compute_recall(f32_idx.search(queries[:NQ_GT], sp).ids, gt, K)
    if r < r32 - BF16_PARENT_RECALL_TOL:
        raise AssertionError(f"bf16 parent: recall@10 {r} is more than {BF16_PARENT_RECALL_TOL} "
                             f"below the f32 parent's {r32}")
    out.update(recall=r, f32_parent_recall=r32, launches=launches)
    log(f"[bf16 parent] build {out['build_s']:.2f} s, nlist={idx.nlist()}, parent "
        f"{tuple(pst.codes.shape)} bf16; nprobe {nprobe}: recall@10={r:.4f} (f32 parent "
        f"{r32:.4f}); B={BATCH}: {batch_text(out['B16384'])}; launches {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = QuakeIndex(device=dev).load(tmp)
    lp = loaded.parent.store.state
    if lp.codes.dtype != torch.bfloat16 or not torch.equal(lp.codes.view(torch.int16),
                                                           pst.codes.view(torch.int16)):
        raise AssertionError("the loaded bf16 parent differs from the saved one")
    if not np.array_equal(loaded.search(queries[:NQ_GT], sp).ids, res.ids):
        raise AssertionError("the loaded bf16-parent index searches to other ids")
    del loaded
    log("[bf16 parent] save and load: the parent bf16 bit for bit, search ids equal")

    # K3's bf16 body at the parent ranking's shape and with K3_WIDE_N rows.
    Pp, Cp, Dd = pst.codes.shape
    qb = qd.to(torch.bfloat16)
    main = k3_row(torch, "flat_topk_bf16", pst.codes.reshape(Pp * Cp, Dd).contiguous(),
                  parent_bias(pst.ids, pst.norms, "l2"), qb, nprobe, launches["flat_topk_bf16"])
    wide = torch.from_numpy(x[:K3_WIDE_N]).to(dev).to(torch.bfloat16)
    wide3 = k3_row(torch, "flat_topk_bf16", wide, (-(wide.float() ** 2).sum(1)).contiguous(),
                   qb, nprobe, 0)
    for row in (main, wide3):
        if row["body"] == 0:
            raise AssertionError(f"flat_topk_bf16 at {row['shape']}: the launcher must pick the "
                                 "tensor-core body")
    wide3["bound_ms"], wide3["bound_by"] = wide3.pop("bound")
    if wide3["ms"] < wide3["bound_ms"]:
        raise AssertionError(f"flat_topk_bf16 at {wide3['shape']}: {wide3['ms']} ms is below "
                             f"its bound of {wide3['bound_ms']} ms")
    log(f"[kernel] flat_topk_bf16 at {wide3['shape']} (body {wide3['body']}): "
        f"{wide3['ms']:.4f} ms (plain {wide3['plain_ms']:.4f} ms, bound {wide3['bound_ms']:.4f} "
        f"ms by {wide3['bound_by']}), overlap {wide3['overlap']:.4f}, max key diff "
        f"{wide3['max_abs_err']}")
    main["wide"] = wide3
    return out, kernel_entry(main)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_headline_bf16(torch, dev, x, queries, gt, f32_idx, k1_build):
    """bench.py's headline serving mode at full width (phase 11 of the
    module's docstring): build, nprobe, the headline path timed with its
    launches counted, the f32 and the exact paths beside it, K1's bf16 body
    and the grouping kernels gated and timed at the path's shapes, save and
    load. Returns (summary, the kernels line's grouped_scan_bf16 and
    group_tables/bf16 entries, the bf16 index)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, _ext
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  grouped_scan_uses_mma)
    from quake_tpu_torch.utils import compute_recall

    card = card_line()
    out = {}
    t0 = time.perf_counter()
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(N, dtype=np.int64),
              IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER, precision="bf16",
                               calibrate_aps=False))
    out["build_s"] = time.perf_counter() - t0
    st = idx.store.state
    if st.codes.dtype != torch.bfloat16 or idx.parent.store.state.codes.dtype != torch.float32:
        raise AssertionError("the headline index must hold bf16 codes under an f32 parent")
    out.update(P=idx.store.P, C=idx.store.C, nlist=idx.nlist(), kernel=idx._grouped_kernel(),
               codes_bytes=st.codes.numel() * st.codes.element_size(),
               f32_codes_bytes=f32_idx.store.state.codes.numel() * 4,
               store_bytes=sum(t.numel() * t.element_size()
                               for t in (st.codes, st.ids, st.norms, st.sizes)))
    log(f"[headline bf16] build {out['build_s']:.2f} s: nlist={out['nlist']} P={out['P']} "
        f"C={out['C']} scan {out['kernel']}, codes {out['codes_bytes'] / 1e9:.3f} GB (f32 "
        f"{out['f32_codes_bytes'] / 1e9:.3f} GB), store {out['store_bytes'] / 1e9:.3f} GB")

    q_gt = queries[:NQ_GT]
    chosen = None
    for nprobe in NPROBE_GRID:
        res = idx.search(q_gt, SearchParams(k=K, nprobe=nprobe, exact_distances=False))
        r = compute_recall(res.ids, gt, K)
        log(f"[headline bf16] nprobe={nprobe} recall@10={r:.4f} (exact_distances=False, against "
            "the exact ground truth over the f32 vectors)")
        if r >= RECALL_GATE:
            chosen = (nprobe, r, res)
            break
    if chosen is None:
        raise AssertionError(f"bf16, exact_distances=False: no nprobe in {NPROBE_GRID} reaches "
                             f"recall {RECALL_GATE}")
    nprobe, recall, res = chosen
    if res.ids.shape != (NQ_GT, K) or not np.isfinite(res.distances[res.ids >= 0]).all():
        raise AssertionError("bf16 search results have the wrong shape or non-finite distances")
    out.update(nprobe=nprobe, recall=recall)

    # The headline path, its launches counted from 0 just before it.
    sp = SearchParams(k=K, nprobe=nprobe, exact_distances=False)
    qd = {B: torch.from_numpy(queries[:B]).to(dev) for B in (BATCH, BATCH_SORTED)}
    torch.cuda.synchronize()
    _ext.reset_launches()
    for B in (BATCH, BATCH_SORTED):
        out[f"B{B}"] = dict(time_batch(torch, idx, qd[B], sp, gt),
                            placement=placement_of(idx, B, nprobe),
                            qt=idx._grouped_params(B, nprobe)[0])
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    missing = [k for k in BF16_MAIN_KERNELS if launches[k] <= 0]
    if missing or launches["grouped_scan"] != 0:
        raise AssertionError(f"the headline bf16 path must launch {BF16_MAIN_KERNELS} and not the "
                             f"f32 K1: {launches}")
    out["launches"] = launches
    for B in (BATCH, BATCH_SORTED):
        r = out[f"B{B}"]
        log(f"[headline bf16] ({card}) B={B} ({r['placement']} placement, qt={r['qt']}, nprobe "
            f"{nprobe}, exact_distances=False): {batch_text(r)}")
    log(f"[headline bf16] kernel launches on the headline path: {launches}")
    out["idle"] = idle_share(torch, f"headline bf16, B={BATCH} at nprobe {nprobe}",
                             lambda: idx._search_device_full(qd[BATCH], sp))

    # Beside it, at the same nprobe: the f32 index dequantized (bf16's share
    # apart from the rescore's), the bf16 index and the f32 index exact.
    for name, index, exact in (("f32_inexact", f32_idx, False), ("bf16_exact", idx, True),
                               ("f32_exact", f32_idx, True)):
        spx = SearchParams(k=K, nprobe=nprobe, exact_distances=exact)
        for B in (BATCH, BATCH_SORTED):
            out[f"{name}_B{B}"] = time_batch(torch, index, qd[B], spx, gt)
            log(f"[headline bf16] ({card}) beside it, {name} B={B}: "
                f"{batch_text(out[f'{name}_B{B}'])}")

    # K1's bf16 body at the headline shapes: its gates (with K2's and K3's),
    # its time, its bound, and the f32 K1 on the f32 index at the same batch.
    q = qd[BATCH]
    pids = probe_lists(torch, idx, q, nprobe)
    qt, inp, args = k1_args(idx, q, pids)
    if not grouped_scan_uses_mma(qt, D, torch.bfloat16):
        raise AssertionError(f"K1 bf16 at qt={qt}, D={D}: the launcher must pick the tensor-core "
                             "body")
    gates = main_kernel_gates(torch, idx, q, pids, nprobe)
    real_q = (inp["tgt"] < BATCH * nprobe).sum(1)
    b, groups, scanned = scan_bound(st, inp["gp"], inp["group_size"], real_q,
                                    inp["qg"].numel() * 2, qt, inp["kk"], D,
                                    unit=unit_of("grouped_scan_bf16"))
    f32_args = k1_args(f32_idx, q, probe_lists(torch, f32_idx, q, nprobe))[2]
    row = dict(name="grouped_scan_bf16",
               tol=f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level",
               overlap=gates["k1_overlap"], max_abs_err=gates["k1_max_key_diff"],
               launches=launches["grouped_scan_bf16"], body="tensor cores",
               shape=f"B={BATCH}, nprobe={nprobe}, qt={qt}, D={D}, C={idx.store.C}",
               ms=time_ms(torch, lambda: grouped_scan_kernel(*args)),
               plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args), reps=2, warmup=1),
               bound=b, groups=groups, scanned_rows=scanned)
    out["k1"] = dict(ms=row["ms"], f32_ms=time_ms(torch, lambda: grouped_scan_kernel(*f32_args)),
                     product_ms=time_ms(torch, product_only_k1(torch, k1_build, *args)),
                     gates=gates)
    log(f"[headline bf16] ({card}) K1 bf16 {row['ms']:.4f} ms against the f32 K1's "
        f"{out['k1']['f32_ms']:.4f} ms at the same batch; its loads and products alone "
        f"{out['k1']['product_ms']:.4f} ms: selection share "
        f"{1.0 - out['k1']['product_ms'] / row['ms']:.3f}; {gates_text(gates)}")
    entries = [kernel_entry(row), kernel_entry(grouping_row(torch, idx, q, pids, launches))]
    del args, f32_args

    # Save and load.
    with tempfile.TemporaryDirectory() as tmp:
        p16, p32 = os.path.join(tmp, "bf16"), os.path.join(tmp, "f32")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.save(p16)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = QuakeIndex(device=dev).load(p16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        f32_idx.save(p32)
        sizes = dir_bytes(p16), dir_bytes(p32)
    ls = loaded.store.state
    if ls.codes.dtype != torch.bfloat16 or not torch.equal(ls.codes.view(torch.int16),
                                                           st.codes.view(torch.int16)):
        raise AssertionError("the loaded bf16 codes differ from the saved ones")
    if sizes[0] > BF16_CHECKPOINT_RATIO * sizes[1]:
        raise AssertionError(f"the bf16 checkpoint holds {sizes[0]} bytes, the f32 one {sizes[1]}")
    if not np.array_equal(loaded.search(q_gt, sp).ids, idx.search(q_gt, sp).ids):
        raise AssertionError("the loaded bf16 index searches to other ids")
    del loaded
    out["save_load"] = dict(save_s=save_s, load_s=load_s, bytes=sizes[0], f32_bytes=sizes[1])
    log(f"[headline bf16] ({card}) save {sizes[0] / 1e9:.3f} GB in {save_s:.3f} s, load "
        f"{load_s:.3f} s; the f32 checkpoint {sizes[1] / 1e9:.3f} GB (ratio "
        f"{sizes[0] / sizes[1]:.3f}); codes equal bit for bit, search ids equal")
    return out, entries, idx


def oneshot_plan(idx, q, sp):
    """The masked pid matrix and the pair budget that idx's pinned oneshot
    search for the batch q hands to the grouped scan (recorded from
    coordinator.grouped_scan during one search), with its qt and gpb."""
    from quake_tpu_torch import coordinator

    seen = []
    real = coordinator.grouped_scan

    def record(*a, **kw):  # (codes, ids, sizes, norms, q, pids, k, metric, qt, ...)
        seen.append((a[5], kw.get("pair_budget", 0), a[8]))
        return real(*a, **kw)
    coordinator.grouped_scan = record
    try:
        idx._search_device_full(q, sp)
    finally:
        coordinator.grouped_scan = real
    (eff, pair_budget, qt), = seen
    return eff, pair_budget, qt, int(idx._grouped_kernel()[len("v11g"):])


def budget_by_formula(idx, q, sp, what: str) -> None:
    """Where idx's calibration left the pair budget off, turn it on with the
    width_clip and budget_w that the JAX package's formula
    (quake_tpu/index.py:679-682) gives over the unbudgeted oneshot plans of
    the batch q, and say so."""
    if idx.aps_width_clip and idx.aps_budget_w:
        return
    eff = oneshot_plan(idx, q, sp)[0]
    sc = (eff >= 0).sum(1).double().cpu().numpy()
    wclip = int(min(-(-int(np.quantile(sc, 0.99) + 4) // 8) * 8, eff.shape[1]))
    bw = int(min(-(-int(1.15 * sc.mean() + 2) // 4) * 4, wclip))
    idx.aps_width_clip, idx.aps_budget_w = wclip, bw
    log(f"[aps] the calibration left the budget off on {what}; it runs with "
        f"width_clip={wclip}, budget_w={bw} (the JAX formula over this batch)")


def recorded_calls(fn, clone: bool = False):
    """fn() with the inputs of every K1, K2 and K3 call and of every call of
    the grouping kernels (group_tables_kernel) recorded, each call going
    through to its wrapper. Returns the lists of (budget, K1's arguments),
    K2's (the pool copied: the tail reads it afterwards), K3's and the
    grouping's; with clone, K1's, K3's and the grouping's tensors are copied
    too (for a check after later operations have written the store)."""
    from quake_tpu_torch.ops import flat_topk as k3_mod
    from quake_tpu_torch.ops import grouped_family as fam
    from quake_tpu_torch.ops import grouped_scan as k12_mod

    k1, k2, k3, kg = [], [], [], []
    real = (k12_mod.grouped_scan_kernel, k12_mod.merge_positions, k3_mod.flat_topk,
            k12_mod.group_tables_kernel)

    def kept(a):
        return tuple(t.clone() if clone and hasattr(t, "clone") else t for t in a)

    def rec1(*a, budget=False):
        k1.append((budget, kept(a)))
        return real[0](*a, budget=budget)

    def rec2(m_packed, *a):
        k2.append((m_packed.clone(),) + a)
        return real[1](m_packed, *a)

    def rec3(*a):
        k3.append(kept(a))
        return real[2](*a)

    def recg(*a):
        kg.append(kept(a))
        return real[3](*a)
    (k12_mod.grouped_scan_kernel, k12_mod.merge_positions, k3_mod.flat_topk,
     k12_mod.group_tables_kernel) = rec1, rec2, rec3, recg
    fam.grouped_scan_kernel = rec1  # v8 and v9 call K1 from there
    try:
        fn()
    finally:
        (k12_mod.grouped_scan_kernel, k12_mod.merge_positions, k3_mod.flat_topk,
         k12_mod.group_tables_kernel) = real
        fam.grouped_scan_kernel = real[0]
    return k1, k2, k3, kg


def check_recorded(torch, what: str, calls, summary: dict) -> None:
    """Each recorded K1, K2, K3 and grouping call (recorded_calls) held
    against its plain version on the same inputs (compare_k1, _k2, _k3,
    compare_grouping: the grouping to every bit, noted under each of its
    four launch names); per launch counter, the calls, their shapes, the
    least overlap and the largest key difference gathered into summary."""
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_plain
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  merge_positions, merge_positions_plain)

    def note(name, shape, ov, kd):
        s = summary.setdefault(name, dict(calls=0, shapes=[], min_overlap=1.0, max_key_diff=0.0))
        s["calls"] += 1
        if shape not in s["shapes"]:
            s["shapes"].append(shape)
        s["min_overlap"], s["max_key_diff"] = min(s["min_overlap"], ov), max(s["max_key_diff"], kd)

    k1, k2, k3, kg = calls
    for budget, a in k1:
        name = (("grouped_scan_budget" if budget else "grouped_scan")
                + ("_bf16" if a[3].dtype == torch.bfloat16 else ""))
        kernel = functools.partial(grouped_scan_kernel, budget=budget)
        ov, kd = compare_k1(torch, kernel, grouped_scan_plain, *a[:9])
        note(name, f"{what}: Gn={a[0].shape[0]}, qt={a[2].shape[1]}, kk={a[5]}"
             + (f", fold {a[8]}" if len(a) > 8 and a[8] != 128 else ""), ov, kd)
    for m_packed, kfin, slot_mult in k2:
        compare_k2(torch, merge_positions, merge_positions_plain, m_packed, kfin, slot_mult)
        note("merge_positions", f"{what}: B={m_packed.shape[0]}, pool={m_packed.shape[1]}, "
             f"kfin={kfin}", 1.0, 0.0)
    for codes2d, bias, q, k, metric in k3:
        ov, kd = compare_k3(torch, flat_topk, flat_topk_plain, codes2d, bias, q, k, metric)
        note("flat_topk", f"{what}: B={q.shape[0]}, N={codes2d.shape[0]}, k={k}", ov, kd)
    for a in kg:
        got = compare_grouping(torch, a)
        shape = (f"{what}: B={a[3].shape[0]}, M={a[4].shape[1]}, P={a[0].shape[0]}, "
                 f"Gn={got['gp'].shape[0]}, qt={a[6]}, {str(a[0].dtype)[len('torch.'):]}"
                 + (f", budget {a[10]}" if len(a) > 10 and a[10] > 0 else "")
                 + (f", {a[9]} bounds" if len(a) > 9 and a[9] != "analytic" else ""))
        for name in GROUPING:
            note(name, shape, 1.0, 0.0)


def budget_entry(torch, idx, q, plan, launches) -> dict:
    """The kernels line's entry of K1 on the budget grid (grouped_scan_budget,
    or _bf16 on bf16 codes) at plan, oneshot_plan's record of idx's pinned
    oneshot search of the batch q: the launcher must pick the tensor-core
    body; held against its plain version, its time, plain time and bound
    over the grid's real pairs; launches is the count of the path's own
    run."""
    from quake_tpu_torch.ops.grouped_scan import (grouped_scan_kernel, grouped_scan_plain,
                                                  grouped_scan_uses_mma, v11_inputs)

    st = idx.store.state
    name = ("grouped_scan_budget_bf16" if st.codes.dtype == torch.bfloat16
            else "grouped_scan_budget")
    eff, pair_budget, qt, gpb = plan
    if pair_budget <= 0:
        raise AssertionError(f"{name}: the pinned oneshot ran unbudgeted")
    if not grouped_scan_uses_mma(qt, D, st.codes.dtype):
        raise AssertionError(f"{name} at qt={qt}, D={D}: the launcher must pick the tensor-core "
                             "body")
    inp = v11_inputs(st.codes, st.sizes, st.norms, q, eff, K, "l2", qt, gpb,
                     pair_budget=pair_budget)
    args = (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], inp["kk"],
            inp["slot_mult"], inp["levels"])
    kernel = functools.partial(grouped_scan_kernel, budget=True)
    ov, kd = compare_k1(torch, kernel, grouped_scan_plain, *args)
    real_q = (inp["tgt"] < eff.numel()).sum(1)
    b, groups, scanned = scan_bound(st, inp["gp"], inp["group_size"], real_q,
                                    inp["qg"].numel() * inp["qg"].element_size(), qt, inp["kk"],
                                    D, unit=unit_of(name))
    valid = int((eff >= 0).sum())
    return kernel_entry(dict(
        name=name, tol=f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level",
        overlap=ov, max_abs_err=kd, launches=launches[name], body="tensor cores",
        shape=(f"B={q.shape[0]}, W={eff.shape[1]}, budget {pair_budget} pairs ({valid} valid), "
               f"Gn={inp['gp'].shape[0]}, qt={qt}, D={D}, C={st.codes.shape[1]}, "
               f"{str(st.codes.dtype)[len('torch.'):]}"),
        ms=time_ms(torch, lambda: kernel(*args)),
        plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args), reps=2, warmup=1),
        bound=b, groups=groups, scanned_rows=scanned))


def time_aps(torch, idx, q, sp, loop: bool = False) -> dict:
    """A batch q through the recall-target search (idx._search_device_full):
    device ms per batch (CUDA events, 5 reps; the loop, which reads a flag
    from the device each step, host-paced), QPS, the mean partitions scanned
    (as the search's `scanned` holds them, or the dense route's width), and
    the loop's steps and syncs; the results' shape and finiteness checked."""
    B = q.shape[0]
    ms = time_ms(torch, lambda: idx._search_device_full(q, sp), reps=5, queued=not loop)
    _, ids32, timing, dists = idx._search_device_full(q, sp)
    scanned = getattr(timing, "_scanned_dev", None)
    mean_scanned = (float(scanned.float().mean()) if scanned is not None
                    else float(timing.partitions_scanned))
    ids_np = ids32.cpu().numpy()
    if ids_np.shape != (B, K) or (ids_np < 0).any() or not torch.isfinite(dists).all():
        raise AssertionError(f"APS {sp.aps_mode}: expected {K} ids and finite distances a query")
    return dict(ms=ms, qps=B / (ms / 1e3), scanned=mean_scanned, steps=timing.aps_loop_steps,
                syncs=timing.aps_loop_syncs)


def phase_aps(torch, dev, x, queries, gt, bf16_idx):
    """Recall-target search (APS) at full width (phase 12 of the module's
    docstring), in bench_suite.py::run_aps_batch's configuration: build
    with default parameters (calibrate_aps), the calibrated fields (the
    budget set by the JAX formula where the calibration left it off), each
    aps_mode's B=APS_BATCH batch with the launches counted from 0 just
    before the four modes and read just after, every K1, K2 and K3 call of
    each mode's batch held against its plain version, each mode's recall on
    the first NQ_GT queries and its times, the fixed-nprobe anchor, B=64
    latency, the budgeted scan's K1 at the pinned oneshot's plan (its
    entry) and v10b against v10; then a pinned oneshot exact_distances=False
    batch on the headline bf16 index after its calibrate_aps, counted and
    checked alike (its K1 budget entry). Returns (summary, the kernels
    line's grouped_scan_budget and grouped_scan_budget_bf16 entries, the
    index, which the fold phase reads)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams, _ext
    from quake_tpu_torch.index import APS_FIELDS
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_v10, grouped_scan_v10b
    from quake_tpu_torch.utils import compute_recall

    card = card_line()
    out = {}
    idx = QuakeIndex(device=dev)
    calib_s = []
    plain_calibrate = idx.calibrate_aps

    def timed_calibrate(*a, **kw):  # the build's own call, timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain_calibrate(*a, **kw)
        torch.cuda.synchronize()
        calib_s.append(time.perf_counter() - t)
    idx.calibrate_aps = timed_calibrate
    t0 = time.perf_counter()
    idx.build(x, np.arange(N, dtype=np.int64), IndexBuildParams(nlist=APS_NLIST))
    out["build_s"] = time.perf_counter() - t0
    del idx.calibrate_aps
    if len(calib_s) != 1:
        raise AssertionError("the default build did not calibrate APS")
    st = idx.store.state
    out.update(calibrate_s=calib_s[0], nlist=idx.nlist(), P=idx.store.P, C=idx.store.C,
               kernel=idx._grouped_kernel(),
               store_bytes=sum(t.numel() * t.element_size()
                               for t in (st.codes, st.ids, st.norms, st.sizes)),
               fields={f: getattr(idx, f) for f in APS_FIELDS if f != "aps_radius_ab"})
    out["fields"]["aps_radius_ab_k10"] = (None if idx.aps_radius_ab is None
                                          else idx.aps_radius_ab[K - 1].tolist())
    log(f"[aps] ({card}) build {out['build_s']:.2f} s, calibrate_aps {calib_s[0]:.2f} s of it: "
        f"nlist={out['nlist']} P={out['P']} C={out['C']} scan {out['kernel']} store "
        f"{out['store_bytes'] / 1e9:.3f} GB; calibrated {json.dumps(out['fields'])}")

    qd = {B: torch.from_numpy(queries[:B]).to(dev) for B in (NQ_GT, APS_BATCH, 64)}
    q = qd[APS_BATCH]
    sps = {mode: SearchParams(k=K, recall_target=APS_TARGET, aps_mode=mode)
           for mode in APS_MODES}
    out["budget_calibrated"] = bool(idx.aps_width_clip and idx.aps_budget_w)
    budget_by_formula(idx, q, sps["oneshot"], "the f32 index")
    torch.cuda.synchronize()
    _ext.reset_launches()
    for mode in APS_MODES:  # the APS path: each mode's batch once
        idx._search_device_full(q, sps[mode])
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    out["launches"] = launches
    log(f"[aps] kernel launches on the APS path (one B={APS_BATCH} batch of each of "
        f"{APS_MODES}): {launches}")
    need = ["flat_topk", "merge_positions", "grouped_scan", "grouped_scan_budget"]
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"the APS path must launch {need}: {launches}")
    checks = {}
    for mode in APS_MODES:
        check_recorded(torch, mode, recorded_calls(
            functools.partial(idx._search_device_full, q, sps[mode])), checks)
    if set(checks) != {k for k, n in launches.items() if n}:
        raise AssertionError(f"the recorded calls ({sorted(checks)}) are not the kernels the APS "
                             f"path launched ({launches})")
    out["kernel_checks"] = checks
    log(f"[aps] ({card}) every K1, K2 and K3 call of each mode's B={APS_BATCH} batch against its "
        f"plain version (K1 and K3: winner overlap >= {OVERLAP_TOL}, common keys within 1 "
        f"level; K2 equal): {json.dumps(checks)}")

    for mode in APS_MODES:
        res = idx.search(queries[:NQ_GT], sps[mode])
        recall = compute_recall(res.ids, gt, K)
        r = dict(time_aps(torch, idx, q, sps[mode], loop=mode == "loop"),
                 recall=recall, scanned_first_1024=res.timing_info.partitions_scanned)
        out[mode] = r
        log(f"[aps] ({card}) {mode}: recall@10 {recall:.4f} (B={NQ_GT}), B={APS_BATCH} "
            f"{r['ms']:.3f} ms/batch, {r['qps']:,.0f} QPS, mean partitions scanned "
            f"{r['scanned']:.2f}" + (f", loop steps {r['steps']}, host syncs {r['syncs']}"
                                    if mode == "loop" else ""))
        if recall < APS_RECALL_GATES[mode]:
            raise AssertionError(f"APS {mode}: recall@10 {recall:.4f} below "
                                 f"{APS_RECALL_GATES[mode]}")

    # The fixed-nprobe anchor, as run_aps_batch takes it.
    anchor = None
    for nprobe in APS_ANCHOR:
        res = idx.search(queries[:NQ_GT], SearchParams(k=K, nprobe=nprobe))
        r = compute_recall(res.ids, gt, K)
        anchor = (nprobe, r)
        if r >= APS_TARGET:
            break
    spf = SearchParams(k=K, nprobe=anchor[0])
    f_ms = time_ms(torch, lambda: idx._search_device_full(q, spf), reps=5)
    out["fixed"] = dict(nprobe=anchor[0], recall=anchor[1], ms=f_ms, qps=APS_BATCH / (f_ms / 1e3))
    out["fixed_over_aps_qps"] = out["fixed"]["qps"] / out["auto"]["qps"]
    host = []
    for _ in range(10):
        t = time.perf_counter()
        idx.search(queries[:64], sps["auto"])
        host.append((time.perf_counter() - t) * 1e3)
    out["auto_b64_host_ms"] = float(np.mean(host))
    log(f"[aps] ({card}) fixed nprobe {anchor[0]}: recall@10 {anchor[1]:.4f}, B={APS_BATCH} "
        f"{f_ms:.3f} ms/batch; fixed/APS(auto) QPS {out['fixed_over_aps_qps']:.3f}; auto B=64 "
        f"{out['auto_b64_host_ms']:.3f} ms a search on the host clock (mean of 10)")

    # The budgeted scan at the pinned oneshot's plan: K1 on the budget grid
    # (its entry), v10b against v10.
    plan = oneshot_plan(idx, q, sps["oneshot"])
    entries = [budget_entry(torch, idx, q, plan, launches)]
    eff, pair_budget, qt, gpb = plan
    out["budget"] = dict(pair_budget=pair_budget, valid_pairs=int((eff >= 0).sum()),
                         width=eff.shape[1], qt=qt, gpb=gpb, k1_ms=entries[0]["ms"])
    scan = (st.codes, st.ids, st.sizes, st.norms, q, eff, K, "l2")
    v10 = grouped_scan_v10(*scan, qt=qt, gpb=gpb)
    v10b = grouped_scan_v10b(*scan, pair_budget=int((eff >= 0).sum()), qt=qt, gpb=gpb)
    if not torch.equal(v10[1], v10b[1]) or not torch.equal(v10[2], v10b[2]):
        raise AssertionError("v10b's ids differ from v10's on the same plan with every valid "
                             "pair in the budget")
    sorted_b = grouped_scan_v10b(*scan, pair_budget=pair_budget, qt=qt, gpb=gpb,
                                 placement="sorted")
    out["budget"].update(
        v10b_equals_v10=True, sorted_overlap=overlap(sorted_b[1].long(), v10[1].long()),
        v10_ms=time_ms(torch, lambda: grouped_scan_v10(*scan, qt=qt, gpb=gpb), reps=5),
        v10b_ms=time_ms(torch, lambda: grouped_scan_v10b(*scan, pair_budget=pair_budget, qt=qt,
                                                         gpb=gpb, placement="sorted"), reps=5))
    log(f"[aps] ({card}) budgeted scan at the oneshot plan: {json.dumps(out['budget'])}; v10b "
        "ids equal v10's")
    del v10, v10b, sorted_b, scan

    # run_deep's serving mode on the headline bf16 index: calibrate, then a
    # pinned oneshot batch with dequantized scores.
    t0 = time.perf_counter()
    bf16_idx.calibrate_aps()
    torch.cuda.synchronize()
    bcal = time.perf_counter() - t0
    spb = SearchParams(k=K, recall_target=APS_TARGET, aps_mode="oneshot", exact_distances=False)
    fields = {f: getattr(bf16_idx, f) for f in APS_FIELDS if f != "aps_radius_ab"}
    budget_by_formula(bf16_idx, q, spb, "the bf16 index")
    torch.cuda.synchronize()
    _ext.reset_launches()
    bf16_idx._search_device_full(q, spb)
    torch.cuda.synchronize()
    blaunches = dict(_ext.launches)
    if (blaunches["grouped_scan_budget_bf16"] != 1 or blaunches["flat_topk"] <= 0
            or blaunches["merge_positions"] <= 0
            or any(blaunches[k] for k in ("grouped_scan", "grouped_scan_bf16",
                                          "grouped_scan_budget"))):
        raise AssertionError("the bf16 oneshot must run K3, K2 and K1's bf16 body on the budget "
                             f"grid once: {blaunches}")
    bchecks = {}
    check_recorded(torch, "bf16 oneshot", recorded_calls(
        functools.partial(bf16_idx._search_device_full, q, spb)), bchecks)
    rb = time_aps(torch, bf16_idx, q, spb)
    rb.update(launches=blaunches, calibrate_s=bcal, fields=fields, kernel_checks=bchecks,
              recall=compute_recall(bf16_idx.search(queries[:NQ_GT], spb).ids, gt, K))
    out["bf16_oneshot"] = rb
    log(f"[aps] ({card}) bf16 headline index (nlist {bf16_idx.nlist()}): calibrate_aps "
        f"{bcal:.2f} s ({json.dumps(fields)}); pinned oneshot, exact_distances=False: "
        f"recall@10 {rb['recall']:.4f}, B={APS_BATCH} {rb['ms']:.3f} ms/batch, mean scanned "
        f"{rb['scanned']:.2f}, launches {blaunches}; its K1, K2 and K3 calls against their "
        f"plain versions: {json.dumps(bchecks)}")
    entries.append(budget_entry(torch, bf16_idx, q, oneshot_plan(bf16_idx, q, spb), blaunches))
    return out, entries, idx


def fold_log(msg: str) -> None:
    log(f"[fold] ({card_line()}) {msg}")


def recorded_rowscale(fn):
    """fn() with the arguments of every K4 and K5 call recorded (through
    grouped_family.rowscale_scan), each call going through."""
    from quake_tpu_torch.ops import grouped_family as fam

    seen = []
    real = fam.rowscale_scan

    def rec(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    fam.rowscale_scan = rec
    try:
        fn()
    finally:
        fam.rowscale_scan = real
    return seen


def fold_by_name(torch, dev, idx, queries, gt, nprobe, names, what: str,
                 twins=None) -> dict:
    """Each folded scan name of `names` through QUAKE_TPU_KERNEL on idx at
    nprobe: recall@10 of the NQ_GT queries beside the exact scan of the
    same probed partitions (the "reference" scan) and, where `twins` has
    it, the same scan's at fold 128 in an earlier phase; ms per B=BATCH batch with
    stages, and the launches of one counted batch: K1 (K5 for v7) and K3
    must launch and K4 (the v3pN fallback) must not; every K1, K2, K3 and
    K5 call of that batch held to its plain version at the name's fold."""
    from quake_tpu_torch import SearchParams, _ext
    from quake_tpu_torch.utils import compute_recall

    st = idx.store.state
    C = st.codes.shape[1]
    tail = "_bf16" if st.codes.dtype == torch.bfloat16 else ""
    sp = SearchParams(k=K, nprobe=nprobe)
    os.environ["QUAKE_TPU_KERNEL"] = "reference"
    try:
        ceiling = compute_recall(idx.search(queries[:NQ_GT], sp).ids, gt, K)
    finally:
        del os.environ["QUAKE_TPU_KERNEL"]
    qd = torch.from_numpy(queries[:BATCH]).to(dev)
    out = {"reference": dict(recall=ceiling)}
    for name in names:
        fold = int(name.split("f")[1])
        if C % fold:
            raise AssertionError(f"{what}: C={C} is no multiple of {name}'s fold")
        main = ("rowscale_fold" if name.startswith("v7") else "grouped_scan") + tail
        os.environ["QUAKE_TPU_KERNEL"] = name
        try:
            res = idx.search(queries[:NQ_GT], sp)
            torch.cuda.synchronize()
            _ext.reset_launches()
            _, ids32, _, dists = idx._search_device_full(qd, sp)
            torch.cuda.synchronize()
            launches = {k: n for k, n in _ext.launches.items() if n}
            k5 = []
            calls = recorded_calls(lambda: k5.extend(recorded_rowscale(
                lambda: idx._search_device_full(qd, sp))))
            ms = time_ms(torch, lambda: idx._search_device_full(qd, sp), reps=5, warmup=1)
            stages = stage_ms(torch, lambda: idx._search_device_full(qd, sp))
        finally:
            del os.environ["QUAKE_TPU_KERNEL"]
        if (launches.get(main, 0) <= 0 or launches.get("flat_topk", 0) <= 0
                or launches.get("rowscale_topk" + tail, 0)):
            raise AssertionError(f"{what}, {name}: {main} and flat_topk must launch and "
                                 f"rowscale_topk{tail} (the v3pN fallback) must not: {launches}")
        if ids32.shape != (BATCH, K) or bool((ids32 < 0).any()) or not bool(
                torch.isfinite(dists).all()):
            raise AssertionError(f"{what}, {name}: expected {K} ids and finite distances")
        checks = {}
        check_recorded(torch, name, calls, checks)
        for a, kw in k5:
            ov, kd, serr = compare_rowscale(torch, a, fold=kw.get("fold", 128),
                                            term_scale=True)
            checks.setdefault(main, dict(calls=0, min_overlap=1.0, max_key_diff=0.0))
            c = checks[main]
            c.update(calls=c["calls"] + 1, min_overlap=min(c["min_overlap"], ov),
                     max_key_diff=max(c["max_key_diff"], kd))
        folds = {a[8] for _, a in calls[0]} | {kw.get("fold") for _, kw in k5}
        if folds != {fold}:
            raise AssertionError(f"{what}, {name}: the scan ran at folds {folds}, not {fold}")
        r = compute_recall(res.ids, gt, K)
        if r < ceiling - FOLD_RECALL_TOL:
            raise AssertionError(f"{what}, {name}: recall@10 {r} is more than {FOLD_RECALL_TOL} "
                                 f"below the exact scan's {ceiling}")
        twin = (twins or {}).get(name)
        out[name] = dict(recall=r, ms=ms, qps=BATCH / (ms / 1e3), launches=launches,
                         stages_ms=stages, checks=checks, recall_fold128=twin)
        fold_log(f"{what}, nprobe {nprobe}, C {C}: {name}: recall@10 {r:.4f} (exact scan "
                 f"{ceiling:.4f}" + (f", fold 128 {twin:.4f}" if twin is not None else "")
                 + f"), B={BATCH} {ms:.3f} ms/batch, stages(ms)="
                 f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}, launches "
                 f"{launches}; its calls against their plain versions {json.dumps(checks)}")
    return out


def fold_k1_row(torch, idx, q, pids, fold, name, launches, v8=False, plan=None) -> dict:
    """A kernels-line row of K1 at `fold` on idx's inputs for the batch q with
    probe lists pids: the v11 path's (v11_inputs), v8's (build_groups, gpb
    4) or, with plan (oneshot_plan), the budget grid's; held to its plain
    version, timed beside K1 at fold 128 on the same inputs, bounded as
    K1 (the products do not change with the fold)."""
    from quake_tpu_torch.ops.grouped import build_groups
    from quake_tpu_torch.ops.grouped_scan import (global_scale, grouped_scan_kernel,
                                                  grouped_scan_plain, grouped_scan_uses_mma,
                                                  pad_groups, v11_inputs)

    st = idx.store.state
    Dd, dt = st.codes.shape[2], st.codes.dtype
    budget = plan is not None
    if budget:
        pids, pair_budget, qt, gpb = plan
    else:
        qt = idx._grouped_params(q.shape[0], pids.shape[1])[0]
        gpb, pair_budget = int(idx._grouped_kernel()[len("v11g"):]), 0
    inp = v11_inputs(st.codes, st.sizes, st.norms, q, pids, K, "l2", qt, gpb,
                     pair_budget=pair_budget)
    kk, slot_mult, levels = inp["kk"], inp["slot_mult"], inp["levels"]
    if v8:
        group_pid, qlist, _, _ = build_groups(pids, st.codes.shape[0], qt)
        gp, ql, gsize, safe_q = pad_groups(group_pid, qlist, st.sizes, 4)
        q_scaled, normsT, _, _ = global_scale(q, st.norms, "l2", levels)
        args = (gp, gsize, q_scaled.to(dt)[safe_q].contiguous(), st.codes, normsT, kk,
                slot_mult, levels)
        real_q = (ql >= 0).sum(1)
    else:
        args = (inp["gp"], inp["group_size"], inp["qg"], st.codes, inp["normsT"], kk,
                slot_mult, levels)
        real_q = (inp["tgt"] < pids.numel()).sum(1)
    if not grouped_scan_uses_mma(qt, Dd, dt, fold, kk):
        raise AssertionError(f"{name} at qt={qt}, D={Dd}: the launcher must pick the "
                             "tensor-core body")
    kernel = functools.partial(grouped_scan_kernel, budget=budget)
    ov, kd = compare_k1(torch, kernel, grouped_scan_plain, *args, fold)
    b, groups, scanned = scan_bound(st, args[0], args[1], real_q,
                                    args[2].numel() * args[2].element_size(), qt, kk, Dd,
                                    unit=unit_of(name))
    return dict(name=name, tol=f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level",
                overlap=ov, max_abs_err=kd, launches=launches, body="tensor cores", fold=fold,
                shape=(f"B={q.shape[0]}, nprobe={pids.shape[1]}, Gn={args[0].shape[0]}, "
                       f"qt={qt}, D={Dd}, C={st.codes.shape[1]}, fold {fold}, "
                       f"{str(dt)[len('torch.'):]}"),
                ms=time_ms(torch, lambda: kernel(*args, fold)),
                f128_ms=time_ms(torch, lambda: kernel(*args, 128)),
                plain_ms=time_ms(torch, lambda: grouped_scan_plain(*args, fold), reps=2,
                                 warmup=1),
                bound=b, groups=groups, scanned_rows=scanned)


def fold_k5_row(torch, idx, q, pids, fold, name, launches) -> dict:
    """A kernels-line row of K5 at `fold` on idx's v7 inputs (build_groups,
    gpb 4, the unscaled queries in the codes' dtype) for the batch q with
    probe lists pids, as rowscale_rows builds the fold-128 one, timed beside
    K5 at fold 128."""
    from quake_tpu_torch.ops.grouped import build_groups, round_query
    from quake_tpu_torch.ops.grouped_family import (MMA_BODY, rowscale_fold_body, rowscale_scan,
                                                    rowscale_scan_plain)
    from quake_tpu_torch.ops.grouped_scan import packed_params, pad_groups

    st = idx.store.state
    Dd, dt = st.codes.shape[2], st.codes.dtype
    qt = idx._grouped_params(q.shape[0], pids.shape[1])[0]
    kk = min(K, st.codes.shape[1])
    slot_mult, levels = packed_params(st.codes.shape[1])
    group_pid, qlist, _, _ = build_groups(pids, st.codes.shape[0], qt)
    gp, ql, gsize, safe_q = pad_groups(group_pid, qlist, st.sizes, 4)
    rargs = (gp, gsize, round_query(q, dt)[safe_q].contiguous(), st.codes, st.norms, kk,
             slot_mult, levels, "l2", "fold")
    if rowscale_fold_body(qt, Dd, kk, dt, fold) != MMA_BODY:
        raise AssertionError(f"{name} at qt={qt}, D={Dd}: the launcher must pick the "
                             "tensor-core body")
    ov, kd, serr = compare_rowscale(torch, rargs, fold=fold, term_scale=True)
    b, groups, scanned = scan_bound(st, gp, gsize, (ql >= 0).sum(1),
                                    rargs[2].numel() * rargs[2].element_size(), qt, kk, Dd,
                                    extra=gp.numel() * qt * 2 * 4, unit=unit_of(name))
    return dict(name=name, tol=(f"winner overlap >= {OVERLAP_TOL}, common keys within 1 level, "
                                f"stats rtol = atol = {STATS_TOL} of the row's product term"),
                overlap=ov, max_abs_err=kd, stats_err=serr, launches=launches,
                body="tensor cores", fold=fold,
                shape=(f"B={q.shape[0]}, nprobe={pids.shape[1]}, Gn={gp.shape[0]}, qt={qt}, "
                       f"D={Dd}, C={st.codes.shape[1]}, fold {fold}, "
                       f"{str(dt)[len('torch.'):]}"),
                ms=time_ms(torch, lambda: rowscale_scan(*rargs, fold=fold), reps=5),
                f128_ms=time_ms(torch, lambda: rowscale_scan(*rargs), reps=5),
                plain_ms=time_ms(torch, lambda: rowscale_scan_plain(*rargs, fold=fold), reps=2,
                                 warmup=1),
                bound=b, groups=groups, scanned_rows=scanned)


def xla_merge(torch, dev, idx, queries, nprobe) -> dict:
    """merge="xla" (the pool merge in tensor operations) against K2 on idx's
    v11 path at B=BATCH: the same ids and scores, no K2 launch, and each
    merge's stage ms (stage_ms, 5 traced runs each)."""
    from quake_tpu_torch import _ext
    from quake_tpu_torch.ops.grouped_scan import grouped_scan_v11

    st = idx.store.state
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    pids = probe_lists(torch, idx, q, nprobe)
    kw = dict(qt=idx._grouped_params(BATCH, nprobe)[0],
              gpb=int(idx._grouped_kernel()[len("v11g"):]),
              placement=placement_of(idx, BATCH, nprobe))
    args = (st.codes, st.ids, st.sizes, st.norms, q, pids, K, "l2")
    out, res = {}, {}
    for merge in ("pallas", "xla"):
        torch.cuda.synchronize()
        _ext.reset_launches()
        res[merge] = grouped_scan_v11(*args, merge=merge, **kw)
        torch.cuda.synchronize()
        launches = {k: n for k, n in _ext.launches.items() if n}
        out[merge] = dict(launches=launches, stages_ms=stage_ms(
            torch, lambda: grouped_scan_v11(*args, merge=merge, **kw), 5))
    once = dict.fromkeys(("grouped_scan",) + GROUPING, 1)
    if out["xla"]["launches"] != once or out["pallas"]["launches"] != dict(once,
                                                                          merge_positions=1):
        raise AssertionError(f"merge='xla' must launch the grouping and K1 and no K2, "
                             f"merge='pallas' the grouping, K1 and K2: {out}")
    for i, what in ((1, "ids"), (0, "scores"), (2, "scanned")):
        if not torch.equal(res["xla"][i], res["pallas"][i]):
            raise AssertionError(f"merge='xla' {what} differ from K2's")
    x, p = out["xla"]["stages_ms"], out["pallas"]["stages_ms"]
    fold_log(f"merge=\"xla\" on the main index (B={BATCH}, nprobe {nprobe}, {kw['placement']} "
             f"placement): ids, scores and scanned equal K2's; no K2 launch; merge stage "
             f"{x['merge']:.4f} ms (K2's {p['merge']:.4f} ms); stages xla "
             f"{json.dumps({k: round(v, 4) for k, v in x.items()})}, pallas "
             f"{json.dumps({k: round(v, 4) for k, v in p.items()})}")
    return out


def scan_latency_profile(torch, dev, idx) -> dict:
    """ListScanLatencyEstimator.profile_scan_latency on the card at the
    default grid (device time of flat_scan a point), its seconds, and
    L(n, 16) at MAINT_RATIO_N beside the packaged grid's and the grouped
    scan's (profile_grouped_latency at those points, the index's kernel)."""
    from quake_tpu_torch.maintenance import ListScanLatencyEstimator

    Dd = idx.d()
    est = ListScanLatencyEstimator(Dd, device=dev, packaged=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.profile_scan_latency()
    seconds = time.perf_counter() - t0
    grid = est.latency_grid
    if (est.grid_source != "profiled" or grid.shape != (len(est.n_values), len(est.k_values))
            or not np.isfinite(grid).all() or not (grid > 0).all()):
        raise AssertionError(f"profile_scan_latency: a grid of {grid.shape}, source "
                             f"{est.grid_source}, finite and positive: {grid}")
    packaged = ListScanLatencyEstimator(Dd, device=dev)
    grouped = ListScanLatencyEstimator(Dd, n_values=list(MAINT_RATIO_N), k_values=[16, 64],
                                       device=dev, packaged=False)  # two k: it interpolates
    grouped.profile_grouped_latency(kernel=idx._grouped_kernel(), qt=idx._k1_qt(32))
    points = {n: dict(scan=est.estimate_scan_latency(n, 16),
                      packaged=packaged.estimate_scan_latency(n, 16),
                      grouped=grouped.estimate_scan_latency(n, 16)) for n in MAINT_RATIO_N}
    fold_log(f"profile_scan_latency at the default grid ({len(est.n_values)} x "
             f"{len(est.k_values)} points, D={Dd}): {seconds:.2f} s; L(n, 16) in ns, flat scan "
             f"of one query / packaged grid ({packaged.grid_source}) / grouped scan profiled "
             f"({idx._grouped_kernel()}, a (query, partition) pair): "
             + json.dumps({n: {k: round(v, 1) for k, v in p.items()} for n, p in points.items()}))
    return dict(seconds=seconds, grid=grid.tolist(), points=points)


def phase_fold(torch, dev, aps_idx, idx, bf16_idx, queries, gt, nprobe, bf16_nprobe, twins):
    """Folds other than 128 at full width (phase 21 of the module's
    docstring): the folded names on phase 12's index (aps_idx, C 1536) at
    FOLD_NPROBE, at fold 64 on the main f32 (idx, C 7552) and the headline
    bf16 index (fold_by_name), the pinned oneshot under v11g4f256 (K1 on the
    budget grid at fold 256), the kernels line's fold entries (fold_k1_row,
    fold_k5_row), merge="xla" against K2 on the main index (xla_merge) and
    profile_scan_latency on the card. twins: {"main": {name: recall@10 of
    the same scan at fold 128}, "bf16": {...}} from the earlier phases.
    Returns (summary, the fold entries)."""
    from quake_tpu_torch import SearchParams, _ext

    out = dict(aps=fold_by_name(torch, dev, aps_idx, queries, gt, FOLD_NPROBE, FOLD_APS_NAMES,
                                "APS-cell index"),
               main=fold_by_name(torch, dev, idx, queries, gt, nprobe, FOLD_MAIN_NAMES,
                                 "main f32 index", twins["main"]),
               bf16=fold_by_name(torch, dev, bf16_idx, queries, gt, bf16_nprobe,
                                 FOLD_MAIN_NAMES, "headline bf16 index", twins["bf16"]))
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    qa = torch.from_numpy(queries[:APS_BATCH]).to(dev)
    spb = SearchParams(k=K, recall_target=APS_TARGET, aps_mode="oneshot")
    fold_b = int(FOLD_ONESHOT.split("f")[1])
    os.environ["QUAKE_TPU_KERNEL"] = FOLD_ONESHOT
    try:
        torch.cuda.synchronize()
        _ext.reset_launches()
        aps_idx._search_device_full(qa, spb)
        torch.cuda.synchronize()
        blaunches = {k: n for k, n in _ext.launches.items() if n}
        calls = recorded_calls(lambda: aps_idx._search_device_full(qa, spb))
    finally:
        del os.environ["QUAKE_TPU_KERNEL"]
    plan = oneshot_plan(aps_idx, qa, spb)  # the probe plan and budget: the fold changes neither
    if blaunches.get("grouped_scan_budget", 0) <= 0 or {a[8] for _, a in calls[0]} != {fold_b}:
        raise AssertionError(f"the pinned oneshot under {FOLD_ONESHOT} must run K1 on the "
                             f"budget grid at fold {fold_b}: {blaunches}")
    bchecks = {}
    check_recorded(torch, f"oneshot {FOLD_ONESHOT}", calls, bchecks)
    out["oneshot"] = dict(name=FOLD_ONESHOT, launches=blaunches, checks=bchecks)
    fold_log(f"APS-cell index, pinned oneshot at B={APS_BATCH} under {FOLD_ONESHOT}: launches "
             f"{blaunches}; its calls against their plain versions {json.dumps(bchecks)}")

    def count(part, name, kernel):
        return out[part][name]["launches"].get(kernel, 0)
    pa = probe_lists(torch, aps_idx, q, FOLD_NPROBE)
    pm = probe_lists(torch, idx, q, nprobe)
    pb = probe_lists(torch, bf16_idx, q, bf16_nprobe)
    rows = [fold_k1_row(torch, idx, q, pm, 64, "grouped_scan/f64",
                        count("main", "v11g4f64", "grouped_scan"))]
    aps_folds = [int(n.split("f")[1]) for n in FOLD_APS_NAMES]  # v11 x 4, v10, v8, v7
    rows += [fold_k1_row(torch, aps_idx, q, pa, f, entry, count("aps", n, "grouped_scan"))
             for entry, n, f in zip(("grouped_scan/f256", "grouped_scan/f384",
                                     "grouped_scan/f512"), FOLD_APS_NAMES[1:4], aps_folds[1:4])]
    rows.append(fold_k1_row(torch, aps_idx, q, pa, aps_folds[5], "grouped_scan/v8f256",
                            count("aps", FOLD_APS_NAMES[5], "grouped_scan"), v8=True))
    rows.append(fold_k1_row(torch, aps_idx, qa, None, fold_b, "grouped_scan_budget/f256",
                            blaunches["grouped_scan_budget"], plan=plan))
    rows.append(fold_k5_row(torch, idx, q, pm, 64, "rowscale_fold/v7f64",
                            count("main", "v7g4f64", "rowscale_fold")))
    rows.append(fold_k5_row(torch, aps_idx, q, pa, aps_folds[6], "rowscale_fold/v7f256",
                            count("aps", FOLD_APS_NAMES[6], "rowscale_fold")))
    rows.append(fold_k1_row(torch, bf16_idx, q, pb, 64, "grouped_scan_bf16/f64",
                            count("bf16", "v11g4f64", "grouped_scan_bf16")))
    rows.append(fold_k5_row(torch, bf16_idx, q, pb, 64, "rowscale_fold_bf16/v7f64",
                            count("bf16", "v7g4f64", "rowscale_fold_bf16")))
    for r in rows:
        fold_log(f"{r['name']}: {r['ms']:.4f} ms at fold {r['fold']}, {r['f128_ms']:.4f} ms at "
                 f"fold 128 on the same inputs ({r['shape']})")
    entries = [kernel_entry(r) for r in rows]
    out["xla_merge"] = xla_merge(torch, dev, idx, queries, nprobe)
    out["scan_latency"] = scan_latency_profile(torch, dev, idx)
    return out, entries


def check_contract_6(torch, store, when: str) -> float:
    """Compact prefix and norms on the card (ROADMAP Queue 3 contract 6):
    in every row the ids are >= 0 exactly below the size, the norms at valid
    slots equal the squared norms of the codes (rtol 1e-6), and the id map
    (on a spilled store the two maps together) counts every valid slot.
    Returns the worst relative norm error."""
    st = store.state
    below = torch.arange(store.C, device=st.ids.device)[None, :] < st.sizes[:, None]
    if not torch.equal(st.ids >= 0, below):
        raise AssertionError(f"{when}: the slots with an id are not exactly those below the sizes")
    want = (st.codes * st.codes).sum(-1)[below]
    err = float(((st.norms[below] - want).abs() / want.abs().clamp(min=1e-30)).max())
    if err > 1e-6:
        raise AssertionError(f"{when}: cached norms off the codes' by {err} (rtol 1e-6)")
    held = store.ntotal() + (len(store.spill_map) if store.spill else 0)
    if held != int(st.sizes.sum()):
        raise AssertionError(f"{when}: the id maps hold {held} ids, the sizes sum to "
                             f"{int(st.sizes.sum())}")
    return err


def mutated_searches(torch, dev, idx, queries, nprobe, what: str):
    """The default (K1, K2, K3), sized and multi paths on the store as it
    stands: recall@10 of the ground-truth queries against an exact ground
    truth of the store's vectors, beside the exact scan of the same probed
    partitions (the "reference" name); ms per B=16384 batch; each path's
    launches (zeroed just before it, read just after). Sized and multi are
    held within CEILING_TOL of the exact scan, K1, K2 and K3 to their plain
    versions at the default path's inputs (main_kernel_gates),
    sized_topk and multi_topk at the direct paths' (compare_pairs)."""
    from quake_tpu_torch import SearchParams, _ext
    from quake_tpu_torch.ops import grouped_variants as gv
    from quake_tpu_torch.utils import compute_recall

    st = idx.store.state
    sp = SearchParams(k=K, nprobe=nprobe)
    valid = st.ids >= 0
    gt_rows = exact_gt(torch, st.codes[valid], torch.from_numpy(queries[:NQ_GT]).to(dev), K)
    gt = st.ids[valid].cpu().numpy()[gt_rows]
    os.environ["QUAKE_TPU_KERNEL"] = "reference"
    try:
        ceiling = compute_recall(idx.search(queries[:NQ_GT], sp).ids, gt, K)
    finally:
        del os.environ["QUAKE_TPU_KERNEL"]
    batches = probe_batches(torch, dev, idx, queries, nprobe)
    paths = (
        ("default", MAIN_KERNELS, lambda q, p: idx._search_device_full(q, sp)[:2]),
        ("sized", ("sized_topk",),
         lambda q, p: gv.grouped_scan_sized(st.codes, st.ids, st.sizes, q, p, K, "l2",
                                            qt=DIRECT_QT, ct=SIZED_CT)[:2]),
        ("multi", ("multi_topk",),
         lambda q, p: gv.grouped_scan_multi(st.codes, st.ids, q, p, K, "l2", qt=DIRECT_QT,
                                            gb=MULTI_GB)[:2]))
    out = {"reference": dict(recall=ceiling)}
    for name, kernels, fn in paths:
        torch.cuda.synchronize()
        _ext.reset_launches()
        r = compute_recall(fn(*batches[NQ_GT])[1].cpu().numpy(), gt, K)
        ms = time_ms(torch, lambda: fn(*batches[BATCH]), reps=5, warmup=1)
        scores, ids32 = fn(*batches[BATCH])
        torch.cuda.synchronize()
        launches = dict(_ext.launches)
        ran = {k for k in _ext.KERNELS if launches[k] > 0}
        if not set(kernels) <= ran or (name != "default" and ran != set(kernels)):
            raise AssertionError(f"{what}, {name}: expected the kernels {kernels} to launch, got "
                                 f"{launches}")
        if (ids32.shape != (BATCH, K) or bool((ids32 < 0).any())
                or not bool(torch.isfinite(scores).all())):
            raise AssertionError(f"{what}, {name}: expected {K} ids and finite scores per query")
        if name != "default" and abs(r - ceiling) > CEILING_TOL:
            raise AssertionError(f"{what}, {name}: recall@10 {r} is not within {CEILING_TOL} of "
                                 f"the exact scan's {ceiling}")
        out[name] = dict(recall=r, ms=ms, launches={k: launches[k] for k in sorted(ran)})

    # The kernels against their plain versions at these paths' inputs.
    q, pids = batches[BATCH]
    gates = main_kernel_gates(torch, idx, q, pids, nprobe)
    C = st.codes.shape[1]
    gp, qg, gsize, _ = direct_groups(torch, st, q, pids)
    ov_s, err_s = compare_pairs(
        torch, f"sized_topk ({what})", gv.sized_topk(gp, gsize, qg, st.codes, K, "l2", ct=SIZED_CT),
        gv.sized_topk_plain(gp, gsize, qg, st.codes, K, "l2", ct=SIZED_CT), ties=True)
    ov_m, err_m = compare_pairs(
        torch, f"multi_topk ({what})",
        multi_slots(gv.multi_topk(gp, qg, st.codes, st.ids, K, "l2", gb=MULTI_GB), C),
        multi_slots(gv.multi_topk_plain(gp, qg, st.codes, st.ids, K, "l2"), C), ties="up")
    out["kernels"] = dict(gates, sized_topk_overlap=ov_s, sized_topk_max_abs_err=err_s,
                          multi_topk_overlap=ov_m, multi_topk_max_abs_err=err_m)
    log(f"[mutation] {what} ({card_line()}; C={C}, nlist={idx.nlist()}, ntotal={idx.ntotal()}): "
        f"exact scan of the probed partitions recall@10={ceiling:.4f}; "
        + "; ".join(f"{n} {out[n]['ms']:.3f} ms/batch, recall@10={out[n]['recall']:.4f}, "
                    f"launches {out[n]['launches']}" for n, *_ in paths)
        + f"; {gates_text(gates)}, sized_topk overlap {ov_s:.4f} (max score error {err_s:.3g}), "
        f"multi_topk overlap {ov_m:.4f} (max score error {err_m:.3g})")
    return out


def main_kernel_gates(torch, idx, q, pids, nprobe):
    """K1, K2 and K3 against their plain versions at the default path's
    inputs on idx (the batch q, its probe lists pids), with phase 10's gates
    (compare_k1, compare_k2, compare_k3)."""
    from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_plain, parent_bias
    from quake_tpu_torch.ops.grouped_scan import (PLACEMENTS, grouped_scan_kernel,
                                                  grouped_scan_plain, merge_positions,
                                                  merge_positions_plain, sort_key_fits)

    qt, inp, args = k1_args(idx, q, pids)
    ov1, kd1 = compare_k1(torch, grouped_scan_kernel, grouped_scan_plain, *args)
    placement = "sorted" if sort_key_fits(q.shape[0], inp["gp"].shape[0] * qt) else "argsort"
    m_packed, _ = PLACEMENTS[placement](grouped_scan_kernel(*args), inp["tgt"],
                                        inp["group_size"], pids)
    compare_k2(torch, merge_positions, merge_positions_plain, m_packed,
               min(K, m_packed.shape[1]), inp["slot_mult"])
    pst = idx.parent.store.state
    Pp, Cp, Dd = pst.codes.shape
    ov3, kd3 = compare_k3(torch, flat_topk, flat_topk_plain, pst.codes.reshape(Pp * Cp, Dd),
                          parent_bias(pst.ids, pst.norms, "l2"), q, nprobe, "l2")
    return dict(k1_overlap=ov1, k1_max_key_diff=kd1, k2=f"equal ({placement})",
                k3_overlap=ov3, k3_max_key_diff=kd3, k3_n=Pp * Cp)


def gates_text(g) -> str:
    return (f"K1 overlap {g['k1_overlap']:.4f} (max key diff {g['k1_max_key_diff']}), K2 "
            f"{g['k2']}, K3 overlap {g['k3_overlap']:.4f} (max key diff {g['k3_max_key_diff']}, "
            f"N={g['k3_n']})")


def split_cap(ntotal: int, nlist: int) -> int:
    """The need above which QuakeIndex.add splits an overflowing partition
    instead of growing C: 1.5 x the mean partition after the insert, rounded
    up to 256 (quake_tpu/index.py:1728-1731)."""
    return max(256, -(-int(1.5 * ntotal / max(nlist, 1)) // 256) * 256)


def same_store(torch, a, b, what: str) -> dict:
    """The six arrays (norms within rtol 1e-6: the load recomputes them),
    the free rows and the generations of two stores must agree."""
    sa, sb = a.state, b.state
    for f in ("codes", "ids", "sizes", "centroids", "active"):
        if not torch.equal(getattr(sa, f), getattr(sb, f)):
            raise AssertionError(f"{what}: {f} differs")
    err = float(((sa.norms - sb.norms).abs() / sa.norms.abs().clamp(min=1e-30)).max())
    if err > 1e-6:
        raise AssertionError(f"{what}: norms differ by {err} (rtol 1e-6)")
    if a.free_rows != b.free_rows or not np.array_equal(a.generation, b.generation):
        raise AssertionError(f"{what}: the free rows or the generations differ")
    return dict(norm_rel_err=err, norms_bitwise_diff=int((sa.norms != sb.norms).sum()))


def phase_index_mutation(torch, dev, idx, queries, nprobe, rng, first_id: int):
    """The index's mutation path at full width, while C is still the
    build's: (1) a flood through QuakeIndex.add of tight jittered copies of
    the largest partition's centroid (MUTATION_JITTER of its rms spread a
    coordinate, every copy nearest that centroid; ids from first_id), sized
    by the JAX package's rule to need MUTATION_FLOOD_OVER rows past both C
    and the split cap, so that the index splits the partition and C stays;
    validate(), one parent centroid per partition, contract 6 and the freed
    row's generation; (2) mutated_searches on the split store; (3) the
    flood removed and MUTATION_FRESH fresh vectors added through the index
    (ids from 2 N); (4) save and load through a temporary directory: the
    loaded arrays and bookkeeping equal the live index's at both levels, its
    default search returns the same ids, and K1, K2 and K3 pass their gates
    on it. Adds, removal, save and load are timed on the host clock after a
    sync."""
    from quake_tpu_torch import QuakeIndex, SearchParams, _ext

    store = idx.store
    C0, nlist0 = store.C, idx.nlist()
    sizes = store.partition_sizes()
    target = int(np.argmax(sizes))
    size = int(sizes[target])
    n_flood = 0
    for _ in range(16):  # the cap counts the flood in its mean
        cap = split_cap(idx.ntotal() + n_flood, nlist0)
        n_flood, last = max(C0, cap) - size + MUTATION_FLOOD_OVER, n_flood
        if n_flood == last:
            break
    cap = split_cap(idx.ntotal() + n_flood, nlist0)
    if not size + n_flood > max(C0, cap):
        raise AssertionError(f"the flood needs {size + n_flood} rows, not past C={C0} and the "
                             f"split cap {cap}")
    st = store.state
    members = st.codes[target, :size]
    spread = float((members - st.centroids[target]).pow(2).mean().sqrt())  # rms a coordinate
    del members
    flood = (st.centroids[target].cpu().numpy()
             + MUTATION_JITTER * spread * rng.standard_normal((n_flood, D))).astype(np.float32)
    if not (idx._assign_rows(flood) == target).all():
        raise AssertionError(f"the flood's copies are not all nearest partition {target}")
    flood_ids = np.arange(first_id, first_id + n_flood)
    gen0 = int(store.generation[target])
    out = dict(C_before=C0, nlist_before=nlist0, flood_partition=target, flood_vectors=n_flood,
               partition_size=size, split_cap=cap)

    _, t = timed(torch, lambda: idx.add(flood, flood_ids))
    freed = target in store.free_rows
    if store.C != C0 or idx.nlist() <= nlist0:
        raise AssertionError(f"the flood was to split partition {target} with C={C0} held: C is "
                             f"{store.C}, nlist {nlist0} -> {idx.nlist()}")
    if int(store.generation[target]) != gen0 + (1 if freed else 2):
        raise AssertionError(f"row {target}: generation {gen0} -> {store.generation[target]} "
                             f"({'freed' if freed else 'reused'})")
    if not idx.validate() or idx.parent.ntotal() != idx.nlist():
        raise AssertionError("the split index does not validate")
    out.update(add_s=t, add_per_s=n_flood / t, nlist_after=idx.nlist(),
               split_into=idx.nlist() - nlist0 + 1, row=("freed" if freed else "reused"),
               norm_err=check_contract_6(torch, store, "after the flood through the index"))
    out["split"] = mutated_searches(torch, dev, idx, queries, nprobe, "split store")

    _, t_rm = timed(torch, lambda: idx.remove(flood_ids))
    fresh = make_manifold(MUTATION_FRESH, D, 4096, seed=MUTATION_FRESH_SEED)
    nlist1 = idx.nlist()
    _, t_add = timed(torch, lambda: idx.add(fresh, np.arange(2 * N, 2 * N + MUTATION_FRESH)))
    if store.C != C0 or not idx.validate() or idx.parent.ntotal() != idx.nlist():
        raise AssertionError(f"after the removal and the fresh add: C={store.C}, validate() "
                             f"{idx.validate()}")
    out.update(remove_s=t_rm, remove_per_s=n_flood / t_rm, fresh_s=t_add,
               fresh_per_s=MUTATION_FRESH / t_add, fresh_splits=idx.nlist() - nlist1,
               fresh_norm_err=check_contract_6(torch, store, "after the fresh add"))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index")
        _, t_save = timed(torch, lambda: idx.save(path))
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(path) for f in files)
        loaded, t_load = timed(torch, lambda: QuakeIndex().load(path))
    out.update(save_s=t_save, load_s=t_load, saved_bytes=nbytes)
    out["loaded"] = dict(index=same_store(torch, store, loaded.store, "the loaded index"),
                         parent=same_store(torch, idx.parent.store, loaded.parent.store,
                                           "the loaded parent"))
    if check_contract_6(torch, loaded.store, "after the load") > 1e-6 or not loaded.validate():
        raise AssertionError("the loaded index does not validate")
    sp = SearchParams(k=K, nprobe=nprobe)
    torch.cuda.synchronize()
    _ext.reset_launches()
    got = loaded.search(queries[:BATCH], sp).ids
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    if any(launches[k] != 1 for k in MAIN_KERNELS):
        raise AssertionError(f"the loaded index's default search: launches {launches}")
    if not np.array_equal(got, idx.search(queries[:BATCH], sp).ids):
        raise AssertionError("the loaded index's default search returns other ids")
    q, pids = probe_batches(torch, dev, loaded, queries, nprobe)[BATCH]
    out["loaded"]["gates"] = main_kernel_gates(torch, loaded, q, pids, nprobe)
    del loaded, q, pids
    torch.cuda.empty_cache()
    return out


def phase_mutation(torch, dev, idx, queries, nprobe, full_ms):
    """The mutation path at full width, on the main index, after every
    other phase that reads it, on the native id map: remove a seeded MUTATION_REMOVE of
    the resident ids through the store, check contract 6 and search
    (mutated_searches); append MUTATION_APPEND fresh vectors (make_manifold,
    seed MUTATION_APPEND_SEED, ids from N up) to their nearest active
    centroid; then the index-level step (phase_index_mutation: a flood that
    splits its partition with C held, searches on the split store, removal
    and a fresh add through the index, save and load); then, through the
    store, a flood of copies of the then largest partition's centroid,
    jittered by half that partition's spread, that pushes it
    MUTATION_FLOOD_OVER rows past C, so that C doubles (new tensors); check
    C, contract 6 and search again. Store-level removal and appends are
    timed on the host clock after a sync. full_ms: the paths' batch ms on
    the full store, for the log."""
    from quake_tpu_torch.native import NativeIdMap

    card = card_line()
    store = idx.store
    if not isinstance(store.id_map, NativeIdMap):
        raise AssertionError(f"the index runs the {type(store.id_map).__name__} id map, not the "
                             "native one")
    rng = np.random.default_rng(MUTATION_SEED)
    out = dict(C_before=store.C, ntotal_before=store.ntotal(), id_map=type(store.id_map).__name__)
    gone = rng.choice(np.sort(store.get_ids()), int(MUTATION_REMOVE * store.ntotal()),
                      replace=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    removed = store.remove(gone)
    torch.cuda.synchronize()
    t_remove = time.perf_counter() - t0
    if removed != len(gone):
        raise AssertionError(f"remove: {removed} of {len(gone)} resident ids removed")
    out["remove"] = dict(vectors=removed, s=t_remove, per_s=removed / t_remove,
                         norm_err=check_contract_6(torch, store, "after the removal"))
    out["reduced"] = mutated_searches(torch, dev, idx, queries, nprobe, "reduced store")

    st = store.state
    x_new = make_manifold(MUTATION_APPEND, D, 4096, seed=MUTATION_APPEND_SEED)
    active = torch.from_numpy(store.active_rows()).to(dev)
    cents = st.centroids[active]
    xd = torch.from_numpy(x_new).to(dev)
    rows = active[torch.argmin((cents * cents).sum(1)[None, :] - 2.0 * (xd @ cents.T), dim=1)]
    rows = rows.cpu().numpy().astype(np.int32)
    del xd
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.append(rows, x_new, np.arange(N, N + MUTATION_APPEND))
    torch.cuda.synchronize()
    times["append"] = time.perf_counter() - t0

    out["index"] = phase_index_mutation(torch, dev, idx, queries, nprobe, rng,
                                        N + MUTATION_APPEND)
    ix = out["index"]
    log(f"[mutation] index ({card}): id map {out['id_map']}; flood of {ix['flood_vectors']} "
        f"through QuakeIndex.add into partition {ix['flood_partition']} (size "
        f"{ix['partition_size']}, split cap {ix['split_cap']}): {ix['add_per_s']:,.0f} "
        f"vectors/s ({ix['add_s']:.3f} s), split into {ix['split_into']} partitions, row "
        f"{ix['row']}, C {ix['C_before']} -> {store.C}, nlist {ix['nlist_before']} -> "
        f"{ix['nlist_after']}; remove the flood {ix['remove_per_s']:,.0f} vectors/s "
        f"({ix['remove_s']:.3f} s); add {MUTATION_FRESH} fresh {ix['fresh_per_s']:,.0f} "
        f"vectors/s ({ix['fresh_s']:.3f} s, {ix['fresh_splits']} splits); save "
        f"{ix['saved_bytes'] / 1e9:.3f} GB in {ix['save_s']:.3f} s "
        f"({ix['saved_bytes'] / 1e9 / ix['save_s']:.3f} GB/s), load {ix['load_s']:.3f} s "
        f"({ix['saved_bytes'] / 1e9 / ix['load_s']:.3f} GB/s), arrays equal (norms "
        f"{ix['loaded']['index']['norms_bitwise_diff']} not bitwise, rel err "
        f"{ix['loaded']['index']['norm_rel_err']:.3g}), default search ids equal, loaded "
        f"{gates_text(ix['loaded']['gates'])}; split store batch ms "
        + "; ".join(f"{n} {ix['split'][n]['ms']:.3f} (recall@10 {ix['split'][n]['recall']:.4f})"
                    for n in full_ms)
        + f"; exact scan of the probed partitions {ix['split']['reference']['recall']:.4f}, v11 "
        f"{ix['split']['reference']['recall'] - ix['split']['default']['recall']:.4f} below it")

    st = store.state
    sizes = store.partition_sizes()
    target = int(np.argmax(sizes))
    n_flood = store.C - int(sizes[target]) + MUTATION_FLOOD_OVER
    members = st.codes[target, :int(st.sizes[target])]
    spread = float((members - st.centroids[target]).pow(2).mean().sqrt())  # rms a coordinate
    flood = (st.centroids[target].cpu().numpy()
             + 0.5 * spread * rng.standard_normal((n_flood, D))).astype(np.float32)
    del members
    first = N + MUTATION_APPEND + ix["flood_vectors"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store.append(np.full(n_flood, target, np.int32), flood, np.arange(first, first + n_flood))
    torch.cuda.synchronize()
    times["flood"] = time.perf_counter() - t0
    if store.C != 2 * out["C_before"]:
        raise AssertionError(f"the flood was to grow C from {out['C_before']} to "
                             f"{2 * out['C_before']}, C is {store.C}")
    st = store.state
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (st.codes, st.ids, st.norms)):
        raise AssertionError("the grown tensors must be contiguous and 16-byte aligned")
    out.update(C_after=store.C, ntotal_after=store.ntotal(), flood_partition=target,
               append=dict(vectors=MUTATION_APPEND, s=times["append"],
                           per_s=MUTATION_APPEND / times["append"]),
               flood=dict(vectors=n_flood, s=times["flood"], per_s=n_flood / times["flood"]),
               grown_norm_err=check_contract_6(torch, store, "after the append and the flood"),
               store_bytes=sum(t.numel() * t.element_size()
                               for t in (st.codes, st.ids, st.norms, st.sizes)))
    out["grown"] = mutated_searches(torch, dev, idx, queries, nprobe, "grown store")
    log(f"[mutation] store ({card}): id map {out['id_map']}; remove {removed} ids: "
        f"{out['remove']['per_s']:,.0f} vectors/s ({t_remove:.3f} s; the dict map: "
        f"{DICT_REMOVE_RATE}); append {MUTATION_APPEND}: {out['append']['per_s']:,.0f} vectors/s "
        f"({times['append']:.3f} s); flood of {n_flood} into partition {target}: "
        f"{out['flood']['per_s']:,.0f} vectors/s ({times['flood']:.3f} s); C {out['C_before']} -> "
        f"{store.C} ({out['store_bytes'] / 1e9:.3f} GB); batch ms (full store / reduced / split / "
        "grown) "
        + "; ".join(f"{n} {full_ms[n]:.3f} / {out['reduced'][n]['ms']:.3f} / "
                    f"{ix['split'][n]['ms']:.3f} / {out['grown'][n]['ms']:.3f}, recall@10 "
                    f"{out['reduced'][n]['recall']:.4f} / {ix['split'][n]['recall']:.4f} / "
                    f"{out['grown'][n]['recall']:.4f}" for n in full_ms)
        + f"; exact scan of the probed partitions {out['reduced']['reference']['recall']:.4f} / "
        f"{ix['split']['reference']['recall']:.4f} / {out['grown']['reference']['recall']:.4f}")
    return out


def maint_grid_point(torch, dev, n: int, k: int, qt: int) -> dict:
    """K1 and K2 of one latency-grid point, as profile_grouped_latency lays
    it out (32 partitions of n rows, MAINT_GRID_QUERIES queries probing one
    each, the JAX package's gpb at that C), recorded and held against their
    plain versions with phase 10's gates (check_recorded)."""
    from quake_tpu_torch import coordinator

    Pp, C = 32, max(256, -(-n // 256) * 256)
    gen = torch.Generator(device=dev).manual_seed(5)
    codes = torch.randn((Pp, C, D), generator=gen, device=dev)
    ids = torch.arange(Pp * C, dtype=torch.int32, device=dev).reshape(Pp, C)
    sizes = torch.full((Pp,), C, dtype=torch.int32, device=dev)
    q = torch.randn((MAINT_GRID_QUERIES, D), generator=gen, device=dev)
    pids = torch.randint(0, Pp, (MAINT_GRID_QUERIES, 1), generator=gen, device=dev)
    gpb = max(1, min(4, (12 << 20) // (2 * C * D * 4)))
    calls = recorded_calls(lambda: coordinator.grouped_scan(
        codes, ids, sizes, (codes * codes).sum(-1), q, pids.to(torch.int32), k, "l2", qt, 64,
        f"v11g{gpb}", dense=True))
    summary = {}
    check_recorded(torch, f"grid point n={n}, k={k}", calls, summary)
    if not (summary.get("grouped_scan") and summary.get("merge_positions")):
        raise AssertionError(f"the grid point n={n}, k={k} did not run K1 and K2: {summary}")
    return summary


def maint_gates(torch, idx, ids_before, ntotal: int, what: str) -> dict:
    """Round A's and B's correctness gates: ntotal unchanged, the same id
    set, validate(), contract 6 at both levels, one parent centroid for
    each active partition (the parent's ids are the active rows)."""
    if idx.ntotal() != ntotal:
        raise AssertionError(f"{what}: ntotal {ntotal} -> {idx.ntotal()}")
    if not np.array_equal(np.sort(idx.get_ids()), ids_before):
        raise AssertionError(f"{what}: the resident ids changed")
    if not idx.validate():
        raise AssertionError(f"{what}: validate() fails")
    err = max(check_contract_6(torch, idx.store, what),
              check_contract_6(torch, idx.parent.store, f"{what} (parent)"))
    parent_ids = np.sort(idx.parent.get_ids())
    if not np.array_equal(parent_ids, np.sort(idx.store.active_rows())):
        raise AssertionError(f"{what}: the parent's centroids are not one per active partition")
    return dict(nlist=idx.nlist(), norm_err=err)


def maint_search(torch, dev, idx, queries, skewed, gt_u, gt_s, nprobe) -> dict:
    """The default search (K3, K1, K2): ms per B=BATCH batch, recall@10 of
    the NQ_GT uniform queries and of the skewed batch against the exact
    ground truth of the store's vectors. The caller resets the window."""
    from quake_tpu_torch import SearchParams
    from quake_tpu_torch.utils import compute_recall

    sp = SearchParams(k=K, nprobe=nprobe)
    q = torch.from_numpy(queries[:BATCH]).to(dev)
    return dict(ms=time_ms(torch, lambda: idx._search_device_full(q, sp), reps=10),
                recall_uniform=compute_recall(idx.search(queries[:NQ_GT], sp).ids, gt_u, K),
                recall_skewed=compute_recall(idx.search(skewed, sp).ids, gt_s, K))


def phase_maintenance(torch, dev, queries, nprobe):
    """Cost-based maintenance at full width (phase 15 of the module's
    docstring): the build with the latency profile, the aged region and the
    skewed batch, round A (maintenance()) and round B (the mechanisms on
    named rows) with their gates, the searches before and after, K1-K3 on
    the maintained store, save and load. Returns its summary."""
    from quake_tpu_torch import (IndexBuildParams, MaintenancePolicyParams, QuakeIndex,
                                 SearchParams, _ext)
    from quake_tpu_torch.maintenance import ListScanLatencyEstimator

    card = card_line()
    t_phase = time.perf_counter()
    x = make_manifold(N, D, 4096, seed=1)
    idx = QuakeIndex(device=dev)
    prof_s = []
    plain_profile = idx.profile_latency

    def timed_profile(*a, **kw):  # the build's own call, timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = plain_profile(*a, **kw)
        torch.cuda.synchronize()
        prof_s.append(time.perf_counter() - t)
        return r
    idx.profile_latency = timed_profile
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    idx.build(x, np.arange(N, dtype=np.int64),
              IndexBuildParams(nlist=NLIST, niter=NITER, calibrate_aps=False,
                               profile_maintenance_latency=True))
    build_s = time.perf_counter() - t0
    del idx.profile_latency
    prof_launches = {k: v for k, v in _ext.launches.items() if v}
    est = idx.latency_profile
    grid_points = len(est.n_values) * len(est.k_values)
    if (len(prof_s) != 1 or est.grid_source != "profiled" or not (est.latency_grid > 0).all()
            or idx.maintenance_policy is None
            or idx.maintenance_policy.cost_estimator.latency_estimator is not est):
        raise AssertionError("the build did not profile the latency grid into its policy")
    n_k1 = prof_launches.get("grouped_scan", 0)
    if (n_k1 < 3 * grid_points
            or set(prof_launches) != {"grouped_scan", "merge_positions", *GROUPING}
            or any(prof_launches[g] != n_k1 for g in GROUPING)):
        raise AssertionError(f"the profile was to run the grouping, K1 and K2 at every one of "
                             f"the {grid_points} grid points, the grouping once a K1 call: "
                             f"launches {prof_launches}")
    analytic = ListScanLatencyEstimator(D)
    packaged = ListScanLatencyEstimator(D, device=dev)  # the default grid of a CUDA index
    if packaged.grid_source != MAINT_PACKAGED:
        raise AssertionError(f"the default grid on the card reads {packaged.grid_source}, not "
                             f"{MAINT_PACKAGED}")
    ratio = {n: analytic.estimate_scan_latency(n, 16) / est.estimate_scan_latency(n, 16)
             for n in MAINT_RATIO_N}
    ratio_p = {n: packaged.estimate_scan_latency(n, 16) / est.estimate_scan_latency(n, 16)
               for n in MAINT_RATIO_N}
    grid_k1 = maint_grid_point(torch, dev, 4096, 16, idx._k1_qt(32))
    out = dict(build_s=build_s, profile_s=prof_s[0], profile_launches=prof_launches,
               grid_ns={str(n): [float(v) for v in row]
                        for n, row in zip(est.n_values, est.latency_grid)},
               analytic_over_profiled=ratio, packaged_over_profiled=ratio_p,
               grid_point_gates=grid_k1)
    log(f"[maintenance] ({card}) build {build_s:.2f} s with the latency profile in device "
        f"time {prof_s[0]:.2f} s ({grid_points} points; launches {prof_launches}); L(n, k=16) ns "
        + ", ".join(f"n={n}: {est.estimate_scan_latency(n, 16):.2f}" for n in est.n_values)
        + "; analytic / profiled at k=16: "
        + ", ".join(f"n={n}: {r:.3f}" for n, r in ratio.items())
        + f"; the packaged grid ({packaged.grid_source}) / profiled at k=16: "
        + ", ".join(f"n={n}: {r:.3f}" for n, r in ratio_p.items())
        + f"; grid point n=4096, k=16: {json.dumps(grid_k1)}")
    del x
    # The profiled grid crosses save and load into the loaded index's
    # policy; round A then runs with the policy a default build sets on the
    # card (the packaged grid).
    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = QuakeIndex(device=dev).load(tmp)
    lp = loaded.latency_profile
    if (lp is None or lp.grid_source != "csv"
            or not np.allclose(lp.latency_grid, est.latency_grid, rtol=1e-5, atol=0)
            or loaded.maintenance_policy is None
            or loaded.maintenance_policy.cost_estimator.latency_estimator is not lp
            or loaded.maintenance_policy.hit_count_tracker.get_num_queries_recorded() != 0):
        raise AssertionError("the loaded index lost the latency grid or its fresh policy")
    del loaded, lp
    idx.latency_profile = None
    idx.initialize_maintenance_policy(MaintenancePolicyParams())
    grid_a = idx.maintenance_policy.cost_estimator.latency_estimator.grid_source
    if grid_a != MAINT_PACKAGED:
        raise AssertionError(f"the default policy reads {grid_a}, not {MAINT_PACKAGED}")
    out["round_a_grid"] = grid_a

    # Traffic: a region ages out, then skewed reads fill the window.
    store = idx.store
    sizes = store.partition_sizes()
    active = store.active_rows()
    by_size = active[np.argsort(sizes[active], kind="stable")]
    aged, hot = [int(r) for r in by_size[:MAINT_AGED]], [int(r) for r in by_size[-MAINT_HOT:]]
    gone = np.concatenate([store.get_partition(r)[1][MAINT_KEEP:] for r in aged])
    idx.remove(gone)
    ntotal, ids_before = idx.ntotal(), np.sort(idx.get_ids())
    rng = np.random.default_rng(MAINT_SEED)
    n_skew = int(MAINT_SKEW * NQ_GT)
    pool = np.concatenate([store.get_partition(r)[0] for r in hot])
    spread = float(pool.std())
    skewed = np.concatenate([
        pool[rng.integers(0, len(pool), n_skew)]
        + MAINT_JITTER * spread * rng.standard_normal((n_skew, D)),
        queries[:NQ_GT - n_skew]]).astype(np.float32)
    st = store.state
    valid = st.ids >= 0
    ids_all = st.ids[valid].cpu().numpy()
    gt_u = ids_all[exact_gt(torch, st.codes[valid], torch.from_numpy(queries[:NQ_GT]).to(dev), K)]
    gt_s = ids_all[exact_gt(torch, st.codes[valid], torch.from_numpy(skewed).to(dev), K)]
    before = maint_search(torch, dev, idx, queries, skewed, gt_u, gt_s, nprobe)
    policy = idx.maintenance_policy
    policy.reset()
    torch.cuda.synchronize()
    _ext.reset_launches()
    idx.search(skewed, SearchParams(k=K, nprobe=nprobe))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _ext.launches.items() if v}
    if any(launches.get(k, 0) != 1 for k in MAIN_KERNELS):
        raise AssertionError(f"the skewed batch's search: launches {launches}")
    window = policy.hit_count_tracker.get_num_queries_recorded()
    if window < policy.params.window_size:
        raise AssertionError(f"the skewed batch recorded {window} queries, the window needs "
                             f"{policy.params.window_size}")
    hits = policy.hit_count_tracker.hit_counts(store.P, store.partition_sizes())
    out.update(aged=aged, hot=hot, removed=len(gone), window=window,
               hot_hit_share=float(hits[hot].sum() / max(hits.sum(), 1)), before=before,
               search_launches=launches)

    # Round A: the entry point, with the policy build set.
    gen_aged = {r: int(store.generation[r]) for r in aged}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = idx.maintenance()
    torch.cuda.synchronize()
    out["round_a"] = dict(s=time.perf_counter() - t0, n_splits=info.n_splits,
                          n_deletes=info.n_deletes, delete_us=info.delete_time_us,
                          split_us=info.split_time_us, refine_us=info.split_refine_time_us,
                          total_us=info.total_time_us,
                          rejection_candidates=policy.rejection_candidates,
                          rejection_us=policy.rejection_time_us,
                          gates=maint_gates(torch, idx, ids_before, ntotal, "round A"))
    a = out["round_a"]
    log(f"[maintenance] round A ({card}; grid {grid_a}): window {window} queries "
        f"({out['hot_hit_share']:.3f} of the hits on the {MAINT_HOT} hot rows), {len(gone)} "
        f"vectors aged out of rows {aged}; maintenance() {a['n_splits']} splits, "
        f"{a['n_deletes']} deletes, {a['rejection_candidates']} delete candidates simulated ({a['rejection_us'] / 1e3:.2f} "
        f"ms); delete {a['delete_us'] / 1e3:.2f} ms, split {a['split_us'] / 1e3:.2f} ms, refine "
        f"{a['refine_us'] / 1e3:.2f} ms, total {a['total_us'] / 1e3:.2f} ms; gates "
        f"{json.dumps(a['gates'])}")

    # Round B: the mechanisms on named rows.
    present = [r for r in aged if store.generation[r] == gen_aged[r]]  # not freed in round A
    del_ms = 0.0
    if present:
        _, del_s = timed(torch, lambda: policy._delete_partitions(present, reassign=True))
        del_ms = del_s * 1e3
    sizes = store.partition_sizes()
    active = store.active_rows()
    split_rows = [int(r) for r in active[np.argsort(sizes[active], kind="stable")][-MAINT_HOT:]]
    split_sizes = [int(sizes[r]) for r in split_rows]
    new_rows, split_s = timed(torch, lambda: idx.split_partitions(split_rows))
    refine_ms = timed(torch, lambda: policy.local_refinement(new_rows))[1] * 1e3
    split_ms = split_s * 1e3
    out["round_b"] = dict(deleted=present, delete_ms=del_ms, split_rows=split_rows,
                          split_sizes=split_sizes, new_rows=new_rows, split_ms=split_ms,
                          refine_ms=refine_ms,
                          gates=maint_gates(torch, idx, ids_before, ntotal, "round B"))
    b = out["round_b"]
    log(f"[maintenance] round B ({card}): delete {len(present)} aged rows with reassignment "
        f"{del_ms:.2f} ms; split_partitions of the {MAINT_HOT} largest (sizes {split_sizes}) "
        f"{split_ms:.2f} ms -> {len(new_rows)} rows; local_refinement {refine_ms:.2f} ms; gates "
        f"{json.dumps(b['gates'])}")

    policy.reset()
    after = maint_search(torch, dev, idx, queries, skewed, gt_u, gt_s, nprobe)
    out["after"] = after
    q, pids = probe_batches(torch, dev, idx, queries, nprobe)[BATCH]
    out["gates"] = main_kernel_gates(torch, idx, q, pids, nprobe)
    del q, pids
    with tempfile.TemporaryDirectory() as tmp:
        idx.save(tmp)
        loaded = QuakeIndex(device=dev).load(tmp)
    lpol = loaded.maintenance_policy
    if (loaded.latency_profile is not None or lpol is None
            or lpol.cost_estimator.latency_estimator.grid_source != MAINT_PACKAGED
            or lpol.hit_count_tracker.get_num_queries_recorded() != 0):
        raise AssertionError("the loaded index is not on a fresh policy with the default grid")
    del loaded
    out["s"] = time.perf_counter() - t_phase
    log(f"[maintenance] ({card}) default B={BATCH} batch ms before / after: {before['ms']:.3f} / "
        f"{after['ms']:.3f}; recall@10 uniform {before['recall_uniform']:.4f} / "
        f"{after['recall_uniform']:.4f}, skewed {before['recall_skewed']:.4f} / "
        f"{after['recall_skewed']:.4f}; nlist {NLIST} -> {idx.nlist()}; maintained store "
        f"{gates_text(out['gates'])}; the profiled grid crosses save and load into the loaded "
        f"policy, the loaded index without it reads the default grid; phase {out['s']:.1f} s")
    del idx
    torch.cuda.empty_cache()
    return out


def levels_of(idx) -> list:
    """The index and its chain of parents, the leaf first."""
    out = []
    while idx is not None:
        out.append(idx)
        idx = idx.parent
    return out


def level_gates(torch, idx, what: str) -> float:
    """validate() and contract 6 at every level, each IVF level's parent
    holding one entry a partition; the worst relative norm error."""
    err = 0.0
    for lv in levels_of(idx):
        if not lv.validate():
            raise AssertionError(f"{what}: level {lv.level} does not validate")
        if lv.parent is not None and lv.parent.ntotal() != lv.nlist():
            raise AssertionError(f"{what}: level {lv.level + 1} holds {lv.parent.ntotal()} "
                                 f"centroids for {lv.nlist()} partitions")
        err = max(err, check_contract_6(torch, lv.store, f"{what}, level {lv.level}"))
    return err


def counted(torch, fn) -> dict:
    """fn() with the launch counts set to 0 just before and read just after:
    the kernels it launched."""
    from quake_tpu_torch import _ext

    torch.cuda.synchronize()
    _ext.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in _ext.launches.items() if v}


def multilevel_index(torch, dev, x, queries, gt, three: bool) -> tuple:
    """One index of the multilevel phase: the corpus built with default
    IndexBuildParams at nlist ML_NLIST (calibrate_aps), under a flat parent
    or (three) an IVF parent of ML_PARENT_NLIST; recall@10 of the NQ_GT
    queries and ms per B=ML_BATCH batch at each of ML_NPROBES; the launches
    of one fixed-nprobe batch (the fused path's K3, K1 and, where the pool
    merges on it, K2 over a flat parent; none over an IVF parent, whose
    leaf runs the "xla" scan as in the JAX package); APS at ML_TARGET in
    aps_mode auto and planned with their launches, and every K1, K2 and K3
    call of a planned batch (and of the fused batch) against its plain
    version. Returns (index, summary)."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch.utils import compute_recall

    what = "3-level" if three else "2-level"
    bp = (IndexBuildParams(nlist=ML_NLIST, parent_params=IndexBuildParams(nlist=ML_PARENT_NLIST))
          if three else IndexBuildParams(nlist=ML_NLIST))
    idx = QuakeIndex(device=dev)
    _, build_s = timed(torch, lambda: idx.build(x, np.arange(N, dtype=np.int64), bp))
    levels = levels_of(idx)
    if len(levels) != (3 if three else 2):
        raise AssertionError(f"{what}: {len(levels)} levels")
    out = dict(build_s=build_s, levels=[dict(level=lv.level, nlist=lv.nlist(), ntotal=lv.ntotal(),
                                             C=lv.store.C) for lv in levels],
               calibrated=dict(dense_w=idx.aps_dense_w, width_clip=idx.aps_width_clip,
                               budget_w=idx.aps_budget_w, radius=idx.aps_radius_ab is not None),
               norm_err=level_gates(torch, idx, f"{what} after the build"))
    q = torch.from_numpy(queries[:ML_BATCH]).to(dev)
    fixed = {}
    for npb in ML_NPROBES:
        sp = SearchParams(k=K, nprobe=npb)
        res = idx.search(queries[:NQ_GT], sp)
        if res.ids.shape != (NQ_GT, K) or (res.ids < 0).any() or not np.isfinite(
                res.distances).all():
            raise AssertionError(f"{what} at nprobe {npb}: expected {K} ids and finite "
                                 "distances a query")
        fixed[npb] = dict(recall=compute_recall(res.ids, gt, K),
                          ms=time_ms(torch, lambda: idx._search_device_full(q, sp), reps=5))
    out["fixed"] = fixed
    sp32 = SearchParams(k=K, nprobe=32)
    launches = counted(torch, lambda: idx._search_device_full(q, sp32))
    want = set() if three else {"flat_topk", "grouped_scan", *GROUPING} | (
        {"merge_positions"} if merges_on_k2(idx.store.C, 32, K) else set())
    if set(launches) != want or any(v != 1 for v in launches.values()):
        raise AssertionError(f"{what}: the fixed-nprobe batch launched {launches}, the route "
                             f"runs {sorted(want) or 'no kernel'} once")
    out["fixed_launches"] = launches
    summary = {}
    if not three:  # K3 at N = ML_NLIST slots, K1 and K2 of the fused batch
        check_recorded(torch, f"{what} fused", recorded_calls(
            lambda: idx._search_device_full(q, sp32)), summary)
    aps = {}
    for mode in ML_APS_MODES:
        sp = SearchParams(k=K, recall_target=ML_TARGET, aps_mode=mode)
        r = time_aps(torch, idx, q, sp)
        r["recall"] = compute_recall(idx.search(queries[:NQ_GT], sp).ids, gt, K)
        r["launches"] = counted(torch, lambda: idx._search_device_full(q, sp))
        aps[mode] = r
    out["aps"] = aps
    planned = SearchParams(k=K, recall_target=ML_TARGET, aps_mode="planned")
    check_recorded(torch, f"{what} planned", recorded_calls(
        lambda: idx._search_device_full(q, planned)), summary)
    if not any(name.startswith("grouped_scan") for name in summary):
        raise AssertionError(f"{what}: the planned APS batch ran no K1: {summary}")
    out["gates"] = summary
    ml_log(f"{what}: build {build_s:.2f} s, levels "
           + " / ".join(f"{lv['nlist']} partitions of C {lv['C']}" for lv in out["levels"])
           + f"; calibrated {json.dumps(out['calibrated'])}; recall@10 / ms per B={ML_BATCH} "
           + ", ".join(f"nprobe {n}: {v['recall']:.4f} / {v['ms']:.3f}" for n, v in fixed.items())
           + f"; fixed-nprobe launches {launches}; APS at {ML_TARGET} "
           + ", ".join(f"{m}: recall {v['recall']:.4f}, {v['ms']:.3f} ms, scanned "
                       f"{v['scanned']:.2f}, launches {v['launches']}" for m, v in aps.items())
           + f"; calls against their plain versions {json.dumps(summary)}")
    return idx, out


def multilevel_mutation(torch, dev, idx, queries) -> dict:
    """The 3-level index's add / remove round: a flood of tight copies of the
    largest leaf partition's centroid, sized past C and the split cap, that
    the leaf splits (its parent, the IVF mid level, loses the old centroid
    and takes the new ones through its own remove and add); the flood
    removed; the gates of every level after each step; then a save and a
    load that returns the same ids."""
    from quake_tpu_torch import QuakeIndex, SearchParams

    store, mid = idx.store, idx.parent
    C0, nlist0 = store.C, idx.nlist()
    mid_ids0 = set(mid.get_ids().tolist())
    sizes = store.partition_sizes()
    target = int(np.argmax(sizes))
    n_flood = max(C0, split_cap(idx.ntotal() + 2 * C0, nlist0)) - int(sizes[target]) + \
        MUTATION_FLOOD_OVER
    cent = store.state.centroids[target].cpu().numpy()
    rng = np.random.default_rng(ML_SEED)
    flood = (cent + 1e-3 * rng.standard_normal((n_flood, D))).astype(np.float32)
    flood_ids = np.arange(5 * N, 5 * N + n_flood, dtype=np.int64)
    _, add_s = timed(torch, lambda: idx.add(flood, flood_ids))
    mid_ids = set(mid.get_ids().tolist())
    if store.C != C0 or idx.nlist() <= nlist0 or mid_ids == mid_ids0:
        raise AssertionError(f"the flood was to split leaf partition {target} with C={C0} held "
                             f"and change the mid level: C {store.C}, nlist {nlist0} -> "
                             f"{idx.nlist()}, mid-level ids changed {mid_ids != mid_ids0}")
    out = dict(flood=n_flood, add_s=add_s, nlist_after=idx.nlist(),
               mid_level=dict(removed=len(mid_ids0 - mid_ids), added=len(mid_ids - mid_ids0),
                              nlist=mid.nlist()),
               norm_err=level_gates(torch, idx, "3-level after the flood"))
    _, out["remove_s"] = timed(torch, lambda: idx.remove(flood_ids))
    out["norm_err_removed"] = level_gates(torch, idx, "3-level after the removal")
    if idx.ntotal() != N:
        raise AssertionError(f"3-level after the removal: ntotal {idx.ntotal()}")
    sp = SearchParams(k=K, nprobe=32)
    with tempfile.TemporaryDirectory() as tmp:
        _, out["save_s"] = timed(torch, lambda: idx.save(tmp))
        loaded, out["load_s"] = timed(torch, lambda: QuakeIndex(device=dev).load(tmp))
    if len(levels_of(loaded)) != 3 or not np.array_equal(
            loaded.search(queries[:NQ_GT], sp).ids, idx.search(queries[:NQ_GT], sp).ids):
        raise AssertionError("the loaded 3-level index returns other ids")
    level_gates(torch, loaded, "the loaded 3-level index")
    ml_log(f"3-level add / remove: a flood of {n_flood} into leaf partition {target} split it "
           f"({nlist0} -> {out['nlist_after']} partitions, C {C0} held; the mid level lost "
           f"{out['mid_level']['removed']} and took {out['mid_level']['added']} centroids) in "
           f"{add_s:.3f} s; removed in {out['remove_s']:.3f} s; every level validates; save "
           f"{out['save_s']:.2f} s, load {out['load_s']:.2f} s, the same ids")
    return out


def phase_multilevel(torch, dev, x, queries, gt) -> dict:
    """Multi-level parents at full width (phase 17 of the module's
    docstring): the corpus at nlist ML_NLIST under an IVF parent of
    ML_PARENT_NLIST (three levels) beside the same nlist under a flat parent
    (the fused path, K3 at N = ML_NLIST), each through multilevel_index; the
    3-level index's add / remove round and save / load. Returns its
    summary."""
    t0 = time.perf_counter()
    idx3, three = multilevel_index(torch, dev, x, queries, gt, three=True)
    three["mutation"] = multilevel_mutation(torch, dev, idx3, queries)
    del idx3
    torch.cuda.empty_cache()
    idx2, two = multilevel_index(torch, dev, x, queries, gt, three=False)
    del idx2
    torch.cuda.empty_cache()
    out = {"3-level": three, "2-level": two, "s": time.perf_counter() - t0}
    ml_log(f"phase {out['s']:.1f} s")
    return out


def ml_log(msg: str) -> None:
    """A `[multilevel]` line on stderr, beside the card's name and power limit."""
    log(f"[multilevel] ({card_line()}) {msg}")


def spill_log(msg: str) -> None:
    """A `[spill]` line on stderr, beside the card's name and power limit."""
    log(f"[spill] ({card_line()}) {msg}")


def spill_invariant(torch, idx, when: str) -> int:
    """The spilled store's invariant on the card (tests/test_spill.py:
    24-39): every resident id exactly twice, in two different partitions,
    and the two id maps naming those partitions. Returns the ids checked."""
    st, P = idx.store.state, idx.store.P
    valid = st.ids >= 0
    rows = torch.nonzero(valid)[:, 0]
    key = torch.sort(st.ids[valid].long() * P + rows).values
    ids_s, rows_s = key // P, key % P
    n = idx.ntotal()
    if key.numel() != 2 * n or not torch.equal(ids_s[0::2], ids_s[1::2]):
        raise AssertionError(f"{when}: {key.numel()} residencies for {n} ids, or an id not twice")
    if bool((rows_s[0::2] == rows_s[1::2]).any()):
        raise AssertionError(f"{when}: an id's two copies share a partition")
    if len(torch.unique(ids_s[0::2])) != n:
        raise AssertionError(f"{when}: an id resident more than twice")
    uid = ids_s[0::2].cpu().numpy()
    maps = np.sort(np.stack([idx.store.id_map.get_batch(uid),
                             idx.store.spill_map.get_batch(uid)], 1), 1)
    if not (maps == torch.stack([rows_s[0::2], rows_s[1::2]], 1).cpu().numpy()).all():
        raise AssertionError(f"{when}: the id maps do not name the copies' partitions")
    return n


def duplicate_rows(torch, ids) -> int:
    """Rows of a result (a numpy or torch [B, k] id matrix) that hold an id
    >= 0 twice."""
    t = torch.as_tensor(ids)
    s = torch.sort(t, dim=1).values
    return int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(1).sum())


def spill_gates(torch, idx, queries, sp, when: str) -> dict:
    """After a mutation of the spilled index: validate(), the invariant,
    contract 6 (both maps counted), one parent centroid a partition, and a
    B=NQ_GT search with no id twice in a row."""
    if not idx.validate() or idx.parent.ntotal() != idx.nlist():
        raise AssertionError(f"{when}: the spilled index does not validate")
    n = spill_invariant(torch, idx, when)
    err = check_contract_6(torch, idx.store, when)
    dups = duplicate_rows(torch, idx.search(queries[:NQ_GT], sp).ids)
    if dups:
        raise AssertionError(f"{when}: {dups} result rows hold an id twice")
    return dict(ntotal=n, nlist=idx.nlist(), C=idx.store.C, norm_err=err)


def checked_batch(torch, what: str, search):
    """One batch, search() (an idx._search_device_full call), with
    the launches counted from 0 just before it and read just after, and
    every K1, K2 and K3 call it made recorded and then held against its
    plain version (check_recorded); the recorded kernels must be the ones
    launched. Returns (launches, the result's ids, the checks' summary)."""
    from quake_tpu_torch import _ext

    res = []
    torch.cuda.synchronize()
    _ext.reset_launches()
    calls = recorded_calls(lambda: res.append(search()))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _ext.launches.items() if v}
    checks = {}
    check_recorded(torch, what, calls, checks)
    if set(checks) != set(launches):
        raise AssertionError(f"{what}: the recorded calls ({sorted(checks)}) are not the "
                             f"kernels the batch launched ({launches})")
    return launches, res[0][1], checks


def spill_search(torch, dev, idx, f32_idx, queries, gt) -> dict:
    """Fixed nprobe on the spilled index against the unspilled f32 one:
    recall@10 of the NQ_GT queries at each nprobe of each index's grid, and
    of the exact scan of the same probed partitions (the "reference" scan)
    at SPILL_EXACT_NPROBES; the spilled index above the unspilled one at
    SPILL_GATE_NPROBE and at its own 0.90 nprobe (v11), and at every
    SPILL_EXACT_NPROBES (the exact scan); the smallest nprobe reaching each
    SPILL_TARGETS recall (None where the grid holds none), B=BATCH batches
    there (time_batch), QPS at equal recall; the spilled path's launches in
    one batch (K1 and K3, no K2, nothing else), no id twice in a row, and
    every K1 and K3 call of that counted batch held against its plain
    version (checked_batch)."""
    from quake_tpu_torch import SearchParams
    from quake_tpu_torch.utils import compute_recall

    q_gt = queries[:NQ_GT]
    out = dict(recall={"spill": {}, "f32": {}}, exact={"spill": {}, "f32": {}}, nprobe={},
               batches={})
    for name, index, grid in (("spill", idx, SPILL_NPROBES), ("f32", f32_idx, UNSPILLED_NPROBES)):
        for nprobe in grid:
            ids = index.search(q_gt, SearchParams(k=K, nprobe=nprobe)).ids
            if duplicate_rows(torch, ids):
                raise AssertionError(f"{name} nprobe {nprobe}: a result row holds an id twice")
            out["recall"][name][nprobe] = compute_recall(ids, gt, K)
        os.environ["QUAKE_TPU_KERNEL"] = "reference"
        try:
            for nprobe in SPILL_EXACT_NPROBES:
                ids = index.search(q_gt, SearchParams(k=K, nprobe=nprobe)).ids
                if duplicate_rows(torch, ids):
                    raise AssertionError(f"{name} exact scan, nprobe {nprobe}: an id twice")
                out["exact"][name][nprobe] = compute_recall(ids, gt, K)
        finally:
            del os.environ["QUAKE_TPU_KERNEL"]
    rs, rf = out["recall"]["spill"], out["recall"]["f32"]
    es, ef = out["exact"]["spill"], out["exact"]["f32"]
    spill_log(f"recall@10 by nprobe (v11): spilled {json.dumps(rs)}; unspilled "
        f"{json.dumps(rf)}; the exact scan of the probed partitions: spilled {json.dumps(es)}, "
        f"unspilled {json.dumps(ef)}")
    for target in SPILL_TARGETS:
        for name, rec in (("spill", rs), ("f32", rf)):
            hit = [p for p in sorted(rec) if rec[p] >= target]
            out["nprobe"][f"{name}@{target}"] = hit[0] if hit else None
    n90 = out["nprobe"]["spill@0.9"]
    if n90 is None:
        raise AssertionError(f"the spilled index reaches recall {SPILL_TARGETS[0]} at no nprobe "
                             f"of {SPILL_NPROBES}")
    worse = [p for p in sorted({SPILL_GATE_NPROBE, n90}) if rs[p] <= rf[p]]
    worse += [f"{p} (exact scan)" for p in SPILL_EXACT_NPROBES if es[p] <= ef[p]]
    if worse:
        raise AssertionError(f"spilled recall not above the unspilled one at nprobe {worse}")
    qd = torch.from_numpy(queries[:BATCH]).to(dev)
    for key, nprobe in out["nprobe"].items():
        if nprobe is None:
            spill_log(f"{key}: no nprobe of the grid reaches it (the best: "
                f"{max((rs if key.startswith('spill') else rf).values()):.4f})")
            continue
        index = idx if key.startswith("spill") else f32_idx
        sp = SearchParams(k=K, nprobe=nprobe)
        r = dict(time_batch(torch, index, qd, sp, gt), nprobe=nprobe)
        if index is idx:
            r["launches"], ids32, r["kernel_checks"] = checked_batch(
                torch, key, lambda: idx._search_device_full(qd, sp))
            if set(r["launches"]) != set(SPILL_KERNELS) or any(
                    v != 1 for v in r["launches"].values()):
                raise AssertionError(f"the spilled batch must launch K1 and K3 once each and "
                                     f"no K2: {r['launches']}")
            dups = duplicate_rows(torch, ids32)
            if dups:
                raise AssertionError(f"spilled B={BATCH}: {dups} rows hold an id twice")
        out["batches"][key] = r
        spill_log(f"{key}: nprobe {nprobe}, B={BATCH}: {batch_text(r)}"
            + (f", launches {r['launches']}; its K1 and K3 calls against their plain versions: "
               f"{json.dumps(r['kernel_checks'])}" if "launches" in r else ""))
    for target in SPILL_TARGETS:
        s, f = out["batches"].get(f"spill@{target}"), out["batches"].get(f"f32@{target}")
        if s is None or f is None:
            continue
        out[f"qps_ratio@{target}"] = s["qps"] / f["qps"]
        spill_log(f"recall {target}: spilled {s['qps']:,.0f} QPS (nprobe {s['nprobe']}), "
            f"unspilled {f['qps']:,.0f} QPS (nprobe {f['nprobe']}): ratio "
            f"{out[f'qps_ratio@{target}']:.3f}")
    return out


def spill_small_and_aps(torch, dev, idx, queries, gt, nprobe) -> dict:
    """The spilled index's other search paths: B=SPILL_SMALL_B query-major
    (grouped_scan_xla with dedup: host clock, mean of 10) and APS in each
    SPILL_APS_MODES at APS_TARGET (the scans at 2k, then dedup_topk):
    recall@10 of the NQ_GT queries (APS_RECALL_GATES), B=APS_BATCH ms
    (time_aps), launches of one batch and every K1, K2 and K3 call of it
    held against its plain version (checked_batch); no id twice in any
    row."""
    from quake_tpu_torch import SearchParams, _ext
    from quake_tpu_torch.utils import compute_recall

    out = {}
    sp = SearchParams(k=K, nprobe=nprobe)
    qs = queries[:SPILL_SMALL_B]
    idx.search(qs, sp)
    torch.cuda.synchronize()
    _ext.reset_launches()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        res = idx.search(qs, sp)
        ts.append((time.perf_counter() - t0) * 1e3)
    if duplicate_rows(torch, res.ids) or (res.ids < 0).any():
        raise AssertionError(f"spilled B={SPILL_SMALL_B}: an id twice or missing in a row")
    out[f"B{SPILL_SMALL_B}"] = dict(ms=float(np.mean(ts)), ms_min=float(np.min(ts)),
                                    launches={k: v // 10 for k, v in _ext.launches.items() if v})
    spill_log(f"B={SPILL_SMALL_B} query-major (grouped_scan_xla with dedup), nprobe {nprobe}: "
        f"{out[f'B{SPILL_SMALL_B}']['ms']:.3f} ms a search (host clock, mean of 10; min "
        f"{out[f'B{SPILL_SMALL_B}']['ms_min']:.3f}), launches a search "
        f"{out[f'B{SPILL_SMALL_B}']['launches']}")
    qa = torch.from_numpy(queries[:APS_BATCH]).to(dev)
    for mode in SPILL_APS_MODES:
        spa = SearchParams(k=K, recall_target=APS_TARGET, aps_mode=mode)
        ids = idx.search(queries[:NQ_GT], spa).ids
        if duplicate_rows(torch, ids):
            raise AssertionError(f"spilled APS {mode}: a result row holds an id twice")
        recall = compute_recall(ids, gt, K)
        launches, ids32, checks = checked_batch(
            torch, f"APS {mode}", lambda: idx._search_device_full(qa, spa))
        if duplicate_rows(torch, ids32) or "grouped_scan" not in launches:
            raise AssertionError(f"spilled APS {mode}: an id twice, or no K1: {launches}")
        r = dict(time_aps(torch, idx, qa, spa, loop=mode == "loop"), recall=recall,
                 launches=launches, kernel_checks=checks)
        out[mode] = r
        spill_log(f"APS {mode} at target {APS_TARGET}: recall@10 {recall:.4f}, B={APS_BATCH} "
            f"{r['ms']:.3f} ms/batch, mean scanned {r['scanned']:.2f}, steps {r['steps']}, "
            f"syncs {r['syncs']}, launches {launches}; its K1, K2 and K3 calls against their "
            f"plain versions: {json.dumps(checks)}")
        if recall < APS_RECALL_GATES[mode]:
            raise AssertionError(f"spilled APS {mode}: recall@10 {recall} below "
                                 f"{APS_RECALL_GATES[mode]}")
    return out


def phase_spill(torch, dev, x, queries, gt, f32_idx) -> dict:
    """SOAR spill at full width (phase 13 of the module's docstring): the
    main corpus built with spill=True, searched at fixed nprobe against the
    unspilled f32 index, query-major and with APS, mutated, saved and
    loaded, and maintained; the spilled invariant after every step."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
    from quake_tpu_torch import index as tindex

    soar_s = []
    real_soar = tindex.soar_assign

    def timed_soar(*a, **kw):  # the build's own call, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real_soar(*a, **kw)
        soar_s.append(time.perf_counter() - t0)
        return r

    tindex.soar_assign = timed_soar
    try:
        t0 = time.perf_counter()
        idx = QuakeIndex(device=dev)
        bt = idx.build(x, np.arange(N, dtype=np.int64),
                       IndexBuildParams(nlist=NLIST, metric="l2", niter=NITER,
                                        calibrate_aps=False, spill=True,
                                        soar_lambda=SPILL_LAMBDA))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        tindex.soar_assign = real_soar
    st = idx.store.state
    out = dict(build_s=build_s, soar_s=sum(soar_s), train_s=bt.train_time_us / 1e6,
               assign_s=bt.assign_time_us / 1e6, P=idx.store.P, C=idx.store.C, nlist=idx.nlist(),
               store_bytes=sum(t.numel() * t.element_size()
                               for t in (st.codes, st.ids, st.norms, st.sizes)),
               residencies=int(st.sizes.sum()))
    if out["residencies"] != 2 * N or not idx.validate():
        raise AssertionError(f"the spilled build holds {out['residencies']} residencies for {N} "
                             f"vectors, or does not validate")
    spill_invariant(torch, idx, "after the build")
    sizes = idx.store.partition_sizes()[idx.store.active_rows()]
    spill_log(f"build {build_s:.2f} s (k-means {out['train_s']:.2f} s, soar_assign "
        f"{out['soar_s']:.3f} s, store {out['assign_s']:.2f} s): nlist={out['nlist']} "
        f"P={out['P']} C={out['C']} (partition sizes {int(sizes.min())}-{int(sizes.max())}, mean "
        f"{sizes.mean():.0f}), store {out['store_bytes'] / 1e9:.3f} GB, {out['residencies']} "
        f"residencies, validate() and the invariant hold")

    out["fixed"] = spill_search(torch, dev, idx, f32_idx, queries, gt)
    n90 = out["fixed"]["nprobe"]["spill@0.9"]
    out["sampled"] = sampled_bounds(torch, dev, idx, queries, gt, SPILL_SAMPLED_NPROBE,
                                    "the spilled index")
    out.update(spill_small_and_aps(torch, dev, idx, queries, gt, n90))
    sp = SearchParams(k=K, nprobe=n90)

    rng = np.random.default_rng(SPILL_SEED)
    fresh = make_manifold(SPILL_ADD, D, 4096, seed=SPILL_SEED)
    nlist0 = idx.nlist()
    _, t = timed(torch, lambda: idx.add(fresh, np.arange(3 * N, 3 * N + SPILL_ADD)))
    out["add"] = dict(spill_gates(torch, idx, queries, sp, "after the add"), s=t,
                      per_s=SPILL_ADD / t, splits=idx.nlist() - nlist0)
    gone = rng.choice(idx.get_ids(), SPILL_REMOVE, replace=False)
    _, t = timed(torch, lambda: idx.remove(gone))
    out["remove"] = dict(spill_gates(torch, idx, queries, sp, "after the remove"), s=t,
                         per_s=SPILL_REMOVE / t)
    moved = rng.choice(idx.get_ids(), SPILL_MODIFY, replace=False)
    new = make_manifold(SPILL_MODIFY, D, 4096, seed=SPILL_SEED + 1)
    _, t = timed(torch, lambda: idx.modify(moved, new))
    if not np.array_equal(idx.get(moved), new):
        raise AssertionError("the modified vectors do not read back")
    out["modify"] = dict(spill_gates(torch, idx, queries, sp, "after the modify"), s=t,
                         per_s=SPILL_MODIFY / t)
    for step in ("add", "remove", "modify"):
        r = out[step]
        spill_log(f"{step}: {r['s']:.3f} s, {r['per_s']:,.0f} vectors/s; ntotal {r['ntotal']}, "
            f"nlist {r['nlist']}, C {r['C']}; gates hold")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spilled")
        _, t_save = timed(torch, lambda: idx.save(path))
        nbytes = dir_bytes(path)
        loaded, t_load = timed(torch, lambda: QuakeIndex().load(path))
    same = same_store(torch, idx.store, loaded.store, "the loaded spilled index")
    spill_invariant(torch, loaded, "after the load")
    if not np.array_equal(loaded.search(queries[:NQ_GT], sp).ids,
                          idx.search(queries[:NQ_GT], sp).ids):
        raise AssertionError("the loaded spilled index returns other ids")
    out["save_load"] = dict(save_s=t_save, load_s=t_load, bytes=nbytes, **same)
    spill_log(f"save {t_save:.2f} s, load {t_load:.2f} s, {nbytes / 1e9:.3f} GB; arrays, "
        f"invariant and search ids equal after the load")
    del loaded
    torch.cuda.empty_cache()

    del idx
    torch.cuda.empty_cache()
    out.update(spill_maintenance(torch, dev, x, queries))
    return out


def spill_maintenance(torch, dev, x, queries) -> dict:
    """Maintenance of a spilled index at a cut depth (SPILL_MAINT_N vectors,
    nlist SPILL_MAINT_NLIST): one maintenance() after an NQ_GT-query window
    (its stage ms, splits, deletes), then the SPILL_DELETE smallest
    partitions deleted with reassignment (each copy re-homed away from its
    twin's partition), spill_gates after each."""
    from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

    idx = QuakeIndex(device=dev)
    idx.build(x[:SPILL_MAINT_N], np.arange(SPILL_MAINT_N, dtype=np.int64),
              IndexBuildParams(nlist=SPILL_MAINT_NLIST, metric="l2", niter=NITER,
                               calibrate_aps=False, spill=True, soar_lambda=SPILL_LAMBDA))
    sp = SearchParams(k=K, nprobe=SPILL_MAINT_NPROBE)
    policy = idx.maintenance_policy
    idx.search(queries[:NQ_GT], sp)  # fills the 1000-query window
    nlist0, C0 = idx.nlist(), idx.store.C
    info, t = timed(torch, idx.maintenance)
    out = {}
    out["maintenance"] = dict(spill_gates(torch, idx, queries, sp, "after maintenance()"), s=t,
                              n=SPILL_MAINT_N, nlist_before=nlist0, C_before=C0,
                              splits=info.n_splits, deletes=info.n_deletes,
                              candidates=policy.rejection_candidates,
                              delete_ms=info.delete_time_us / 1e3,
                              split_ms=info.split_time_us / 1e3,
                              refine_ms=info.split_refine_time_us / 1e3,
                              total_ms=info.total_time_us / 1e3)
    act = idx.store.active_rows()
    rows = [int(r) for r in act[np.argsort(idx.store.partition_sizes()[act],
                                           kind="stable")[:SPILL_DELETE]]]
    _, t = timed(torch, lambda: policy._delete_partitions(rows, reassign=True))
    out["delete"] = dict(spill_gates(torch, idx, queries, sp, "after the named delete"),
                         rows=rows, ms=t * 1e3)
    m = out["maintenance"]
    spill_log(f"maintenance() on {SPILL_MAINT_N} x {D} spilled (nlist {nlist0}, C {C0}) after "
        f"a {NQ_GT}-query window at nprobe {SPILL_MAINT_NPROBE}: {m['splits']} splits, "
        f"{m['deletes']} deletes, {m['candidates']} candidates simulated; ms delete "
        f"{m['delete_ms']:.2f}, split {m['split_ms']:.2f}, refine {m['refine_ms']:.2f}, total "
        f"{m['total_ms']:.2f}; nlist {m['nlist']}, C {m['C']}; delete of the {SPILL_DELETE} "
        f"smallest partitions {rows}: {out['delete']['ms']:.2f} ms; gates hold")
    del idx
    torch.cuda.empty_cache()
    return out


def merges_on_k2(C: int, nprobe: int, k: int) -> bool:
    """Whether the v11 pool tail of a search at (C, nprobe, k) merges on
    kernel K2 (ops/grouped_scan.py::pool_tail, as pallas_grouped.py::
    _pool_tail): key * lane_mult + lane must stay below 2^24. Where it does
    not (C's slot range narrower than the pool's lane range), a top-k of
    the pool's keys takes K2's place."""
    from quake_tpu_torch.ops.grouped_scan import packed_params, pool_lane_mult

    _, levels = packed_params(C)
    lane_mult = pool_lane_mult(nprobe * min(k, C))
    return levels * lane_mult + lane_mult < (1 << 24)


def op_name(key: str) -> str:
    """A profiler key without its return type, anonymous namespace,
    template and argument lists."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


def idle_share(torch, what: str, fn, reps: int = TRACE_REPS) -> dict:
    """reps calls of fn() (one batch each), after three to warm up, on the
    host clock between two synchronizations, first untraced, then traced
    with quake_tpu_torch.profiling.device_trace (scripts/aps_breakdown.py's
    method): the device's busy ms a batch (its operations' self time summed:
    one stream, so they do not overlap), the idle share 1 - busy / wall
    against the traced wall (the profiler's host overhead in it) and
    against the untraced one, and the five longest device operations by
    name (op_name; ms a batch). Busy and the shares are None where the
    profiler recorded no device time. An `[idle]` line."""
    from quake_tpu_torch.profiling import device_summary, device_trace

    def wall_ms():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    untraced = wall_ms()
    with tempfile.TemporaryDirectory() as tmp, device_trace(tmp) as prof:
        traced = wall_ms()
    busy, ops = device_summary(prof, reps)
    by_name = {}
    for key, ms in ops:
        by_name[op_name(key)] = by_name.get(op_name(key), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = dict(wall_ms=traced, untraced_wall_ms=untraced, busy_ms=busy or None,
               idle_share=max(0.0, 1.0 - busy / traced) if busy else None,
               untraced_idle_share=max(0.0, 1.0 - busy / untraced) if busy else None,
               top_ms={k: round(v, 4) for k, v in top})
    if busy:
        log(f"[idle] ({card_line()}) {what}, {reps} batches traced: wall {traced:.3f} ms a "
            f"batch ({untraced:.3f} untraced), device busy {busy:.3f} ms, idle share "
            f"{out['idle_share']:.3f} ({out['untraced_idle_share']:.3f} against the untraced "
            f"wall); the five longest device operations (ms a batch): "
            f"{json.dumps(out['top_ms'])}")
    else:
        log(f"[idle] ({card_line()}) {what}: not measured (the profiler recorded no device "
            f"time); wall {traced:.3f} ms a batch ({untraced:.3f} untraced)")
    return out


def workload_log(msg: str) -> None:
    """A `[workload]` line on stderr, beside the card's name and power limit."""
    log(f"[workload] ({card_line()}) {msg}")


def phase_workload(torch, dev, x, queries, n_ops: int = WORKLOAD_OPS) -> dict:
    """Phase 16: regression/configs/sift1m_balanced.yaml's workload on the
    card through the port's tooling. DynamicWorkloadGenerator over the main
    corpus (the base pool; its clustering index built on the card) with the
    main queries, WORKLOAD's traffic and n_ops operations; the initial index
    built and saved by WorkloadEvaluator.initialize_index, then
    evaluate_workload (the saved index loaded, the default maintenance
    policy set, maintenance() after every operation) through a QuakeWrapper
    that counts each query op's K1, K2 and K3 launches and records the last
    query op's calls. Gates: n_total equal to the runbook's n_resident after
    every operation; validate(), contract 6 and one parent centroid a
    partition at the end; K1 and K3 once on every query op, K2 once where
    its pool merges on K2 (merges_on_k2) and never elsewhere; the last
    query op's K1 calls at overlap >= WORKLOAD_K1_OVERLAP, its K3 (and K2)
    calls equal; mean recall@10 > WORKLOAD_RECALL_GATE. Then THREADS threads search the final
    index at once (THREAD_REPS B=NQ_GT searches each): ids equal to the
    serial search's, every launch counted; and a B=NQ_GT search under
    debug mode (quake_tpu_torch.debug) stays clean while a NaN produced on
    the card raises."""
    import threading
    from pathlib import Path

    from quake_tpu_torch import MaintenancePolicyParams, SearchParams, _ext
    from quake_tpu_torch.debug import disable_debug_mode, enable_debug_mode
    from quake_tpu_torch.workload import DynamicWorkloadGenerator, WorkloadEvaluator
    from quake_tpu_torch.wrappers.quake import QuakeWrapper

    out = {"ops": n_ops}
    with tempfile.TemporaryDirectory() as tmp:
        wdir = Path(tmp) / "workload"
        gen = DynamicWorkloadGenerator(workload_dir=wdir, base_vectors=x, queries=queries,
                                       number_of_operations=n_ops, device=dev, **WORKLOAD)
        _, out["generate_s"] = timed(torch, gen.generate_workload)
        ops = gen.runbook["operations"]
        out["gt_s"] = sum(op.get("gt_time", 0.0) for op in ops.values())
        out["summary"] = gen.runbook["summary"]
        n_query_ops = out["summary"]["n_queries"]
        del gen
        torch.cuda.empty_cache()
        workload_log(f"generated {out['summary']} over {x.shape[0]} x {x.shape[1]} in "
                     f"{out['generate_s']:.2f} s (its exact ground truth {out['gt_s']:.2f} s)")

        ev = WorkloadEvaluator(wdir, Path(tmp) / "out")
        _, out["build_s"] = timed(torch, lambda: ev.initialize_index(
            "quake", QuakeWrapper(device=dev), WORKLOAD_BUILD))

        class Counted(QuakeWrapper):
            """Each query op's grouping, K1, K2 and K3 launches, and whether
            its store merges on K2 (merges_on_k2); the last query op's calls
            recorded, their tensors copied (later operations write the store
            in place)."""

            def __init__(self):
                super().__init__(device=dev)
                self.per_query, self.calls = [], None

            def search(self, query, **kw):
                before = dict(_ext.launches)
                k2 = merges_on_k2(self.index.store.C, kw["nprobe"], kw["k"])
                if len(self.per_query) + 1 == n_query_ops:
                    res = []
                    self.calls = recorded_calls(
                        lambda: res.append(QuakeWrapper.search(self, query, **kw)), clone=True)
                    res = res[0]
                else:
                    res = QuakeWrapper.search(self, query, **kw)
                self.per_query.append(dict(
                    {k: _ext.launches[k] - before[k] for k in MAIN_KERNELS + GROUPING}, k2=k2))
                return res

        wrapper = Counted()
        with contextlib.redirect_stdout(sys.stderr):  # the evaluator prints its summary
            results, out["evaluate_s"] = timed(torch, lambda: ev.evaluate_workload(
                "quake", wrapper, WORKLOAD_BUILD, WORKLOAD_SEARCH, do_maintenance=True,
                m_params=MaintenancePolicyParams(), batch=True))
    idx = wrapper.index

    bad = [r["operation_number"] for r in results if r["n_total"] != r["n_resident"]]
    if bad:
        raise AssertionError(f"workload: n_total differs from the runbook's n_resident after "
                             f"operations {bad[:10]}")
    if not idx.validate() or idx.parent.ntotal() != idx.nlist():
        raise AssertionError("workload: the final index does not validate")
    out["norm_err"] = check_contract_6(torch, idx.store, "workload, the final index")
    per_type = {}
    for kind in ("insert", "delete", "query"):
        ms = [r["latency_ms"] for r in results if r["operation_type"] == kind]
        per_type[kind] = dict(n=len(ms), mean_ms=float(np.mean(ms)) if ms else None,
                              max_ms=float(np.max(ms)) if ms else None)
    maint = [r["maintenance_ms"] for r in results]
    recalls = [r["recall"] for r in results if r["operation_type"] == "query"]
    launched = {k: sum(p[k] for p in wrapper.per_query) for k in MAIN_KERNELS + GROUPING}
    out.update(per_type=per_type, maintenance_ms_mean=float(np.mean(maint)),
               maintenance_ms_total=float(np.sum(maint)),
               maintenance_ms_max=float(np.max(maint)),
               splits=int(sum(r["maintenance_splits"] or 0 for r in results)),
               deletes=int(sum(r["maintenance_deletes"] or 0 for r in results)),
               recall_mean=float(np.mean(recalls)), recall_min=float(np.min(recalls)),
               recall_last=recalls[-1], nlist_end=idx.nlist(), ntotal_end=idx.ntotal(),
               C_end=idx.store.C,
               grid=idx.maintenance_policy.cost_estimator.latency_estimator.grid_source,
               launches_per_query_op={k: v / max(len(wrapper.per_query), 1)
                                      for k, v in launched.items()})
    wrong = [i for i, p in enumerate(wrapper.per_query)
             if (p["grouped_scan"], p["flat_topk"], p["merge_positions"]) != (1, 1, int(p["k2"]))
             or any(p[g] != 1 for g in GROUPING)]
    if len(wrapper.per_query) != n_query_ops or wrong:
        raise AssertionError(f"workload: every query op must launch the grouping, K1 and K3 once, "
                             f"and K2 once where its pool merges on K2: query ops {wrong[:10]} "
                             f"did not ({len(wrapper.per_query)} of {n_query_ops} query ops "
                             f"searched)")
    out["query_ops_on_k2"] = sum(p["k2"] for p in wrapper.per_query)
    checks = {}
    check_recorded(torch, "workload, last query op", wrapper.calls, checks)
    last = {k: wrapper.per_query[-1][k] for k in MAIN_KERNELS + GROUPING
            if wrapper.per_query[-1][k]}
    if set(checks) != set(last):
        raise AssertionError(f"workload: the recorded calls ({sorted(checks)}) are not the "
                             f"kernels the last query op launched ({last})")
    if (checks["grouped_scan"]["min_overlap"] < WORKLOAD_K1_OVERLAP
            or checks["flat_topk"]["min_overlap"] < 1.0):
        raise AssertionError(f"workload: the last query op's K1 overlap must be >= "
                             f"{WORKLOAD_K1_OVERLAP} and K3 equal (K2 equal where it ran): "
                             f"{checks}")
    out["kernel_checks"] = checks
    if out["recall_mean"] <= WORKLOAD_RECALL_GATE:
        raise AssertionError(f"workload: mean recall@10 {out['recall_mean']} not above "
                             f"{WORKLOAD_RECALL_GATE}")
    pt = per_type
    workload_log(
        f"{n_ops} operations ({pt['insert']['n']} inserts, {pt['delete']['n']} deletes, "
        f"{pt['query']['n']} queries) on the initial {WORKLOAD['initial_size']} built with "
        f"nc {WORKLOAD_BUILD['nc']} in {out['build_s']:.2f} s, evaluated in "
        f"{out['evaluate_s']:.2f} s: ms per insert {pt['insert']['mean_ms']:.3f}, delete "
        f"{pt['delete']['mean_ms']:.3f}, query {pt['query']['mean_ms']:.3f} (B="
        f"{WORKLOAD['query_batch_size']}, nprobe {WORKLOAD_SEARCH['nprobe']}); maintenance "
        f"{out['maintenance_ms_mean']:.3f} ms an operation (max {out['maintenance_ms_max']:.1f}, "
        f"{out['splits']} splits, {out['deletes']} deletes in all, latency grid "
        f"{out['grid']}); recall@10 mean "
        f"{out['recall_mean']:.4f}, min {out['recall_min']:.4f}, last {out['recall_last']:.4f}; "
        f"launches per query op {json.dumps(out['launches_per_query_op'])} (K2 on "
        f"{out['query_ops_on_k2']} query ops, where the pool merges on it); nlist "
        f"{out['nlist_end']}, ntotal {out['ntotal_end']}, C {out['C_end']} at the end; the last "
        f"query op's K1-K3 calls against their plain versions: {json.dumps(checks)}")

    # THREADS threads search the final index at once.
    sp = SearchParams(k=K, nprobe=WORKLOAD_SEARCH["nprobe"])
    serial = idx.search(queries[:NQ_GT], sp).ids
    results_t = [None] * THREADS

    def worker(i):
        results_t[i] = [idx.search(queries[:NQ_GT], sp).ids for _ in range(THREAD_REPS)]

    torch.cuda.synchronize()
    _ext.reset_launches()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    threads_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("workload: a searching thread did not finish")
    counts = {k: _ext.launches[k] for k in MAIN_KERNELS}
    k2 = merges_on_k2(idx.store.C, sp.nprobe, K)
    want = {k: 1 if k != "merge_positions" or k2 else 0 for k in MAIN_KERNELS}
    differ = sum(not np.array_equal(ids, serial) for r in results_t for ids in r)
    if differ or counts != {k: v * THREADS * THREAD_REPS for k, v in want.items()}:
        raise AssertionError(f"workload: {differ} threaded searches differ from the serial one, "
                             f"or launches were lost: {counts}")
    out["threads"] = dict(threads=THREADS, reps=THREAD_REPS, s=threads_s, launches=counts)
    workload_log(f"{THREADS} threads x {THREAD_REPS} searches of B={NQ_GT} at once on the final "
                 f"index in {threads_s:.3f} s: ids equal to the serial search's, launches {counts}")

    # Debug mode: the default search stays clean; a NaN on the card raises.
    enable_debug_mode()
    try:
        _ext.reset_launches()
        dbg, dbg_s = timed(torch, lambda: idx.search(queries[:NQ_GT], sp).ids)
        dbg_launches = {k: _ext.launches[k] for k in MAIN_KERNELS}
        try:
            torch.zeros(4, device=dev) / torch.zeros(4, device=dev)
            trapped = None
        except FloatingPointError as e:
            trapped = str(e)
    finally:
        disable_debug_mode()
    if not np.array_equal(dbg, serial) or dbg_launches != want:
        raise AssertionError(f"workload: the search under debug mode differs or skipped a "
                             f"kernel: {dbg_launches}")
    if trapped is None:
        raise AssertionError("workload: debug mode let a NaN produced on the card through")
    if torch._C._len_torch_dispatch_stack():
        raise AssertionError("workload: a dispatch mode stayed pushed after disable_debug_mode()")
    out["debug"] = dict(search_s=dbg_s, launches=dbg_launches, trapped=trapped)
    workload_log(f"debug mode: the B={NQ_GT} search ran clean in {dbg_s:.3f} s (its K1, K2 and "
                 f"K3 outputs checked: {dbg_launches}), ids equal; 0 / 0 on the card raised "
                 f"\"{trapped}\"")
    del idx, wrapper
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    from quake_tpu_torch import SearchParams, _ext

    if os.environ.pop("QUAKE_TPU_KERNEL", None):
        log("[card] QUAKE_TPU_KERNEL unset: the main phase runs the default scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    k1_build = start_product_only_build()  # beside the library's own nvcc processes
    _ext.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({_ext.library_path().name})")

    phase_small_parity(torch, dev)

    t0 = time.perf_counter()
    x = make_manifold(N, D, 4096, seed=1)
    queries = make_manifold(BATCH, D, 4096, seed=7)
    log(f"[data] {N} x {D} corpus + {BATCH} queries in {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    _ext.reset_launches()
    idx, main_out, gt = phase_main(torch, dev, x, queries)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    log(f"[main] kernel launches on the main path: {launches}")
    missing = [k for k in MAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    qd = torch.from_numpy(queries).to(dev)
    sp = SearchParams(k=K, nprobe=main_out["nprobe"])
    main_out["idle"] = idle_share(torch, f"f32 default, B={BATCH} at nprobe {main_out['nprobe']}",
                                  lambda: idx._search_device_full(qd, sp))
    del qd

    by_name = phase_by_name(torch, dev, idx, queries, gt, main_out["nprobe"],
                            main_out["recall"])
    direct = phase_direct(torch, dev, idx, queries, gt, main_out["nprobe"],
                          by_name["reference"]["recall"])
    latency, flat = phase_latency(torch, dev, idx, x, queries, gt, main_out["nprobe"])
    shard = phase_shard(torch, dev, x, queries, gt, flat, main_out["nprobe"])
    del flat
    torch.cuda.empty_cache()
    phase_small_reference(torch, dev)
    wide = phase_wide(torch, dev)
    kernels = phase_kernels(torch, dev, idx, x, queries, main_out["nprobe"], launches, by_name,
                            direct, k1_build, gt)
    headline, headline_rows, bf16_idx = phase_headline_bf16(torch, dev, x, queries, gt, idx,
                                                            k1_build)
    kernels.extend(headline_rows)
    k1_build[0].cleanup()
    bf16_scans, bf16_rows = phase_bf16_by_name(torch, dev, bf16_idx, queries, gt,
                                               headline["nprobe"], headline["recall"])
    kernels.extend(bf16_rows)
    aps, k1_budget, aps_idx = phase_aps(torch, dev, x, queries, gt, bf16_idx)
    kernels.extend(k1_budget)
    fold, fold_rows = phase_fold(
        torch, dev, aps_idx, idx, bf16_idx, queries, gt, main_out["nprobe"], headline["nprobe"],
        {"main": {"v11g4f64": main_out["recall"], "v7g4f64": by_name["v7g4"]["recall"]},
         "bf16": {"v7g4f64": bf16_scans["by_name"]["v7g4"]["recall"]}})
    kernels.extend(fold_rows)
    del bf16_idx, aps_idx
    torch.cuda.empty_cache()
    bf16_parent, k3_bf16 = phase_bf16_parent(torch, dev, x, queries, gt, idx, main_out["nprobe"])
    kernels.append(k3_bf16)
    multilevel = phase_multilevel(torch, dev, x, queries, gt)
    spill = phase_spill(torch, dev, x, queries, gt, idx)
    workload = phase_workload(torch, dev, x, queries)
    del x
    torch.cuda.empty_cache()
    mutation = phase_mutation(torch, dev, idx, queries, main_out["nprobe"],
                              {"default": main_out[f"B{BATCH}"]["ms"],
                               "sized": direct["sized_topk"]["ms"],
                               "multi": direct["multi_topk"]["ms"]})
    del idx
    torch.cuda.empty_cache()
    maintenance = phase_maintenance(torch, dev, queries, main_out["nprobe"])
    log("[summary] " + json.dumps(dict(main_out, by_name=by_name, direct=direct,
                                       latency=latency, wide=wide, headline_bf16=headline,
                                       bf16_scans=bf16_scans, bf16_parent=bf16_parent,
                                       shard=shard, aps=aps, fold=fold, multilevel=multilevel,
                                       spill=spill,
                                       workload=workload,
                                       mutation=mutation, maintenance=maintenance)))

    if len(kernels) != len(ENTRIES):
        raise AssertionError(f"the kernels line needs {len(ENTRIES)} entries, got {len(kernels)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
