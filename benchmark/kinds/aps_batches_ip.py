"""Traffic kind `aps_batches_ip`: `aps_batches` (one closed-loop client,
batches of queries to `QuakeIndex.search` at a recall target, oneshot, a
pool cycled, `sample_rows_per_call` rows of every call kept with their
depths) on an inner-product index of unit vectors.

The corpus and the queries are the configuration's manifold with every row
divided by its norm (reference_ip.unit_rows), made again bit for bit from
the seed after the window. The judge is the ip reference
(benchmark/reference_ip.py, benchmark/aps_ip.py), with the numbers of
`aps_batches` under their ip forms:
- `ip_err`: the widest gap of a returned score from q.x of the stored row,
  as a share of |q| |x| (the configuration serves exact scores);
- `sel_budget` on K1's ip key scale, over the first min(program depth,
  reference depth) partitions of largest q.c that every sound parent
  ranking probes too;
- `plan_gap`, `norm_err`, `store_err`, `invalid` (scores that never
  rise);
- `recall_short`: the target less the sampled rows' recall@k against their
  exact k of largest q.x over the rows as the index stores them (bf16): the
  build calibrates its recall model against its own codes, and what the
  codes' rounding costs against the inputs shows in `recall_at_10`.
The controls are aps_batches': the reference one precision below the codes
(its scores and store), keyed selections below the codes, the plan's
profile in bfloat16, the radius predictor at MISCALIBRATION.

The build's timing counters (BuildTimingInfo, with the balancing's and the
calibration's time) go to the readings (`readings.build`, microseconds) for
the `build.*` metrics. A program whose BuildTimingInfo has no
balance_time_us cannot run this kind: the Run raises before anything is
built, as aps_batches does without a depth a query.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from benchmark import aps, aps_ip, core, corpus, reference, reference_ip

aps_batches = core.kind("aps_batches")
search_batches = aps_batches.search_batches
MISCALIBRATION = aps_batches.MISCALIBRATION
MAX_K3_SLOTS = 16384  # the most parent slots kernel K3 ranks (ops/flat_topk.py MAX_N)


def _build_counters() -> bool:
    """Whether the program's BuildTimingInfo has balance_time_us."""
    from quake_tpu_torch.timing import BuildTimingInfo
    return "balance_time_us" in {f.name for f in dataclasses.fields(BuildTimingInfo)}


class Run(aps_batches.Run):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if not _build_counters():
            raise RuntimeError("the program reports no build stages (BuildTimingInfo."
                               "balance_time_us): it cannot run aps_batches_ip")
        super().__init__(cfg, traffic, seed, device)

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        """search_batches' set-up (data, build, warm-up), the build's
        counters kept; then the calibrated plan's state."""
        from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

        cfg, tr = self.cfg, self.traffic
        t = time.perf_counter()
        self.manifold = corpus.Manifold.from_config(cfg["corpus"], int(cfg["d"]), self.device)
        x_np = self._corpus().cpu().numpy()
        self.q_np = [q.cpu().numpy() for q in self._queries()]
        t = core.end_phase(self.setup_phases, "data", t, self.device)

        self.index = QuakeIndex(device=self.device)
        timing = self.index.build(x_np, None, IndexBuildParams(metric=cfg["metric"],
                                                               **cfg["build"]))
        del x_np
        self.sp = SearchParams(k=self.k, **cfg["search"])
        t = core.end_phase(self.setup_phases, "build", t, self.device)
        self.readings.build = dataclasses.asdict(timing)
        cents = self.index.store.state.centroids[self.index.store.state.active]
        norms = torch.linalg.vector_norm(cents.double(), dim=1)
        self.notes.append("build: " + json.dumps({
            **self.readings.build, "nlist": self.index.nlist(),
            "C": int(self.index.store.state.codes.shape[1]),
            "P": int(self.index.store.state.codes.shape[0]),
            "centroid_norm_gap": float((norms - 1.0).abs().max())}))

        for _ in range(int(tr["warmup_rounds"])):
            for q in self.q_np:
                self.index.search(q, self.sp)
        self.rng = np.random.default_rng([self.seed, 7])
        core.end_phase(self.setup_phases, "warm_up", t, self.device)
        self.state = aps.ApsState.of(self.index, self.k, self.sp.aps_plan_margin)
        self.notes.append("aps state: " + json.dumps(dataclasses.asdict(self.state)))

    def _corpus(self) -> torch.Tensor:
        return reference_ip.unit_rows(super()._corpus())

    def _queries(self) -> list:
        return [reference_ip.unit_rows(q) for q in super()._queries()]

    # ------------------------------------------------------------ judgement

    def collect(self) -> None:
        """search_batches' collect, with the parent's slot layout taken
        first (kernel K3 folds the parent's slots into lane columns where it
        ranks them: a parent of at most MAX_K3_SLOTS slots), then each
        sampled row's exact k of largest q.x over the inputs (recall_at_10)
        and over the rows as the index stores them (recall_short)."""
        pids = self.index.parent.store.state.ids
        self.parent_ids = pids.clone() if pids.numel() <= MAX_K3_SLOTS else None
        search_batches.Run.collect(self)
        self.truth, _ = reference_ip.exact_topk(self.Q, self.x, self.k)
        self.truth_stored, _ = reference_ip.exact_topk(self.Q, self.stored, self.k)
        self.notes.append("recall@%d against the inputs %r, against the rows as stored %r" % (
            self.k, reference.recall(self.ans_ids, self.truth, self.k),
            reference.recall(self.ans_ids, self.truth_stored, self.k)))

    def _probed(self) -> None:
        """The ip plan of every pool batch, and the selection of every
        sampled row over the partitions every sound parent ranking puts
        within min(program depth, reference depth), and the rows the scan's
        fold surely keeps; each row's key scale."""
        s, dev = self.store, self.device
        C = int(s["codes"].shape[1])
        act = torch.nonzero(s["active"])[:, 0]
        slots = reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)
        ids = s["ids"].to(torch.int64)
        self.part_ids = [ids[p][slots[p]] for p in act.tolist()]
        self.slot_mult = max(1 << int(C - 1).bit_length(), 2)
        xmax = reference_ip.max_norm(self.stored)
        scale = [reference_ip.key_scale(q, xmax, C) for q in self.q]
        batch = [b for b, r, _, _ in self.samples for _ in r]
        self.floor = torch.tensor([scale[b][0] for b in batch], dtype=torch.float64, device=dev)
        self.step = torch.tensor([scale[b][1] for b in batch], dtype=torch.float64, device=dev)
        self.cents = s["centroids"][act]
        self.plans = [aps_ip.plan(q, self.cents, self.state, self.target) for q in self.q]
        self.ref_depth = self._sampled_depths(self.plans)
        self.prog_depth = torch.from_numpy(np.concatenate(self.sample_depths)).to(dev)
        depth = torch.minimum(self.prog_depth, self.ref_depth)
        lanes, block = None, 4096
        if self.parent_ids is not None:
            lanes = aps.parent_lanes(self.parent_ids, act)
            L = -(-act.numel() // aps.PARENT_FOLD) + 1
            block = max(16, min(4096, (1 << 28) // (aps.PARENT_FOLD * L * L)))
        self.probes, self.certain = aps_ip.certain_at_depth(self.Q, self.cents, depth,
                                                            self.state.width, lanes, block=block)
        tol = reference.fold_tol(self.Q, self.stored, self.step, self.codes)
        self.best_ids, self.best_s = reference_ip.probed_topk(
            self.Q, self.stored, self.part_ids, self.probes, self.certain, self.k, tol=tol)

    def numbers(self, precision: str = "f32") -> dict:
        """The numbers compared with the cell's limits: of the program's
        answers, depths and store, or, with a lower `precision` (the
        control), of the reference's top-k and store in that precision, its
        plan's profile in bfloat16 and an exact scan of its plan from the
        miscalibrated radius predictor."""
        dtype = reference.CODE_DTYPES[self.codes]
        s = self.store
        if precision == "f32":
            ids, scores = self.ans_ids, self.ans_d
            store_err = reference.store_violations(s["codes"], s["ids"], s["sizes"], self.x,
                                                   self.alive, dtype)
            depth = self.prog_depth
            recall = reference.recall(self.ans_ids, self.truth_stored, self.k)
        else:
            ids, scores = reference_ip.exact_topk(self.Q, self.stored, self.k,
                                                  precision=precision)
            store_err = int((reference.round_to(self.stored, precision) != self.stored)
                            .any(dim=1).sum())
            depth = self._sampled_depths([aps_ip.plan(q, self.cents, self.state, self.target,
                                                      precision="bf16") for q in self.q])
            recall = self._miscalibrated_recall()
        return {
            "ip_err": reference_ip.ip_err(self.Q, self.stored, ids, scores),
            "sel_budget": self._selection(ids),
            "norm_err": reference.norm_err(s["norms"], s["ids"], s["sizes"], self.x, dtype,
                                           precision),
            "invalid": reference_ip.invalid_answers(ids, scores, self.alive, self.k),
            "store_err": store_err,
            "plan_gap": float((depth != self.ref_depth).double().mean()),
            "recall_short": self.target - recall,
        }

    def keyed_numbers(self, precision: str) -> dict:
        """`sel_budget` of the reference put in the scan's place with K1's
        ip key selection, its products in `precision`."""
        rank = reference_ip.keyed_rank(self.floor, self.step, precision, self.slot_mult)
        ids, _ = reference_ip.probed_topk(self.Q, self.stored, self.part_ids, self.probes,
                                          self.certain, self.k, rank=rank)
        return {"sel_budget": self._selection(ids)}

    def _selection(self, ids) -> float:
        return reference_ip.sel_budget(self.Q, self.stored, ids, self.best_ids, self.best_s,
                                       self.step[:, None], self.codes)

    def _miscalibrated_recall(self) -> float:
        """The sampled rows' recall@k of an exact scan of the reference's
        ip plan with the predicted radius scaled by MISCALIBRATION."""
        state = dataclasses.replace(self.state, radius_a=self.state.radius_a * MISCALIBRATION,
                                    radius_b=self.state.radius_b * MISCALIBRATION)
        plans = [aps_ip.plan(q, self.cents, state, self.target) for q in self.q]
        pids = torch.cat([plans[b][0][torch.from_numpy(r).to(plans[b][0].device)]
                          for b, r, _, _ in self.samples]).to(self.device)
        s, act = self.store, torch.nonzero(self.store["active"])[:, 0]
        slots = reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)
        live = torch.full((s["ids"].shape[0],), -1, dtype=torch.int64, device=self.device)
        live[act] = torch.arange(act.numel(), device=self.device)
        owner = torch.full((self.x.shape[0],), -1, dtype=torch.int64, device=self.device)
        part = torch.nonzero(slots)[:, 0]
        owner[s["ids"][slots].to(torch.int64)] = live[part]
        return aps.plan_recall(owner[self.truth_stored], pids, self._sampled_depths(plans))

    def end_to_end(self) -> dict:
        B = int(self.traffic["batch"])
        return {
            "qps": self.attempted * B / self.elapsed,
            "search_ms_p95": core.percentile([c["ms"] for c in self.readings.calls], 95),
            "recall_at_10": reference.recall(self.ans_ids, self.truth, self.k),
        }
