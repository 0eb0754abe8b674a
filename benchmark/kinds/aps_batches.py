"""Traffic kind `aps_batches`: `search_batches` (one closed-loop client,
batches of queries to `QuakeIndex.search`, a pool cycled, `sample_rows_per_call`
rows of every call kept) at a recall target, where each query scans to a
depth of its own that the recall model plans.

Of every call the benchmark also keeps the depth each sampled row scanned
(`SearchTimingInfo.scanned_per_query`) and the call's mean depth. After the
window the plain reference of the plan (benchmark/aps.py) plans every pool
batch from the build's state and judges:
- `plan_gap`: the share of sampled rows whose depth differs from the
  reference's for the same batch;
- `recall_short`: the recall target less the sampled rows' recall@k against
  their exact k nearest in the corpus (negative where the program beats its
  target), so that a recall model the build fitted wrong, which the plan's
  reference takes from the build as the program does, still shows;
- the selection (`sel_budget`) over the first min(program depth, reference
  depth) ranked partitions that every sound ranking probes too, with the
  tolerance of reference.certain_probes at that depth;
- distances, the contract and the store, as search_batches judges them.
The roofline counts the reference's plan, each query at its depth.

The control of `plan_gap` is the reference's plan with its recall profile
computed in bfloat16; the control of `recall_short` is the recall of an
exact scan of the reference's plan from a radius predictor that predicts
MISCALIBRATION times the radius the build fitted (radius_a and radius_b
scaled).

A program that reports no depth a query cannot run this kind: the Run
raises before anything is built.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from benchmark import aps, core, reference, roofline

search_batches = core.kind("search_batches")

MISCALIBRATION = 0.7  # the control's predicted radius, as a share of the build's


def _depth_counter() -> bool:
    """Whether the program's SearchTimingInfo has scanned_per_query."""
    from quake_tpu_torch.timing import SearchTimingInfo
    return "scanned_per_query" in {f.name for f in dataclasses.fields(SearchTimingInfo)}


class Run(search_batches.Run):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if not _depth_counter():
            raise RuntimeError("the program reports no depth a query "
                               "(SearchTimingInfo.scanned_per_query): it cannot run aps_batches")
        super().__init__(cfg, traffic, seed, device)
        self.target = float(cfg["search"]["recall_target"])
        self.sample_depths: list = []  # the sampled rows' depths, a call
        self.call_depths: list = []  # each call's mean depth
        self.budgets: set = set()  # the pair budgets the calls passed to the scan
        self.state = None

    def setup(self) -> None:
        super().setup()
        self.state = aps.ApsState.of(self.index, self.k, self.sp.aps_plan_margin)
        self.notes.append("aps state: " + json.dumps(dataclasses.asdict(self.state)))

    def _call(self, i: int):
        dt, b, timing = super()._call(i)
        sc = timing.scanned_per_query
        self.sample_depths.append(sc[self.samples[-1][1]].astype(np.int64))
        self.call_depths.append(float(sc.mean()))
        self.budgets.add(int(timing.aps_pair_budget))
        return dt, b, timing

    def window(self, seconds: float) -> None:
        super().window(seconds)
        for c, depth in zip(self.readings.calls, self.call_depths):
            c["depth"] = depth
        self.notes.append(f"window mean depth {core.mean(self.call_depths[:self.attempted])}, "
                          f"pair budgets {sorted(self.budgets)}")

    # ------------------------------------------------------------ judgement

    def collect(self) -> None:
        """search_batches' collect, with the parent's slot layout taken
        first: kernel K3 folds the parent's slots into lane columns."""
        self.parent_ids = self.index.parent.store.state.ids.clone()
        super().collect()
        self.truth, _ = reference.exact_knn(self.Q, self.x, self.k)

    def _probed(self) -> None:
        """The reference's plan of every pool batch, and its selection of
        every sampled row over the partitions every sound parent ranking
        (kernel K3's fold included) puts within min(program depth,
        reference depth), and the rows the scan's fold surely keeps; each
        row's key scale."""
        s, dev = self.store, self.device
        C = int(s["codes"].shape[1])
        act = torch.nonzero(s["active"])[:, 0]
        slots = reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)
        ids = s["ids"].to(torch.int64)
        self.part_ids = [ids[p][slots[p]] for p in act.tolist()]
        self.slot_mult = max(1 << int(C - 1).bit_length(), 2)
        scale = [reference.key_scale(self.q[b], self.stored, C) for b in range(len(self.q))]
        batch = [b for b, r, _, _ in self.samples for _ in r]
        self.floor = torch.tensor([scale[b][0] for b in batch], dtype=torch.float64, device=dev)
        self.step = torch.tensor([scale[b][1] for b in batch], dtype=torch.float64, device=dev)
        self.cents = s["centroids"][act]
        self.plans = [aps.plan(q, self.cents, self.state, self.target) for q in self.q]
        self.ref_depth = self._sampled_depths(self.plans)
        self.prog_depth = torch.from_numpy(np.concatenate(self.sample_depths)).to(dev)
        depth = torch.minimum(self.prog_depth, self.ref_depth)
        lanes = aps.parent_lanes(self.parent_ids, act)
        self.probes, self.certain = aps.certain_at_depth(self.Q, self.cents, depth,
                                                         self.state.width, lanes)
        tol = reference.fold_tol(self.Q, self.stored, self.step, self.codes)
        self.best_ids, self.best_d2 = reference.probed_topk(
            self.Q, self.stored, self.part_ids, self.probes, self.certain, self.k, tol=tol)

    def _sampled_depths(self, plans) -> torch.Tensor:
        """The depths of a plan of every pool batch at the sampled rows."""
        out = [plans[b][1][torch.from_numpy(r).to(plans[b][1].device)]
               for b, r, _, _ in self.samples]
        return torch.cat(out).to(self.device)

    def numbers(self, precision: str = "f32") -> dict:
        """search_batches' numbers, `plan_gap` and `recall_short`: of the
        program's depths and answers, or, with a lower `precision` (the
        control), `plan_gap` of the reference's plan with its recall profile
        computed in bfloat16 and `recall_short` of an exact scan of the
        reference's plan from a miscalibrated radius predictor."""
        out = super().numbers(precision)
        if precision == "f32":
            depth = self.prog_depth
            recall = reference.recall(self.ans_ids, self.truth, self.k)
        else:
            depth = self._sampled_depths([aps.plan(q, self.cents, self.state, self.target,
                                                   precision="bf16") for q in self.q])
            recall = self._miscalibrated_recall()
        out["plan_gap"] = float((depth != self.ref_depth).double().mean())
        out["recall_short"] = self.target - recall
        return out

    def _miscalibrated_recall(self) -> float:
        """The sampled rows' recall@k of an exact scan of the reference's
        plan with the predicted radius scaled by MISCALIBRATION."""
        state = dataclasses.replace(self.state, radius_a=self.state.radius_a * MISCALIBRATION,
                                    radius_b=self.state.radius_b * MISCALIBRATION)
        plans = [aps.plan(q, self.cents, state, self.target) for q in self.q]
        pids = torch.cat([plans[b][0][torch.from_numpy(r).to(plans[b][0].device)]
                          for b, r, _, _ in self.samples]).to(self.device)
        s, act = self.store, torch.nonzero(self.store["active"])[:, 0]
        slots = reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)
        live = torch.full((s["ids"].shape[0],), -1, dtype=torch.int64, device=self.device)
        live[act] = torch.arange(act.numel(), device=self.device)
        owner = torch.full((self.x.shape[0],), -1, dtype=torch.int64, device=self.device)
        part = torch.nonzero(slots)[:, 0]
        owner[s["ids"][slots].to(torch.int64)] = live[part]
        return aps.plan_recall(owner[self.truth], pids, self._sampled_depths(plans))

    def work(self) -> None:
        """The roofline bound of the traced calls, from the reference's plan
        of each batch and the partitions' sizes."""
        if not self.traced_batches:
            return
        s = self.store
        sizes = (reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)).sum(dim=1)
        sizes = sizes[s["active"]]
        bound = {}
        for b in set(self.traced_batches):
            pids, depth, _ = self.plans[b]
            flops, nbytes = aps.search_work(pids, depth, sizes, int(self.cfg["d"]), self.k,
                                            self.codes)
            bound[b] = roofline.bound_seconds(flops, nbytes, self.codes)
        self.readings.bound_s = sum(bound[b] for b in self.traced_batches)
