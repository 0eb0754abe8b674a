"""Traffic kind `search_batches`: one closed-loop client sends batches of
queries to `QuakeIndex.search`, numpy in and numpy out, each as soon as the
last one has answered.

The batches are a pool of `pool_batches` distinct batches of `batch` queries
made from the seed, cycled. Of every call the benchmark keeps the answers of
`sample_rows_per_call` rows drawn from the seed, which the reference judges
after the window: the true distance of every returned id, the contract of
an answer, the selection against the exact nearest rows of the partitions
the query surely probes, and recall@k against the exact neighbours. The
store the build left is judged too: every vector once, as stored, with its
norm.
"""

from __future__ import annotations

import gc
import json
import time

import numpy as np
import torch

from benchmark import core, corpus, reference, roofline, tracing


def _ns_ms(timing, name):
    v = getattr(timing, name, None)
    return None if v is None else v * 1e-6


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.k = int(cfg["k"])
        self.codes = cfg["build"].get("precision", "f32")
        self.setup_phases: dict = {}
        self.notes: list = []  # lines for standard error
        self.readings = core.Readings()
        self.samples: list = []  # (pool batch, rows, ids, dists)
        self.traced_batches: list = []
        self.attempted = self.failed = 0
        self.elapsed = 0.0
        self.index = None

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

        cfg, tr = self.cfg, self.traffic
        t = time.perf_counter()
        self.manifold = corpus.Manifold.from_config(cfg["corpus"], int(cfg["d"]), self.device)
        x_np = self._corpus().cpu().numpy()
        self.q_np = [q.cpu().numpy() for q in self._queries()]
        t = core.end_phase(self.setup_phases, "data", t, self.device)

        self.index = QuakeIndex(device=self.device)
        self.index.build(x_np, None, IndexBuildParams(metric=cfg["metric"], **cfg["build"]))
        del x_np
        self.sp = SearchParams(k=self.k, **cfg["search"])
        t = core.end_phase(self.setup_phases, "build", t, self.device)

        for _ in range(int(tr["warmup_rounds"])):
            for q in self.q_np:
                self.index.search(q, self.sp)
        self.rng = np.random.default_rng([self.seed, 7])
        core.end_phase(self.setup_phases, "warm_up", t, self.device)

    def _corpus(self) -> torch.Tensor:
        return self.manifold.sample(int(self.cfg["n"]), corpus.generator(
            self.device, int(self.cfg["corpus"]["seed"]), 0))

    def _queries(self) -> list:
        B = int(self.traffic["batch"])
        return [self.manifold.sample(B, corpus.generator(self.device, self.seed, 1 + b))
                for b in range(int(self.traffic["pool_batches"]))]

    # ---------------------------------------------------------------- windows

    def _call(self, i: int) -> float:
        b = i % len(self.q_np)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.search"):
            res = self.index.search(self.q_np[b], self.sp)
        t1 = time.perf_counter()
        rows = self.rng.integers(0, self.q_np[b].shape[0], int(self.traffic["sample_rows_per_call"]))
        self.samples.append((b, rows, res.ids[rows].copy(), res.distances[rows].copy()))
        return t1 - t0, b, res.timing_info

    def window(self, seconds: float) -> None:
        """The measured window: calls until `seconds` have passed."""
        gc.collect()
        start = time.perf_counter()
        i = 0
        while True:
            dt, _, timing = self._call(i)
            i += 1
            self.readings.calls.append({
                "ms": dt * 1e3,
                "buffer_init_ms": _ns_ms(timing, "buffer_init_time_ns"),
                "enqueue_ms": _ns_ms(timing, "job_enqueue_time_ns"),
                "wait_ms": _ns_ms(timing, "job_wait_time_ns"),
                "aggregate_ms": _ns_ms(timing, "result_aggregate_time_ns")})
            if time.perf_counter() - start >= seconds:
                break
        self.elapsed = time.perf_counter() - start
        self.attempted = i
        means = {k: core.mean(c[k] for c in self.readings.calls) for k in
                 ("ms", "buffer_init_ms", "enqueue_ms", "wait_ms", "aggregate_ms")
                 if all(c[k] is not None for c in self.readings.calls)}
        self.notes.append("window host ms a call: " + json.dumps(means))

    def traced_window(self, seconds: float, logdir) -> None:
        """A second, traced window, for the device's per-layer metrics."""
        from quake_tpu_torch.profiling import TRACE_FILE, device_trace

        gc.collect()
        with device_trace(str(logdir)):
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                start = time.perf_counter()
                i = 0
                while time.perf_counter() - start < seconds:
                    _, b, _ = self._call(self.attempted + i)
                    self.traced_batches.append(b)
                    i += 1
                core.sync(self.device)
        self.readings.trace = tracing.read(logdir / TRACE_FILE)
        self.readings.traced_calls = i

    # ------------------------------------------------------------ judgement

    def collect(self) -> None:
        """Take the program's outputs, then free the program's state."""
        st = self.index.store.state
        self.store = {name: getattr(st, name) for name in
                      ("codes", "ids", "sizes", "norms", "centroids", "active")}
        self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        dev = self.device
        # The inputs again, made from the seed as in set-up: the window ran
        # without the benchmark's copies on the device.
        self.x = self._corpus()
        self.q = self._queries()
        self.Q = torch.cat([self.q[b][torch.from_numpy(r).to(dev)] for b, r, _, _ in self.samples])
        self.ans_ids = torch.from_numpy(np.concatenate([s[2] for s in self.samples])).to(dev)
        self.ans_d = torch.from_numpy(np.concatenate([s[3] for s in self.samples])).to(dev)
        self.stored = reference.round_to(self.x, self.codes)
        self.alive = torch.ones(self.x.shape[0], dtype=torch.bool, device=dev)
        self._probed()

    def _probed(self) -> None:
        """The reference's selection of every sampled row over the rows it
        surely scans and the scan's fold surely keeps, and each row's key
        scale. The partitions are the
        build's (its centroids and which rows it put where): k-means is not
        rebuilt bit for bit, so this follows the program from its own
        state; store_err and norm_err check that state by themselves."""
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
        self.probes, self.certain = reference.certain_probes(
            self.Q, s["centroids"][act], int(self.cfg["search"]["nprobe"]))
        tol = reference.fold_tol(self.Q, self.stored, self.step, self.codes)
        self.best_ids, self.best_d2 = reference.probed_topk(
            self.Q, self.stored, self.part_ids, self.probes, self.certain, self.k, tol=tol)

    def numbers(self, precision: str = "f32") -> dict:
        """The numbers compared with the cell's limits: of the program's
        outputs, or with a lower `precision` of the control (the reference
        in the program's place)."""
        dtype = reference.CODE_DTYPES[self.codes]
        s = self.store
        if precision == "f32":
            ids, d = self.ans_ids, self.ans_d
            store_err = reference.store_violations(s["codes"], s["ids"], s["sizes"], self.x,
                                                   self.alive, dtype)
        else:
            ids, d = reference.exact_knn(self.Q, self.stored, self.k, precision=precision)
            store_err = int((reference.round_to(self.stored, precision) != self.stored)
                            .any(dim=1).sum())
        return {
            **self._distances(ids, d),
            "sel_budget": self._selection(ids),
            "norm_err": reference.norm_err(s["norms"], s["ids"], s["sizes"], self.x, dtype,
                                           precision),
            "invalid": reference.invalid_answers(ids, d, self.alive, self.k),
            "store_err": store_err,
        }

    def keyed_numbers(self, precision: str) -> dict:
        """`sel_budget` of the reference put in the scan's place with the
        configuration's key selection, its products in `precision`."""
        rank = reference.keyed_rank(self.floor, self.step, precision, self.slot_mult)
        ids, _ = reference.probed_topk(self.Q, self.stored, self.part_ids, self.probes,
                                       self.certain, self.k, rank=rank)
        return {"sel_budget": self._selection(ids)}

    def _selection(self, ids) -> float:
        """The answers' selection against the reference's (reference.
        sel_budget), on each call's key scale."""
        return reference.sel_budget(self.Q, self.stored, ids, self.best_ids, self.best_d2,
                                    self.step[:, None], self.codes)

    def _distances(self, ids, d) -> dict:
        """The returned distances against the true ones: as a share of
        |q|^2 + |x|^2 where the configuration serves exact distances
        (`dist_err`); where it serves distances dequantized from the scan's
        keys, as a share of what that allows (`dist_budget`, reference.
        dist_budget: half a key step plus the query's rounding to the codes'
        dtype), with each call's key step from its batch."""
        if self.cfg["search"]["exact_distances"]:
            return {"dist_err": reference.dist_err(self.Q, self.stored, ids, d)}
        return {"dist_budget": reference.dist_budget(self.Q, self.stored, ids, d,
                                                     self.step[:, None], self.codes)}

    def end_to_end(self) -> dict:
        truth, _ = reference.exact_knn(self.Q, self.x, self.k)
        B = int(self.traffic["batch"])
        return {
            "qps": self.attempted * B / self.elapsed,
            "search_ms_p95": core.percentile([c["ms"] for c in self.readings.calls], 95),
            "recall_at_10": reference.recall(self.ans_ids, truth, self.k),
        }

    def work(self) -> None:
        """The roofline bound of the traced calls, from the reference's
        probe lists and the partitions' sizes."""
        if not self.traced_batches:
            return
        s = self.store
        act = s["active"]
        sizes = (reference.valid_slots(s["ids"], s["sizes"]) & (s["ids"] >= 0)).sum(dim=1)[act]
        cents = s["centroids"][act]
        bound = {}
        for b in set(self.traced_batches):
            probes, _ = reference.certain_probes(self.q[b], cents, int(self.cfg["search"]["nprobe"]))
            flops, nbytes = roofline.search_work(probes, sizes, int(self.cfg["d"]), self.k,
                                                 self.codes)
            bound[b] = roofline.bound_seconds(flops, nbytes, self.codes)
        self.readings.bound_s = sum(bound[b] for b in self.traced_batches)
