"""Traffic kind `churn`: one closed-loop client runs a live index through
inserts, deletes and queries, with `QuakeIndex.maintenance()` after every
op (the op mix of Quake's sift1m_balanced regression workload).

The ops come in blocks of `block`, each holding the mix's share of every op
type in an order drawn from the seed, so every seed does the same work. An
insert adds `update_batch` fresh vectors of the corpus's distribution under
new ids; a delete removes `update_batch` ids drawn uniformly from the
resident ones; a query searches `query_batch` fresh queries. Writes end in a
synchronisation of the device: an acknowledged write is done.

After the window the reference replays the op log: every query's answers
against the vectors resident when it ran (their true distances, the
answer's contract, recall@k), the final store against the resident set (every
acknowledged insert present, every delete gone, each vector as stored with
its norm), and every inserted vector's partition against its nearest
centroid among the partitions the window left as they were.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import core, corpus, reference, tracing

INSERT, DELETE, QUERY = 0, 1, 2
OP_NAMES = ("insert", "delete", "query")
WARM_ID0 = 1 << 30  # ids of the warm-up's inserts, removed again
GROW_ID0 = 1 << 29  # ids of the set-up's fill of the fullest partition, removed again


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.k = int(cfg["k"])
        self.codes = cfg["build"].get("precision", "f32")
        self.setup_phases: dict = {}
        self.notes: list = []  # lines for standard error
        self.readings = core.Readings()
        self.attempted = self.failed = 0
        self.elapsed = 0.0
        self.index = None
        self.oplog: list = []  # (op, payload...) in order, window and traced window
        self.inserted: list = []  # host copies of the inserted vectors, in id order

    def _corpus(self) -> torch.Tensor:
        return self.manifold.sample(int(self.cfg["n"]), corpus.generator(
            self.device, int(self.cfg["corpus"]["seed"]), 0))

    def _fresh(self, t: int, n: int) -> np.ndarray:
        """Op t's vectors (inserted or queried), from the seed."""
        return self.manifold.sample(n, corpus.generator(self.device, self.seed, 1000 + t)) \
            .cpu().numpy()

    # ---------------------------------------------------------------- set-up

    def setup(self) -> None:
        from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams

        cfg, tr = self.cfg, self.traffic
        t = time.perf_counter()
        self.manifold = corpus.Manifold.from_config(cfg["corpus"], int(cfg["d"]), self.device)
        x_np = self._corpus().cpu().numpy()
        n = x_np.shape[0]
        t = core.end_phase(self.setup_phases, "data", t, self.device)

        self.index = QuakeIndex(device=self.device)
        self.index.build(x_np, None, IndexBuildParams(metric=cfg["metric"], **cfg["build"]))
        del x_np
        self.sp = SearchParams(k=self.k, **cfg["search"])
        t = core.end_phase(self.setup_phases, "build", t, self.device)
        self._grow()
        t = core.end_phase(self.setup_phases, "grow", t, self.device)

        ub, qb = int(tr["update_batch"]), int(tr["query_batch"])
        for r in range(int(tr["warmup_rounds"])):
            ids = WARM_ID0 + r * ub + np.arange(ub, dtype=np.int64)
            self.index.add(self._fresh(-1 - r, ub), ids)
            core.sync(self.device)
            self.index.remove(ids)
            core.sync(self.device)
            self.index.search(self._fresh(-100 - r, qb), self.sp)
            self.index.maintenance()
            core.sync(self.device)
        core.end_phase(self.setup_phases, "warm_up", t, self.device)

        # The resident ids (a list with swap-removal) and the op plan's rng.
        self.res = np.arange(n, dtype=np.int64)
        self.n_res = n
        self.next_id = n
        self.n0 = n
        self.rng = np.random.default_rng([self.seed, 13])
        self.block: list = []
        st = self.index.store.state
        self.cent0 = st.centroids.clone()
        self.active0 = st.active.clone()

    def _grow(self) -> None:
        """The slabs' growth a live index meets, on every seed alike: under
        this mix the fullest partition overflows its slab within minutes of
        churn (within one window on some seeds), and the store doubles C for
        every partition. Set-up makes it happen once, the same on every
        seed: it fills the fullest partition one row past C with copies of
        its centroid, then removes them."""
        st = self.index.store.state
        C = int(st.ids.shape[1])
        sizes = st.sizes.to(torch.int64) * st.active.to(torch.int64)
        p = int(torch.argmax(sizes))
        n = C - int(sizes[p]) + 1
        ids = GROW_ID0 + np.arange(n, dtype=np.int64)
        x = st.centroids[p].to(torch.float32).cpu().numpy()[None, :].repeat(n, axis=0)
        self.index.add(x, ids)
        core.sync(self.device)
        self.index.remove(ids)
        core.sync(self.device)
        self.notes.append("store capacity C %d -> %d in set-up (partition %d, %d rows)" % (
            C, int(self.index.store.state.ids.shape[1]), p, int(sizes[p])))

    # ---------------------------------------------------------------- the ops

    def _next_op(self) -> int:
        if not self.block:
            tr = self.traffic
            size = int(tr["block"])
            counts = [round(size * float(tr["ratios"][name])) for name in OP_NAMES]
            plan = np.repeat(np.arange(3), counts)
            self.block = list(self.rng.permutation(plan)[::-1])
        return int(self.block.pop())

    def _delete_ids(self, m: int) -> np.ndarray:
        pos = np.sort(self.rng.choice(self.n_res, size=m, replace=False))
        ids = self.res[pos].copy()
        n_new = self.n_res - m
        holes = pos[pos < n_new]
        tail = np.arange(n_new, self.n_res)
        self.res[holes] = self.res[tail[~np.isin(tail, pos)]]
        self.n_res = n_new
        return ids

    def _insert_ids(self, m: int) -> np.ndarray:
        ids = self.next_id + np.arange(m, dtype=np.int64)
        self.next_id += m
        if self.n_res + m > self.res.shape[0]:
            self.res = np.concatenate([self.res, np.empty(max(m, self.res.shape[0]), np.int64)])
        self.res[self.n_res:self.n_res + m] = ids
        self.n_res += m
        return ids

    def _op(self, t: int) -> dict:
        tr = self.traffic
        op = self._next_op()
        rec = {"type": OP_NAMES[op]}
        if op == INSERT:
            x = self._fresh(t, int(tr["update_batch"]))
            ids = self._insert_ids(x.shape[0])
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.insert"):
                self.index.add(x, ids)
                core.sync(self.device)
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            self.inserted.append(x)
            self.oplog.append((INSERT, ids))
        elif op == DELETE:
            ids = self._delete_ids(int(tr["update_batch"]))
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.delete"):
                self.index.remove(ids)
                core.sync(self.device)
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            self.oplog.append((DELETE, ids))
        else:
            q = self._fresh(t, int(tr["query_batch"]))
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.query"):
                res = self.index.search(q, self.sp)
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            self.oplog.append((QUERY, q, res.ids, res.distances))
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.maintenance"):
            mt = self.index.maintenance()
            core.sync(self.device)
        rec["maint_ms"] = (time.perf_counter() - t0) * 1e3
        rec["splits"] = int(getattr(mt, "n_splits", 0))
        rec["deletes"] = int(getattr(mt, "n_deletes", 0))
        return rec

    def window(self, seconds: float) -> None:
        gc.collect()
        start = time.perf_counter()
        t = 0
        while True:
            self.readings.ops.append(self._op(t))
            t += 1
            if time.perf_counter() - start >= seconds:
                break
        self.elapsed = time.perf_counter() - start
        self.attempted = t

    def traced_window(self, seconds: float, logdir) -> None:
        from quake_tpu_torch.profiling import TRACE_FILE, device_trace

        gc.collect()
        t = self.attempted
        with device_trace(str(logdir)):
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                start = time.perf_counter()
                while time.perf_counter() - start < seconds:
                    self._op(t)
                    t += 1
                core.sync(self.device)
        self.readings.trace = tracing.read(logdir / TRACE_FILE)

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
        parts = [self._corpus()] + [torch.from_numpy(x).to(dev) for x in self.inserted]
        self.base = torch.cat(parts)  # row i = id i
        self.stored = reference.round_to(self.base, self.codes)
        self.alive = torch.zeros(self.base.shape[0], dtype=torch.bool, device=dev)
        self.alive[torch.from_numpy(self.res[:self.n_res]).to(dev)] = True
        # The partitions the window left as they were, and the inserted
        # vectors the store holds in them.
        s = self.store
        P0 = self.cent0.shape[0]
        same = torch.zeros(s["centroids"].shape[0], dtype=torch.bool, device=dev)
        same[:P0] = (self.active0 & s["active"][:P0]
                     & (self.cent0 == s["centroids"][:P0]).all(dim=1))
        self.same_rows = torch.nonzero(same)[:, 0]
        part, ids = reference.stored_rows(s["ids"], s["sizes"])
        keep = (ids >= self.n0) & (ids < self.base.shape[0]) & same[part]
        row_of = torch.full((s["centroids"].shape[0],), -1, dtype=torch.int64, device=dev)
        row_of[self.same_rows] = torch.arange(self.same_rows.shape[0], device=dev)
        self.ins_x = self.base[ids[keep]]
        self.ins_row = row_of[part[keep]]

    def _queries(self, precision: str):
        """(queries, ids, dists, truth, invalid) over every query op, each
        judged against the vectors resident when it ran; with a lower
        precision the control's answers take the program's place."""
        dev = self.device
        alive = torch.zeros_like(self.alive)
        alive[:self.n0] = True
        Qs, I, D, T = [], [], [], []
        invalid = 0
        for entry in self.oplog:
            if entry[0] == INSERT:
                alive[torch.from_numpy(entry[1]).to(dev)] = True
            elif entry[0] == DELETE:
                alive[torch.from_numpy(entry[1]).to(dev)] = False
            else:
                q = torch.from_numpy(entry[1]).to(dev)
                if precision == "f32":
                    ids = torch.from_numpy(entry[2]).to(dev)
                    d = torch.from_numpy(entry[3]).to(dev)
                    truth, _ = reference.exact_knn(q, self.base, self.k, valid=alive)
                    T.append(truth)
                else:
                    ids, d = reference.exact_knn(q, self.stored, self.k, valid=alive,
                                                 precision=precision)
                invalid += reference.invalid_answers(ids, d, alive, self.k)
                Qs.append(q)
                I.append(ids)
                D.append(d)
        cat = (lambda v: torch.cat(v) if v else None)
        return cat(Qs), cat(I), cat(D), cat(T), invalid

    def numbers(self, precision: str = "f32") -> dict:
        dtype = reference.CODE_DTYPES[self.codes]
        s = self.store
        Q, ids, d, truth, invalid = self._queries(precision)
        self._truth, self._ans = truth, ids
        cents = s["centroids"][self.same_rows]
        if precision == "f32":
            store_err = reference.store_violations(s["codes"], s["ids"], s["sizes"], self.base,
                                                   self.alive, dtype)
            rows = self.ins_row
        else:
            store_err = int((reference.round_to(self.stored, precision) != self.stored)
                            .any(dim=1).sum())
            rows = reference.nearest_centroid(self.ins_x, cents, precision)
        return {
            "dist_err": reference.dist_err(Q, self.stored, ids, d) if Q is not None else 0.0,
            "norm_err": reference.norm_err(s["norms"], s["ids"], s["sizes"], self.base, dtype,
                                           precision),
            "assign_gap": reference.assign_gap(self.ins_x, rows, cents),
            "invalid": invalid,
            "store_err": store_err,
        }

    def end_to_end(self) -> dict:
        if self._truth is None:
            raise RuntimeError("the window ran no query op")
        return {
            "churn_ops_per_s": self.attempted / self.elapsed,
            "recall_at_10": reference.recall(self._ans, self._truth, self.k),
        }
