"""Pure-NumPy IVF-Flat baseline wrapper — an always-executable competitor.

The reference validates Quake against an actually-running Faiss-IVF baseline
(src/python/index_wrappers/faiss_ivf.py:96-160, test_basic.py:1-51). Where
faiss cannot be installed, this wrapper provides an
independent CPU IVF implementation with the same observable behavior
(k-means build, fixed-nprobe search, dynamic add/remove, save/load) so the
regression harness can compare two *methods* end to end. It shares no code
with the index's engine: dict-of-arrays inverted lists, NumPy Lloyd
iterations, argpartition top-k.

A copy of quake_tpu/wrappers/numpy_ivf.py, on this package's timing and utils.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper


def _pairwise_scores(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """Higher-better scores [nq, n]."""
    prod = q @ x.T
    if metric == "ip":
        return prod
    return 2.0 * prod - (q * q).sum(1)[:, None] - (x * x).sum(1)[None, :]


class NumpyIVF(IndexWrapper):
    """IVF-Flat over NumPy: centroids + per-partition (vectors, ids)."""

    def __init__(self):
        self.metric = "l2"
        self._centroids: Optional[np.ndarray] = None
        self.lists: list[tuple[np.ndarray, np.ndarray]] = []

    # -- build ----------------------------------------------------------
    def build(self, vectors, nc: int = 0, metric: str = "l2",
              ids: Optional[np.ndarray] = None, niter: int = 5, **kwargs):
        vectors = to_f32(vectors)
        n, d = vectors.shape
        ids = to_i64(ids) if ids is not None else np.arange(n, dtype=np.int64)
        self.metric = metric
        nc = max(int(nc), 1)
        rng = np.random.default_rng(0)
        cents = vectors[rng.choice(n, size=min(nc, n), replace=False)].copy()
        if len(cents) < nc:
            cents = np.concatenate(
                [cents, rng.standard_normal((nc - len(cents), d), dtype=np.float32)]
            )
        if metric == "ip":
            cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
        # Lloyd iterations on a subsample (256 pts/centroid, like Faiss).
        train = vectors
        cap = 256 * nc
        if n > cap:
            train = vectors[rng.choice(n, size=cap, replace=False)]
        for _ in range(niter):
            a = self._assign(train, cents)
            for c in range(nc):
                pts = train[a == c]
                if len(pts):
                    cents[c] = pts.mean(0)
            if metric == "ip":
                cents /= np.maximum(
                    np.linalg.norm(cents, axis=1, keepdims=True), 1e-12)
        self._centroids = cents
        assign = self._assign(vectors, cents)
        self.lists = []
        for c in range(nc):
            m = assign == c
            self.lists.append((vectors[m].copy(), ids[m].copy()))

    def _assign(self, x: np.ndarray, cents: np.ndarray) -> np.ndarray:
        out = np.empty(len(x), np.int64)
        for s in range(0, len(x), 65536):
            out[s:s + 65536] = _pairwise_scores(
                x[s:s + 65536], cents, self.metric).argmax(1)
        return out

    # -- search ---------------------------------------------------------
    def search(self, query, k: int = 1, nprobe: int = 1, **kwargs) -> SearchResult:
        query = to_f32(query)
        nq = len(query)
        nc = len(self.lists)
        nprobe = min(max(int(nprobe), 1), nc)
        cs = _pairwise_scores(query, self._centroids, self.metric)
        probe = np.argpartition(-cs, min(nprobe, nc - 1), axis=1)[:, :nprobe]
        out_ids = np.full((nq, k), -1, np.int64)
        out_d = np.full((nq, k), np.inf if self.metric == "l2" else -np.inf,
                        np.float32)
        for qi in range(nq):
            vs, vi = [], []
            for c in probe[qi]:
                v, i = self.lists[c]
                if len(i):
                    vs.append(v)
                    vi.append(i)
            if not vs:
                continue
            cand_v = np.concatenate(vs)
            cand_i = np.concatenate(vi)
            s = _pairwise_scores(query[qi:qi + 1], cand_v, self.metric)[0]
            kk = min(k, len(s))
            top = np.argpartition(-s, kk - 1)[:kk]
            top = top[np.argsort(-s[top])]
            out_ids[qi, :kk] = cand_i[top]
            if self.metric == "l2":
                out_d[qi, :kk] = np.sqrt(np.maximum(-s[top], 0.0))
            else:
                out_d[qi, :kk] = s[top]
        return SearchResult(ids=out_ids, distances=out_d,
                            timing_info=SearchTimingInfo(n_queries=nq))

    # -- mutation -------------------------------------------------------
    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            start = max((int(i.max()) for _, i in self.lists if len(i)),
                        default=-1) + 1
            ids = np.arange(start, start + len(vectors), dtype=np.int64)
        ids = to_i64(ids)
        assign = self._assign(vectors, self._centroids)
        for c in np.unique(assign):
            m = assign == c
            v, i = self.lists[c]
            self.lists[c] = (np.concatenate([v, vectors[m]]),
                             np.concatenate([i, ids[m]]))

    def remove(self, ids):
        ids = to_i64(ids)
        for c, (v, i) in enumerate(self.lists):
            m = ~np.isin(i, ids)
            if not m.all():
                self.lists[c] = (v[m], i[m])

    # -- persistence ----------------------------------------------------
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "centroids.npy"), self._centroids)
        np.savez(
            os.path.join(directory, "lists.npz"),
            **{f"v{c}": v for c, (v, _) in enumerate(self.lists)},
            **{f"i{c}": i for c, (_, i) in enumerate(self.lists)},
        )
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump({"metric": self.metric, "nc": len(self.lists)}, f)

    def load(self, directory: str, **kwargs):
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        self.metric = meta["metric"]
        self._centroids = np.load(os.path.join(directory, "centroids.npy"))
        z = np.load(os.path.join(directory, "lists.npz"))
        self.lists = [(z[f"v{c}"], z[f"i{c}"]) for c in range(meta["nc"])]

    # -- introspection --------------------------------------------------
    def centroids(self):
        return self._centroids

    def n_total(self) -> int:
        return sum(len(i) for _, i in self.lists)

    def maintenance(self):
        return None

    def d(self) -> int:
        return 0 if self._centroids is None else self._centroids.shape[1]

    def index_state(self) -> dict:
        return {"n_list": len(self.lists), "n_total": self.n_total()}
