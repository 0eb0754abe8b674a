"""Faiss HNSW baseline wrapper (mirrors src/python/index_wrappers/faiss_hnsw.py).
Optional: requires `faiss`.

A copy of quake_tpu/wrappers/faiss_hnsw.py, on this package's timing and utils.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper

try:
    import faiss  # type: ignore

    _HAVE_FAISS = True
except Exception:  # pragma: no cover
    faiss = None
    _HAVE_FAISS = False


class FaissHNSW(IndexWrapper):
    def __init__(self):
        if not _HAVE_FAISS:
            raise ImportError(
                "faiss is not installed; the FaissHNSW baseline wrapper is unavailable"
            )
        self.index = None
        self.metric = "l2"

    def build(self, vectors, metric: str = "l2", ids: Optional[np.ndarray] = None,
              m: int = 32, ef_construction: int = 40, **kwargs):
        vectors = to_f32(vectors)
        d = vectors.shape[1]
        self.metric = metric
        mt = faiss.METRIC_L2 if metric == "l2" else faiss.METRIC_INNER_PRODUCT
        base = faiss.IndexHNSWFlat(d, int(m), mt)
        base.hnsw.efConstruction = int(ef_construction)
        self.index = faiss.IndexIDMap2(base)
        if ids is None:
            ids = np.arange(len(vectors), dtype=np.int64)
        self.index.add_with_ids(vectors, to_i64(ids))

    def search(self, query, k: int = 1, ef_search: int = 16, **kwargs) -> SearchResult:
        base = faiss.downcast_index(self.index.index)
        base.hnsw.efSearch = int(ef_search)
        dists, ids = self.index.search(to_f32(query), int(k))
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0))
        return SearchResult(ids=ids, distances=dists, timing_info=SearchTimingInfo())

    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            ids = np.arange(self.n_total(), self.n_total() + len(vectors), dtype=np.int64)
        self.index.add_with_ids(vectors, to_i64(ids))

    def remove(self, ids):
        raise NotImplementedError("HNSW does not support removal (reference parity)")

    def save(self, directory: str):
        faiss.write_index(self.index, str(directory))

    def load(self, directory: str, **kwargs):
        self.index = faiss.read_index(str(directory))

    def centroids(self):
        return None

    def n_total(self) -> int:
        return self.index.ntotal if self.index else 0

    def maintenance(self):
        return None

    def d(self) -> int:
        return self.index.d if self.index else 0

    def index_state(self) -> dict:
        return {"n_list": 1, "n_total": self.n_total()}
