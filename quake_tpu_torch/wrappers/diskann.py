"""DiskANN dynamic baseline wrapper (mirrors
src/python/index_wrappers/diskann.py). Optional: requires `diskannpy`.

A copy of quake_tpu/wrappers/diskann.py, on this package's timing and utils.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper

try:
    import diskannpy  # type: ignore

    _HAVE = True
except Exception:  # pragma: no cover
    diskannpy = None
    _HAVE = False


class DiskANNDynamic(IndexWrapper):
    """Dynamic in-memory DiskANN (Vamana graph with inserts/deletes)."""

    def __init__(self):
        if not _HAVE:
            raise ImportError(
                "diskannpy is not installed; the DiskANN baseline is unavailable"
            )
        self.index = None
        self.metric = "l2"
        self._d = 0

    def build(self, vectors, metric: str = "l2", ids: Optional[np.ndarray] = None,
              complexity: int = 64, graph_degree: int = 32, **kwargs):
        vectors = to_f32(vectors)
        self.metric = metric
        self._d = vectors.shape[1]
        self.index = diskannpy.DynamicMemoryIndex(
            distance_metric="l2" if metric == "l2" else "mips",
            vector_dtype=np.float32,
            dimensions=self._d,
            max_vectors=max(2 * len(vectors), 1024),
            complexity=complexity,
            graph_degree=graph_degree,
        )
        if ids is None:
            ids = np.arange(len(vectors), dtype=np.int64)
        # diskannpy requires ids > 0
        self.index.batch_insert(vectors, to_i64(ids).astype(np.uint32) + 1)

    def search(self, query, k: int = 1, complexity: int = 64, **kwargs) -> SearchResult:
        query = to_f32(query)
        ids, dists = self.index.batch_search(
            query, k_neighbors=int(k), complexity=max(int(complexity), int(k)),
            num_threads=0,
        )
        out_ids = ids.astype(np.int64) - 1
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0))
        return SearchResult(ids=out_ids, distances=dists, timing_info=SearchTimingInfo())

    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        self.index.batch_insert(vectors, to_i64(ids).astype(np.uint32) + 1)

    def remove(self, ids):
        for i in to_i64(ids).tolist():
            self.index.mark_deleted(int(i) + 1)

    def save(self, directory: str):
        self.index.save(str(directory))

    def load(self, directory: str, **kwargs):
        raise NotImplementedError("DiskANN dynamic reload not supported here")

    def centroids(self):
        return None

    def n_total(self) -> int:
        return 0 if self.index is None else self.index.size

    def maintenance(self):
        self.index.consolidate_delete()

    def d(self) -> int:
        return self._d

    def index_state(self) -> dict:
        return {"n_list": 1, "n_total": self.n_total()}
