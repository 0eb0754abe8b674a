"""SVS DynamicVamana baseline wrapper (mirrors
src/python/index_wrappers/vamana.py). Optional: requires `svs`.

A copy of quake_tpu/wrappers/vamana.py, on this package's timing and utils.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper

try:
    import svs  # type: ignore

    _HAVE = True
except Exception:  # pragma: no cover
    svs = None
    _HAVE = False


class SVSVamana(IndexWrapper):
    def __init__(self):
        if not _HAVE:
            raise ImportError("svs is not installed; the SVS-Vamana baseline is unavailable")
        self.index = None
        self.metric = "l2"
        self._d = 0

    def build(self, vectors, metric: str = "l2", ids: Optional[np.ndarray] = None,
              graph_max_degree: int = 64, alpha: float = 1.2, **kwargs):
        vectors = to_f32(vectors)
        self.metric = metric
        self._d = vectors.shape[1]
        if ids is None:
            ids = np.arange(len(vectors), dtype=np.int64)
        params = svs.VamanaBuildParameters(
            graph_max_degree=graph_max_degree, alpha=alpha
        )
        dist = svs.DistanceType.L2 if metric == "l2" else svs.DistanceType.MIP
        self.index = svs.DynamicVamana.build(
            params, vectors, to_i64(ids).astype(np.uint64), dist
        )

    def search(self, query, k: int = 1, search_window_size: int = 32, **kwargs) -> SearchResult:
        self.index.search_window_size = max(int(search_window_size), int(k))
        idx, dists = self.index.search(to_f32(query), int(k))
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0))
        return SearchResult(
            ids=idx.astype(np.int64), distances=dists, timing_info=SearchTimingInfo()
        )

    def add(self, vectors, ids=None, **kwargs):
        self.index.add(to_f32(vectors), to_i64(ids).astype(np.uint64))

    def remove(self, ids):
        self.index.delete(to_i64(ids).astype(np.uint64))

    def save(self, directory: str):
        self.index.save(str(directory) + "/config", str(directory) + "/graph",
                        str(directory) + "/data")

    def load(self, directory: str, **kwargs):
        raise NotImplementedError("SVS dynamic reload not wired")

    def centroids(self):
        return None

    def n_total(self) -> int:
        return 0 if self.index is None else self.index.size

    def maintenance(self):
        if self.index is not None:
            self.index.consolidate()
            self.index.compact()

    def d(self) -> int:
        return self._d

    def index_state(self) -> dict:
        return {"n_list": 1, "n_total": self.n_total()}
