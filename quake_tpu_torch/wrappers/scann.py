"""ScaNN baseline wrapper (mirrors src/python/index_wrappers/scann.py).
Optional: requires `scann` (not bundled). Static index: add/remove rebuild.

A copy of quake_tpu/wrappers/scann.py, on this package's timing and utils.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper

try:
    import scann  # type: ignore

    _HAVE = True
except Exception:  # pragma: no cover
    scann = None
    _HAVE = False


class ScaNNWrapper(IndexWrapper):
    def __init__(self):
        if not _HAVE:
            raise ImportError("scann is not installed; the ScaNN baseline is unavailable")
        self.searcher = None
        self.vectors = None
        self.ids = None
        self.metric = "l2"

    def _rebuild(self, num_leaves: int = 1000, leaves_to_search: int = 100):
        measure = "squared_l2" if self.metric == "l2" else "dot_product"
        n = len(self.vectors)
        builder = scann.scann_ops_pybind.builder(
            self.vectors, 10, measure
        ).tree(
            num_leaves=min(num_leaves, max(n // 10, 1)),
            num_leaves_to_search=leaves_to_search,
            training_sample_size=min(n, 250_000),
        ).score_ah(2, anisotropic_quantization_threshold=0.2).reorder(100)
        self.searcher = builder.build()

    def build(self, vectors, metric: str = "l2", ids: Optional[np.ndarray] = None, **kwargs):
        self.vectors = to_f32(vectors)
        self.metric = metric
        self.ids = to_i64(ids) if ids is not None else np.arange(len(self.vectors), dtype=np.int64)
        self._rebuild(**{k: v for k, v in kwargs.items() if k in ("num_leaves", "leaves_to_search")})

    def search(self, query, k: int = 1, **kwargs) -> SearchResult:
        idx, dists = self.searcher.search_batched(to_f32(query), final_num_neighbors=int(k))
        out_ids = self.ids[idx.astype(np.int64)]
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0))
        return SearchResult(ids=out_ids, distances=dists, timing_info=SearchTimingInfo())

    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            ids = np.arange(self.n_total(), self.n_total() + len(vectors), dtype=np.int64)
        self.vectors = np.concatenate([self.vectors, vectors])
        self.ids = np.concatenate([self.ids, to_i64(ids)])
        self._rebuild()

    def remove(self, ids):
        mask = ~np.isin(self.ids, to_i64(ids))
        self.vectors = self.vectors[mask]
        self.ids = self.ids[mask]
        self._rebuild()

    def save(self, directory: str):
        self.searcher.serialize(str(directory))

    def load(self, directory: str, **kwargs):
        self.searcher = scann.scann_ops_pybind.load_searcher(str(directory))

    def centroids(self):
        return None

    def n_total(self) -> int:
        return 0 if self.ids is None else len(self.ids)

    def maintenance(self):
        return None

    def d(self) -> int:
        return 0 if self.vectors is None else self.vectors.shape[1]

    def index_state(self) -> dict:
        return {"n_list": 1, "n_total": self.n_total()}
