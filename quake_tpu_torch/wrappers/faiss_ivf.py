"""Faiss IVF baseline wrapper (mirrors src/python/index_wrappers/faiss_ivf.py).

Covers the reference's full variant matrix (faiss_ivf.py:96-160): Flat, PQ,
IVF-Flat, and IVFPQ — PQ variants are wrapped in IndexRefineFlat with a
search-time re-ranking factor `rf` (k_factor), exactly as the reference does.

Optional: requires `faiss` (not a dependency of this package); importing this
module without faiss raises a clear error at wrapper construction.

A copy of quake_tpu/wrappers/faiss_ivf.py, on this package's timing and utils.
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
except Exception:  # pragma: no cover - environment-dependent
    faiss = None
    _HAVE_FAISS = False


class FaissIVF(IndexWrapper):
    def __init__(self):
        if not _HAVE_FAISS:
            raise ImportError(
                "faiss is not installed; the FaissIVF baseline wrapper is unavailable"
            )
        self.index = None
        self.metric = "l2"
        self.index_type = "flat"  # flat | pq | ivf | ivfpq

    def _metric_type(self, metric: str):
        return faiss.METRIC_L2 if metric == "l2" else faiss.METRIC_INNER_PRODUCT

    def build(self, vectors, nc: int = 0, metric: str = "l2",
              ids: Optional[np.ndarray] = None, m: int = 0, b: int = 0,
              **kwargs):
        """Build one of {flat, pq, ivf, ivfpq} (reference faiss_ivf.py:98-170):
        nc selects flat-vs-IVF; (m, b) — PQ subquantizers and bits per code —
        must be both zero or both nonzero and select the PQ refinement."""
        if (m == 0) ^ (b == 0):
            raise ValueError("PQ params m and b must both be zero or both nonzero")
        vectors = to_f32(vectors)
        d = vectors.shape[1]
        self.metric = metric
        mt = self._metric_type(metric)
        if nc <= 1:
            if m == 0:
                base = faiss.IndexFlat(d, mt)
                self.index_type = "flat"
            else:
                base = faiss.IndexRefineFlat(faiss.IndexPQ(d, int(m), int(b)))
                self.index_type = "pq"
        else:
            quantizer = faiss.IndexFlat(d, mt)
            if m == 0:
                base = faiss.IndexIVFFlat(quantizer, d, int(nc), mt)
                self.index_type = "ivf"
            else:
                base = faiss.IndexRefineFlat(
                    faiss.IndexIVFPQ(quantizer, d, int(nc), int(m), int(b))
                )
                self.index_type = "ivfpq"
        if not base.is_trained:
            base.train(vectors)
        self.index = faiss.IndexIDMap2(base)
        if ids is None:
            ids = np.arange(len(vectors), dtype=np.int64)
        self.index.add_with_ids(vectors, to_i64(ids))

    def search(self, query, k: int = 1, nprobe: int = 1, rf: int = 1,
               **kwargs) -> SearchResult:
        query = to_f32(query)
        base = faiss.downcast_index(self.index.index)
        # Set nprobe on any embedded IVF (reference faiss_ivf.py:213-217).
        try:
            faiss.extract_index_ivf(base).nprobe = int(nprobe)
        except RuntimeError:
            pass
        # Re-ranking factor for PQ refinement (reference faiss_ivf.py:220-223).
        if isinstance(base, faiss.IndexRefineFlat):
            base.k_factor = max(int(rf), 1)
        dists, ids = self.index.search(query, int(k))
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0))
        return SearchResult(ids=ids, distances=dists, timing_info=SearchTimingInfo())

    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            ids = np.arange(self.n_total(), self.n_total() + len(vectors), dtype=np.int64)
        self.index.add_with_ids(vectors, to_i64(ids))

    def remove(self, ids):
        self.index.remove_ids(to_i64(ids))

    def save(self, directory: str):
        faiss.write_index(self.index, str(directory))

    def load(self, directory: str, **kwargs):
        self.index = faiss.read_index(str(directory))

    def _ivf(self):
        base = faiss.downcast_index(self.index.index)
        try:
            return faiss.extract_index_ivf(base)
        except RuntimeError:
            return None

    def centroids(self):
        ivf = self._ivf()
        if ivf is not None:
            return ivf.quantizer.reconstruct_n(0, ivf.nlist)
        return None

    def n_total(self) -> int:
        return self.index.ntotal if self.index else 0

    def maintenance(self):
        return None

    def d(self) -> int:
        return self.index.d if self.index else 0

    def index_state(self) -> dict:
        ivf = self._ivf()
        return {
            "n_list": ivf.nlist if ivf is not None else 1,
            "n_total": self.n_total(),
            "index_type": self.index_type,
        }
