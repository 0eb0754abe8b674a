"""QuakeWrapper: this package's QuakeIndex behind the uniform wrapper API.

The counterpart of quake_tpu/wrappers/quake.py, mirroring reference
src/python/index_wrappers/quake.py:10-213: search kwargs map onto
SearchParams (:108-140), centroids come from the parent level (:188-195).
`device` is where the index lives: None means the CUDA card (QuakeIndex
raises where there is none), "cpu" runs the kernels' plain versions. On the
card, add, remove and maintenance return once the device has finished their
work, so that a caller's host clock (the workload evaluator's) times it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quake_tpu_torch import IndexBuildParams, QuakeIndex, SearchParams
from quake_tpu_torch.index import resolve_device
from quake_tpu_torch.timing import SearchResult
from quake_tpu_torch.utils import to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper


class QuakeWrapper(IndexWrapper):
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.index: Optional[QuakeIndex] = None

    def build(
        self,
        vectors: np.ndarray,
        nc: int = 0,
        metric: str = "l2",
        ids: Optional[np.ndarray] = None,
        num_workers: int = 0,
        m: int = -1,  # accepted for API parity (PQ unimplemented, as in reference)
        code_size: int = -1,
        niter: int = 5,
        num_shards: int = 0,
        spill: bool = False,  # SOAR spilled assignment
        soar_lambda: float = 1.0,
    ):
        vectors = to_f32(vectors)
        params = IndexBuildParams(
            nlist=int(nc),
            metric=metric,
            niter=niter,
            num_workers=num_workers,
            num_shards=num_shards,
            spill=spill,
            soar_lambda=soar_lambda,
        )
        self.index = QuakeIndex(device=self.device)
        return self.index.build(vectors, ids, params)

    def search(
        self,
        query: np.ndarray,
        k: int = 1,
        nprobe: int = 1,
        recall_target: float = -1.0,
        batched_scan: bool | None = None,  # None = auto (the batched path at B >= 16)
        use_precomputed: bool = True,
        # None = auto (calibration-validated candidate width); a float
        # reproduces the reference's fixed-fraction candidate cap.
        initial_search_fraction: float | None = None,
        recompute_threshold: float = 0.001,
        aps_flush_period_us: int = 100,
        n_threads: int = 1,
        **kwargs,
    ) -> SearchResult:
        sp = SearchParams(
            k=int(k),
            nprobe=int(nprobe),
            recall_target=float(recall_target),
            batched_scan=batched_scan,
            use_precomputed=use_precomputed,
            initial_search_fraction=(None if initial_search_fraction is None
                                     else float(initial_search_fraction)),
            recompute_threshold=float(recompute_threshold),
            aps_flush_period_us=int(aps_flush_period_us),
            num_threads=int(n_threads),
        )
        return self.index.search(query, sp)

    def add(self, vectors: np.ndarray, ids: Optional[np.ndarray] = None, num_threads: int = 0, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            start = int(self.index.get_ids().max(initial=-1)) + 1
            ids = np.arange(start, start + vectors.shape[0], dtype=np.int64)
        return self._finished(self.index.add(vectors, to_i64(ids)))

    def remove(self, ids: np.ndarray):
        return self._finished(self.index.remove(to_i64(ids)))

    def maintenance(self):
        return self._finished(self.index.maintenance())

    def _finished(self, out):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def save(self, directory: str):
        self.index.save(str(directory))

    def load(self, directory: str, n_workers: int = 0, **kwargs):
        self.index = QuakeIndex(device=self.device)
        self.index.load(str(directory), n_workers=n_workers)

    def centroids(self):
        if self.index.parent is None:
            return None
        return self.index.centroids()

    def n_total(self) -> int:
        return self.index.ntotal()

    def d(self) -> int:
        return self.index.d()

    @property
    def metric(self) -> str:
        return self.index.metric

    def index_state(self) -> dict:
        return {"n_list": self.index.nlist(), "n_total": self.index.ntotal()}
