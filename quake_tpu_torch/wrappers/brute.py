"""Exact brute-force baseline wrapper (always available; the oracle baseline
for the regression harness, playing the role the reference's Faiss-Flat
baseline plays in its comparisons).

A copy of quake_tpu/wrappers/brute.py, on this package's timing and utils.
"""

from __future__ import annotations

from typing import Optional

import json
import os

import numpy as np

from quake_tpu_torch.timing import SearchResult, SearchTimingInfo
from quake_tpu_torch.utils import knn, to_f32, to_i64
from quake_tpu_torch.wrappers.wrapper import IndexWrapper


class BruteForceWrapper(IndexWrapper):
    def __init__(self):
        self.vectors = None
        self.ids = None
        self.metric = "l2"

    def build(self, vectors, metric: str = "l2", ids: Optional[np.ndarray] = None, **kwargs):
        self.vectors = to_f32(vectors)
        self.metric = metric
        self.ids = (
            to_i64(ids) if ids is not None else np.arange(len(self.vectors), dtype=np.int64)
        )

    def search(self, query, k: int = 1, **kwargs) -> SearchResult:
        ids, dists = knn(query, self.vectors, k, self.metric, ids=self.ids)
        return SearchResult(ids=ids, distances=dists, timing_info=SearchTimingInfo())

    def add(self, vectors, ids=None, **kwargs):
        vectors = to_f32(vectors)
        if ids is None:
            start = int(self.ids.max(initial=-1)) + 1
            ids = np.arange(start, start + len(vectors), dtype=np.int64)
        self.vectors = np.concatenate([self.vectors, vectors])
        self.ids = np.concatenate([self.ids, to_i64(ids)])

    def remove(self, ids):
        mask = ~np.isin(self.ids, to_i64(ids))
        self.vectors = self.vectors[mask]
        self.ids = self.ids[mask]

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "vectors.npy"), self.vectors)
        np.save(os.path.join(directory, "ids.npy"), self.ids)
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump({"metric": self.metric}, f)

    def load(self, directory: str, **kwargs):
        self.vectors = np.load(os.path.join(directory, "vectors.npy"))
        self.ids = np.load(os.path.join(directory, "ids.npy"))
        with open(os.path.join(directory, "meta.json")) as f:
            self.metric = json.load(f)["metric"]

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
