"""Uniform index-wrapper interface + name registry.

A copy of quake_tpu/wrappers/wrapper.py. Mirrors the reference IndexWrapper ABC
(src/python/index_wrappers/wrapper.py:8-80) with numpy arrays in place of
torch tensors. Baseline wrappers (Faiss et al.) import lazily so missing
optional dependencies only fail when that baseline is requested.
"""

from __future__ import annotations

import abc
from typing import Optional, Union

import numpy as np


def get_index_class(index_name: str):
    """Name registry (wrapper.py:8-20)."""
    if index_name in ("Quake", "QuakeTPU"):
        from quake_tpu_torch.wrappers.quake import QuakeWrapper as IndexClass
    elif index_name == "IVF":
        from quake_tpu_torch.wrappers.faiss_ivf import FaissIVF as IndexClass
    elif index_name == "HNSW":
        from quake_tpu_torch.wrappers.faiss_hnsw import FaissHNSW as IndexClass
    elif index_name == "BruteForce":
        from quake_tpu_torch.wrappers.brute import BruteForceWrapper as IndexClass
    elif index_name == "NumpyIVF":
        from quake_tpu_torch.wrappers.numpy_ivf import NumpyIVF as IndexClass
    elif index_name == "DiskANN":
        from quake_tpu_torch.wrappers.diskann import DiskANNDynamic as IndexClass
    elif index_name == "ScaNN":
        from quake_tpu_torch.wrappers.scann import ScaNNWrapper as IndexClass
    elif index_name == "SVS":
        from quake_tpu_torch.wrappers.vamana import SVSVamana as IndexClass
    else:
        raise ValueError(f"Unknown index type: {index_name}")
    return IndexClass


class IndexWrapper(abc.ABC):
    """Wrapper interface over index implementations (wrapper.py:22-80)."""

    @abc.abstractmethod
    def build(self, vectors: np.ndarray, *args, ids: Optional[np.ndarray] = None):
        raise NotImplementedError

    @abc.abstractmethod
    def search(self, query: np.ndarray, k: int, *args, **kwargs):
        raise NotImplementedError

    @abc.abstractmethod
    def add(self, vectors: np.ndarray, ids: Optional[np.ndarray] = None, **kwargs):
        raise NotImplementedError

    @abc.abstractmethod
    def remove(self, ids: np.ndarray):
        raise NotImplementedError

    @abc.abstractmethod
    def save(self, directory: str):
        raise NotImplementedError

    @abc.abstractmethod
    def load(self, directory: str, **kwargs):
        raise NotImplementedError

    @abc.abstractmethod
    def centroids(self) -> Union[np.ndarray, None]:
        raise NotImplementedError

    @abc.abstractmethod
    def n_total(self) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def maintenance(self):
        return None

    @abc.abstractmethod
    def d(self) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def index_state(self) -> dict:
        raise NotImplementedError
