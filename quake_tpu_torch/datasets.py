"""Dataset loaders for ANN benchmarks (a copy of quake_tpu/datasets.py).

Mirrors reference src/python/datasets/ann_datasets.py:14-86: a Dataset ABC
(is_downloaded/download/load_vectors/load_queries/load_ground_truth/load),
SIFT1M (download + fvecs/ivecs parsing), and a `load_dataset` name registry.
Adds synthetic datasets that work in zero-egress environments.
"""

from __future__ import annotations

import os
import tarfile
import urllib.request
from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

from quake_tpu_torch.utils import fvecs_read, ivecs_read


class Dataset(ABC):
    """A dataset is (base vectors, queries, ground truth ids).

    Reference ABC (ann_datasets.py:14-40): per-component loaders plus a
    `load()` that returns all three. Synthetic datasets generate the three
    components together, so the base class routes the per-component API
    through one cached `load()` result.
    """

    url: str = ""
    metric: str = "l2"

    def __init__(self, download_dir: str | None = None):
        # Offline ingestion path: point QUAKE_TPU_DATA_DIR at a directory of
        # pre-downloaded dataset files (e.g. sift/sift_base.fvecs) and every
        # loader picks them up without network access — the zero-egress
        # equivalent of the reference's downloader (ann_datasets.py:43-86).
        # Only the *default* (None) consults the env var: an explicitly
        # passed directory — including "data" — always wins.
        if download_dir is None:
            download_dir = os.environ.get("QUAKE_TPU_DATA_DIR", "data")
        self.download_dir = Path(download_dir)
        self._cached = None

    @abstractmethod
    def load(self):
        """Returns (vectors [n,d] f32, queries [nq,d] f32, gt_ids [nq,k] i64)."""

    def _loaded(self):
        if self._cached is None:
            self._cached = self.load()
        return self._cached

    def load_vectors(self) -> np.ndarray:
        """Reference ann_datasets.py:28-29."""
        return self._loaded()[0]

    def load_queries(self) -> np.ndarray:
        """Reference ann_datasets.py:32-33."""
        return self._loaded()[1]

    def load_ground_truth(self) -> np.ndarray:
        """Reference ann_datasets.py:36-37."""
        return self._loaded()[2]

    def is_downloaded(self) -> bool:
        return False

    def download(self, overwrite: bool = False):
        """Fetch + extract `url` (ann_datasets.py:59-64). No-op when the
        files are already present unless `overwrite`."""
        if self.is_downloaded() and not overwrite:
            return
        self.download_dir.mkdir(parents=True, exist_ok=True)
        fname = self.download_dir / os.path.basename(self.url)
        if overwrite or not fname.exists():
            urllib.request.urlretrieve(self.url, fname)
        if str(fname).endswith(("tar.gz", ".tgz")):
            with tarfile.open(fname) as tar:
                tar.extractall(self.download_dir)


class Sift1m(Dataset):
    """SIFT1M (ann_datasets.py:43-72): 1M x 128 L2, fvecs/ivecs format."""

    url = "ftp://ftp.irisa.fr/local/texmex/corpus/sift.tar.gz"
    metric = "l2"

    def _root(self) -> Path:
        # Accept both the extracted tarball layout (<dir>/sift/...) and a
        # flat drop of the three fvecs/ivecs files directly in <dir>.
        if (self.download_dir / "sift" / "sift_base.fvecs").exists():
            return self.download_dir / "sift"
        return self.download_dir

    def is_downloaded(self) -> bool:
        root = self._root()
        return all((root / f"sift_{part}.{ext}").exists()
                   for part, ext in (("base", "fvecs"), ("query", "fvecs"),
                                     ("groundtruth", "ivecs")))

    def load_vectors(self) -> np.ndarray:
        return fvecs_read(str(self._root() / "sift_base.fvecs"))

    def load_queries(self) -> np.ndarray:
        return fvecs_read(str(self._root() / "sift_query.fvecs"))

    def load_ground_truth(self) -> np.ndarray:
        gt = ivecs_read(str(self._root() / "sift_groundtruth.ivecs"))
        return gt.astype(np.int64)

    def load(self):
        if not self.is_downloaded():
            self.download()
        return self.load_vectors(), self.load_queries(), self.load_ground_truth()


class RandomDataset(Dataset):
    """Synthetic gaussian dataset (no download needed)."""

    metric = "l2"

    def __init__(self, download_dir: str | None = None, n: int = 100_000, d: int = 64,
                 nq: int = 1000, seed: int = 0):
        super().__init__(download_dir)
        self.n, self.d, self.nq, self.seed = n, d, nq, seed

    def is_downloaded(self) -> bool:
        return True

    def load(self):
        from quake_tpu_torch.utils import knn

        rng = np.random.default_rng(self.seed)
        base = rng.standard_normal((self.n, self.d)).astype(np.float32)
        queries = rng.standard_normal((self.nq, self.d)).astype(np.float32)
        gt, _ = knn(queries, base, 100, self.metric)
        return base, queries, gt


class ClusteredDataset(Dataset):
    """Synthetic clustered dataset mimicking SIFT-like IVF behavior
    (recall rises steeply with nprobe). Used by the regression harness when
    real datasets cannot be downloaded."""

    metric = "l2"

    def __init__(self, download_dir: str | None = None, n: int = 100_000, d: int = 64,
                 nq: int = 1000, n_centers: int = 512, spread: float = 4.0,
                 seed: int = 0):
        super().__init__(download_dir)
        self.n, self.d, self.nq = n, d, nq
        self.n_centers, self.spread, self.seed = n_centers, spread, seed

    def is_downloaded(self) -> bool:
        return True

    def load(self):
        from quake_tpu_torch.utils import knn

        rng = np.random.default_rng(self.seed)
        centers = rng.standard_normal((self.n_centers, self.d)).astype(np.float32)
        centers *= self.spread
        assign = rng.integers(0, self.n_centers, self.n)
        base = (centers[assign] + rng.standard_normal((self.n, self.d))).astype(np.float32)
        q_assign = rng.integers(0, self.n_centers, self.nq)
        queries = (centers[q_assign] + rng.standard_normal((self.nq, self.d))).astype(
            np.float32
        )
        gt, _ = knn(queries, base, 100, self.metric)
        return base, queries, gt


_REGISTRY = {
    "sift1m": Sift1m,
    "random": RandomDataset,
    "clustered": ClusteredDataset,
}


def load_dataset(name: str, download_dir: str | None = None,
                 overwrite_download: bool = False, **kwargs):
    """Registry entry point (ann_datasets.py:75-86): construct, ensure the
    files are present (downloading if the environment allows), and return
    [vectors, queries, ground_truth]."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
    ds = _REGISTRY[key](download_dir, **kwargs)
    if overwrite_download:
        ds.download(overwrite=True)
    return ds.load()
