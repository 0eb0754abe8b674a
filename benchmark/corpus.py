"""The synthetic corpus, made on the device from a seed.

A torch copy of `make_manifold` (chip_smoke.py, itself a copy of
bench.py:41-51): points on a `zdim`-dimensional manifold of `n_centers`
Gaussian clusters, embedded in `d` dimensions, plus isotropic noise. The
manifold (the embedding `A` and the cluster centres) comes from the
configuration's fixed `basis_seed`, so every run's corpus has the same
distribution; the points come from the run's seed. Each stream of points
(corpus, query batches, inserts) has a generator of its own, seeded from the
run's seed and the stream's number, so the same seed gives the same inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SEED_MOD = 2**63 - 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of a run (any whole-number seed)."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919 + 17) % SEED_MOD


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


@dataclass
class Manifold:
    A: torch.Tensor  # [zdim, d]
    centers: torch.Tensor  # [n_centers, zdim]
    noise: float

    @classmethod
    def from_config(cls, corpus: dict, d: int, device) -> "Manifold":
        g = torch.Generator(device=device).manual_seed(int(corpus["basis_seed"]))
        zdim = int(corpus["zdim"])
        A = torch.randn(zdim, d, generator=g, device=device) / math.sqrt(zdim)
        centers = torch.randn(int(corpus["n_centers"]), zdim, generator=g,
                              device=device) * float(corpus["spread"])
        return cls(A, centers, float(corpus["noise"]))

    def sample(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """[n, d] float32 points on the device."""
        dev = self.A.device
        idx = torch.randint(0, self.centers.shape[0], (n,), generator=gen, device=dev)
        z = self.centers[idx] + torch.randn(n, self.centers.shape[1], generator=gen, device=dev)
        # z @ A as elementwise steps in a fixed order: the same bits each
        # time, so the inputs can be made again after the window.
        x = torch.zeros(n, self.A.shape[1], device=dev)
        for j in range(self.A.shape[0]):
            x.addcmul_(z[:, j:j + 1], self.A[j:j + 1])
        return x + self.noise * torch.randn(x.shape, generator=gen, device=dev)
