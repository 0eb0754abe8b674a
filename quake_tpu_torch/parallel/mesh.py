"""Device meshes: the partition store split over shards (a port of
quake_tpu/parallel/mesh.py).

The JAX package shards its store over a 1-D `jax.sharding.Mesh` and runs each
sharded search as one `shard_map` program. This package is single-controller
too, without a compiler to split the work: a `Mesh` is an ordered list of
devices, a sharded search runs each shard's scan on that shard's device from
one Python thread, and gathers every shard's result onto the mesh's first
device, which holds the replicated outputs. A device may appear more than
once: a mesh of n shards on one card (or n virtual shards on the CPU) runs
every shard's kernels and the merge as a mesh of n cards would, on one.

Two strategies over the store's [P(artitions), C(apacity), D] slabs, as in
the JAX package:

* "slot" (default): the slot axis C split, every shard holding a 1/ndev
  slice of every partition (perfectly balanced whatever the probe skew).
  Each shard's slice is a contiguous copy: `codes[:, s*Cl:(s+1)*Cl]` is not
  contiguous, and the kernels' tensor maps need a contiguous, 16-byte
  aligned [P*Cl, D].
* "partition": the partition axis P split, block ownership; each shard's
  block is a contiguous slice (a view where it stays on the store's
  device).

The store's global StoreState stays the one primary copy: mutation,
maintenance, validate and save read and write only it, and an index
rebuilds its ShardedState after any write (PartitionStore.version).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

SHARD_AXIS = "shard"
STRATEGIES = ("slot", "partition")


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along the shard axis; devices[0] holds
    the replicated outputs (the gathered results, the merged state)."""
    devices: tuple
    axis: str = SHARD_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None,
              device="cuda") -> Mesh:
    """1-D mesh over the shard axis (quake_tpu/parallel/mesh.py::make_mesh).

    devices: an explicit list, which may repeat a device (n shards on one
    card, as XLA's forced host device count gives n on one CPU). Otherwise,
    for a CUDA `device` the first min(n_devices, torch.cuda.device_count())
    cards (all of them for n_devices=0), truncated as jax.devices()[:n] is;
    for a CPU `device` n_devices virtual shards of the CPU (one for 0)."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh: devices is empty")
        return Mesh(devs)
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = min(n_devices, count) if n_devices else count
        if n < 1:
            raise RuntimeError("make_mesh: no CUDA device")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh(tuple([device] * max(int(n_devices), 1)))


def replicate(x: torch.Tensor, mesh: Mesh) -> list:
    """One copy of x on each shard's device (x itself where it is already
    there: a repeated device shares one tensor)."""
    return [x.to(d) for d in mesh.devices]


@dataclass
class ShardedState:
    """The store's arrays split over a mesh: per shard (lists in shard
    order) `codes` [P, Cl, D] / [Pl, C, D], `ids`, `norms`, and `sizes`
    (replicated global sizes under "slot", the shard's rows under
    "partition"); replicated `centroids` and `active`; `local_sizes`, each
    shard's count of valid slots per row (ids >= 0: a slot slice of the
    compact prefix is itself a prefix), which its scans take as sizes."""
    mesh: Mesh
    strategy: str
    codes: list
    ids: list
    norms: list
    sizes: list
    centroids: list
    active: list
    local_sizes: list

    @property
    def ndev(self) -> int:
        return self.mesh.size


def shard_store_state(state, mesh: Mesh, strategy: str = "slot") -> ShardedState:
    """Place the store's arrays on the mesh (quake_tpu/parallel/mesh.py::
    shard_store_state): slot shards are contiguous copies of each shard's
    slot slice, partition shards contiguous slices of the partition axis.
    Raises ValueError where the sharded axis does not divide."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, not {strategy!r}")
    ndev = mesh.size
    P, C = state.ids.shape
    codes, ids, norms, sizes = [], [], [], []
    if strategy == "partition":
        if P % ndev != 0:
            raise ValueError(f"partition axis {P} not divisible by {ndev}")
        Pl = P // ndev
        for s, d in enumerate(mesh.devices):
            rows = slice(s * Pl, (s + 1) * Pl)
            codes.append(state.codes[rows].to(d).contiguous())
            ids.append(state.ids[rows].to(d).contiguous())
            norms.append(state.norms[rows].to(d).contiguous())
            sizes.append(state.sizes[rows].to(d).contiguous())
    else:
        if C % ndev != 0:
            raise ValueError(f"slot axis {C} not divisible by {ndev}")
        Cl = C // ndev
        for s, d in enumerate(mesh.devices):
            slots = slice(s * Cl, (s + 1) * Cl)
            codes.append(state.codes[:, slots].to(d).contiguous())
            ids.append(state.ids[:, slots].to(d).contiguous())
            norms.append(state.norms[:, slots].to(d).contiguous())
        sizes = replicate(state.sizes, mesh)
    local_sizes = [torch.sum((i >= 0).to(torch.int32), dim=1, dtype=torch.int32) for i in ids]
    return ShardedState(mesh=mesh, strategy=strategy, codes=codes, ids=ids, norms=norms,
                        sizes=sizes, centroids=replicate(state.centroids, mesh),
                        active=replicate(state.active, mesh), local_sizes=local_sizes)
