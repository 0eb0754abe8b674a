"""quake_tpu_torch: the PyTorch and CUDA port of quake_tpu for one NVIDIA
H100.

Ported so far: `QuakeIndex.build` and `QuakeIndex.search` at a fixed nprobe
(batched, query-major and on a flat index), with the three kernels of the
batched path (grouped scan, pool merge, parent ranking), the four more of the
grouped scans chosen by name through QUAKE_TPU_KERNEL and the four of the
scans with entry points of their own (`ops/grouped_variants.py`) as
hand-written CUDA kernels in `csrc/`, built with nvcc for sm_90a at first
use; `QuakeIndex.add`, `remove`, `modify`, `get`, `validate` and
`split_partitions` with split-on-overflow, on the native id map
(`native/idmap.cpp`, built with g++ at first use); recall-target search
(APS); cost-based maintenance (`maintenance/`: the hit window every search
feeds, the latency grid, profiled on the card at build where asked,
`QuakeIndex.maintenance()`); `save` and `load` in the JAX package's
format; and the tooling: index wrappers (`wrappers/`), dynamic workloads
(`workload/`), profiling, datasets and debug mode; and sharding over a
device mesh (`parallel/`: `QuakeIndex.shard`, `num_shards`), the shards'
results merged on the mesh's first device. Entry points run on the
card unless the caller passes `device="cpu"`, where every kernel wrapper
runs its plain PyTorch version. This package imports neither JAX nor quake_tpu.
"""

from quake_tpu_torch.convert import index_from_numpy
from quake_tpu_torch.index import QuakeIndex
from quake_tpu_torch.params import IndexBuildParams, MaintenancePolicyParams, SearchParams
from quake_tpu_torch.timing import (BuildTimingInfo, MaintenanceTimingInfo, ModifyTimingInfo,
                                    SearchResult, SearchTimingInfo)

__all__ = [
    "QuakeIndex",
    "IndexBuildParams",
    "SearchParams",
    "MaintenancePolicyParams",
    "SearchResult",
    "BuildTimingInfo",
    "ModifyTimingInfo",
    "SearchTimingInfo",
    "MaintenanceTimingInfo",
    "index_from_numpy",
]
