"""The yardstick of the search's work: operations and bytes counted from
shapes, once, as the inputs need them, whatever implements them, and the
least time one NVIDIA H100 (SXM) needs for them.

A batch of B queries at nprobe over an IVF index of `nlist` partitions
needs, for l2:
- operations: 2 D for every (query, vector) pair in the query's probed
  partitions, plus 2 D for every (query, centroid) pair of the parent
  ranking;
- bytes: the probed partitions' codes and cached norms read once (the union
  over the batch), the centroids and the queries (float32) read once, and the
  results (an int32 id and a float32 distance each) written once.
The bound is the larger of operations over the tensor-core rate of the
codes' dtype (TF32's for float32 codes, each product counted once) and bytes
over the HBM rate. A device that spends more time than the bound reads a
share under 100%, however a later kernel computes it.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit.
PEAK_FLOPS = {"f32": 495e12, "bf16": 989e12}  # TF32 and bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
CODE_BYTES = {"f32": 4, "bf16": 2}


def search_work(probes: torch.Tensor, sizes: torch.Tensor, d: int, k: int,
                codes: str) -> tuple[float, float]:
    """(operations, bytes) of one batch. probes [B, nprobe]: each query's
    probed partitions (indexes of `sizes`); sizes [nlist]: the vectors each
    partition holds."""
    B = probes.shape[0]
    nlist = sizes.shape[0]
    sizes = sizes.to(torch.int64)
    pairs = int(sizes[probes.to(torch.int64)].sum())
    flops = 2.0 * d * pairs + 2.0 * d * B * nlist
    touched = torch.zeros(nlist, dtype=torch.bool, device=probes.device)
    touched[probes.reshape(-1).to(torch.int64)] = True
    rows = int(sizes[touched].sum())
    nbytes = (rows * (d * CODE_BYTES[codes] + 4) + nlist * d * 4 + B * d * 4 + B * k * 8)
    return flops, float(nbytes)


def bound_seconds(flops: float, nbytes: float, codes: str) -> float:
    """The least time the card needs for the work."""
    return max(flops / PEAK_FLOPS[codes], nbytes / HBM_BYTES_PER_S)
