"""Flat top-k: ranked candidate selection over a flat vector buffer — the
counterpart of quake_tpu/ops/pallas_flat.py.

Built for the PARENT centroid ranking inside IVF search: the reference scans
its parent index with the same list-scanning kernels it uses for partitions
(query_coordinator.cpp:628-646). Selection order is by range-quantized score
(descending, lane tie-break), which is what candidate ranking needs: the
consumer treats the result as a ranked probe list, not as distances.

`flat_topk` launches kernel K3 (csrc/quake_kernels.cu) on CUDA tensors and
runs its plain PyTorch version, `flat_topk_plain`, on CPU tensors. K3's
launcher picks its body by shape (`flat_topk_body`): the tensor-core body
(split TF32 product, TMA loads, persistent blocks) where D % 4 == 0, with the
scores kept in shared memory where they fit and two passes where they do not;
the CUDA-core body (f32) otherwise. Every D is served: both stream the depth
in chunks. A bf16 parent (IndexBuildParams(parent_params=...,
precision="bf16")) puts bf16 codes here: the queries are rounded to bf16 as
pallas_flat.py::flat_topk_pallas rounds them (`q.astype(codes2d.dtype)`)
and K3 runs its bf16 body (one bf16 product a depth-16 step on the tensor
cores where D % 8 == 0, else the CUDA-core body on values converted to f32
as they load).
"""

from __future__ import annotations

import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops.grouped import (check_operands, launch_name, operand_bytes, round_query,
                                          use_kernel)
from quake_tpu_torch.ops.grouped_scan import fold_rounds

NEG_INF = float("-inf")
MAX_N = 16384  # keeps >= 1022 quantization levels in the packed key
CUDA_CORE_BODY, TWO_PASS_BODY, KEPT_BODY = 0, 1, 2  # flat_topk_body's answers


def flat_topk_body(N: int, D: int, dtype=torch.float32) -> int:
    """The body kernel K3's launcher runs at this shape on codes of `dtype`,
    asked of the built library: KEPT_BODY (tensor cores, the scores of a
    64-query tile kept in shared memory: N up to 640), TWO_PASS_BODY (tensor
    cores, the product taken twice) where D % 4 == 0 (f32) or D % 8 == 0
    (bf16), CUDA_CORE_BODY otherwise."""
    return int(_ext.lib().qk_flat_topk_body(N, D, operand_bytes(dtype)))


def select_v7(scores, valid, k: int, slot_mult: int, levels: int,
              fold: int = 128):
    """Column-folded max2 packed selection (plain version of
    pallas_grouped.py::_v7_select). scores [R, C] f32, valid [R, C] bool.

    Each row is range-quantized over its valid lanes,
    key = floor((s - rowmin) * (levels / rng)), packed with its lane, folded
    to `fold` columns (top-2 per column) and selected in k rounds — at most
    two winners per fold column, so it is approximate at the column level.
    Returns packed out [R, k] (descending; -1 = none)."""
    R, C = scores.shape
    lane = torch.arange(C, device=scores.device, dtype=torch.float32)[None, :]
    rowmax = torch.where(valid, scores, NEG_INF).amax(dim=1, keepdim=True)
    rowmin = torch.where(valid, scores, float("inf")).amin(dim=1, keepdim=True)
    rng = torch.clamp(rowmax - rowmin, min=1e-20)
    qk = torch.floor((scores - rowmin) * (float(levels) / rng))
    packed = torch.where(valid, qk * float(slot_mult) + lane,
                         torch.full_like(scores, -1.0))
    return fold_rounds(packed, k, fold)


def _packed_params(N: int):
    slot_mult = max(1 << int(N - 1).bit_length(), 2)
    return slot_mult, (1 << 24) // slot_mult - 2


def flat_topk_plain(codes2d, bias, q, k: int, metric: str, fold: int = 128):
    """Plain PyTorch version of kernel K3 (same inputs and outputs as
    flat_topk). q is rounded to the codes' dtype first, as the JAX package
    rounds it (pallas_flat.py:75); bf16 operands are then upcast and
    multiplied in f32 (a product of two bf16 values is exact there)."""
    slot_mult, levels = _packed_params(codes2d.shape[0])
    prod = (round_query(q, codes2d.dtype).to(torch.float32)
            @ codes2d.to(torch.float32).T)
    scores = (2.0 * prod + bias[None, :]) if metric == "l2" else prod + bias[None, :]
    out = select_v7(scores, scores > NEG_INF, k, slot_mult, levels, fold)
    slots = torch.remainder(out, float(slot_mult)).to(torch.int32)
    return torch.where(out >= 0.0, slots, torch.full_like(slots, -1))


def flat_topk(codes2d, bias, q, k: int, metric: str, fold: int = 128):
    """Ranked top-k slots of every query against a flat buffer.

    codes2d: [N, D] f32 or bf16 (N a multiple of `fold`, N <= 16384); bias:
    [N] f32 — for l2 the cached -||x||^2 with -inf at invalid (padding)
    slots, for ip the -inf/0 validity bias; q: [B, D] in the codes' dtype
    (the caller rounds it, as parent_rank does). Returns slots [B, k] int32
    (descending by quantized score; -1 = no candidate). Launches on bf16
    codes count under "flat_topk_bf16"."""
    B, D = q.shape
    N = codes2d.shape[0]
    if fold != 128 or N % fold or N > MAX_N:
        raise ValueError(f"flat_topk needs fold == 128, N % 128 == 0 and N <= {MAX_N} "
                         f"(N={N}, fold={fold})")
    if not use_kernel("flat_topk", q):
        return flat_topk_plain(codes2d, bias, q, k, metric, fold)
    dtype = codes2d.dtype
    check_operands("flat_topk", q.device, (("codes2d", codes2d, dtype, (N, D)),
                                           ("bias", bias, torch.float32, (N,)),
                                           ("q", q, dtype, (B, D))),
                   mma=flat_topk_body(N, D, dtype) != CUDA_CORE_BODY)
    slot_mult, levels = _packed_params(N)
    out = torch.empty((B, k), device=q.device, dtype=torch.int32)
    _ext.launch(launch_name("flat_topk", dtype), q, codes2d, bias, out, B, N, D, k,
                int(metric == "l2"), slot_mult, float(levels))
    return out


def parent_bias(parent_ids, parent_norms, metric: str):
    """[N] bias of the flat parent ranking: -||x||^2 (l2) or 0 (ip) on
    occupied slots, -inf on empty ones."""
    ids_flat = parent_ids.reshape(-1)
    ok = ids_flat >= 0
    if metric == "l2":
        base = -parent_norms.reshape(-1).to(torch.float32)
    else:
        base = torch.zeros(ids_flat.shape, device=ids_flat.device, dtype=torch.float32)
    return torch.where(ok, base, torch.full_like(base, NEG_INF)).contiguous()


def parent_rank(parent_codes, parent_ids, parent_norms, q, nprobe: int,
                metric: str):
    """Ranked candidate partition ids from the parent centroid store.

    parent_codes [Pp, Cp, D], parent_ids [Pp, Cp] (-1 = empty slot),
    parent_norms [Pp, Cp] cached squared norms. Returns pids [B, nprobe]
    int32 in rank order (-1 pad)."""
    Pp, Cp, D = parent_codes.shape
    N = Pp * Cp
    ids_flat = parent_ids.reshape(N)
    bias = parent_bias(parent_ids, parent_norms, metric)
    slots = flat_topk(parent_codes.reshape(N, D).contiguous(), bias,
                      round_query(q, parent_codes.dtype).contiguous(), nprobe, metric)
    pids = ids_flat[torch.clamp(slots, min=0).long()].to(torch.int32)
    return torch.where(slots >= 0, pids, torch.full_like(pids, -1))
