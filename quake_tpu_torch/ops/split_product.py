"""Plain model of the split-precision product of the tensor-core kernels.

The kernels multiply on the tensor cores in TF32 (8 exponent bits, 10
mantissa bits) and keep f32 accuracy by splitting each operand on the card
(csrc/common.cuh, `tf32_split` and `mma_tile`):

    hi = tf32(x)        lo = tf32(x - hi)
    <q, x> = q_lo x_hi + q_hi x_lo + q_hi x_hi      (summed in f32)

`tf32` rounds to nearest with ties away from zero, as `cvt.rna.tf32.f32`
does. The q_lo x_lo term is dropped: it is below 2^-22 of |q| |x|.

This module repeats that arithmetic in tensor operations, summed exactly:
the products of TF32 values and their sums over D are taken in float64 and
rounded once to f32, so the model carries the split's own error (the TF32
operands, the dropped term) and no order of summation of its own. A kernel
held to it is held to the split's arithmetic, within the rounding of its own
sums. The CPU tests and chip_smoke.py use it; nothing on a search path calls
it. The kernels' plain versions stay f32: they are what the kernels are held
to.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

_LOW_BITS = 13  # f32 mantissa bits that TF32 drops
_HALF = 1 << (_LOW_BITS - 1)
_KEEP = ~((1 << _LOW_BITS) - 1)  # int32 mask 0xFFFFE000


def tf32_round(x):
    """x (f32) rounded to TF32, returned as f32 with the 13 low mantissa bits
    zero: round to nearest, ties away from zero (`cvt.rna.tf32.f32`). On the
    sign-magnitude bit pattern that is: add half of the last kept place,
    then clear the dropped bits. Infinities and NaNs pass through."""
    x = x.to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _HALF) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): x = hi + lo up to
    2^-21 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def split_matmul(q, x):
    """q [..., m, D] times x [..., n, D] transposed, [..., m, n], as the
    three partial products of the split operands, summed in float64 and
    rounded once to f32."""
    q_hi, q_lo = (t.to(torch.float64) for t in tf32_split(q))
    x_hi, x_lo = (t.to(torch.float64).transpose(-1, -2) for t in tf32_split(x))
    exact = torch.matmul(q_lo, x_hi) + torch.matmul(q_hi, x_lo) + torch.matmul(q_hi, x_hi)
    return exact.to(torch.float32)


@contextlib.contextmanager
def bmm_as_split_product():
    """While active, `torch.bmm(a, b)` computes `split_matmul(a, b^T)`: the
    kernels' plain versions (`grouped_scan_plain`, `rowscale_scan_plain`),
    whose only product is a `torch.bmm`, then run on this model of the
    kernels' product instead of the f32 one."""
    with mock.patch.object(torch, "bmm", lambda a, b: split_matmul(a, b.transpose(-1, -2))):
        yield
