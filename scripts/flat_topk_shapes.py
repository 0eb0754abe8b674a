#!/usr/bin/env python3
"""Where kernel K3's time goes: its device time across shapes on one card.

    python3 scripts/flat_topk_shapes.py

Run from the repository root on a machine with a CUDA card. K3 (the parent
ranking, ops/flat_topk.py) is timed with chip_smoke.py's time_ms at the main
path's shape (B = 16384 queries, a buffer of N = 256 slots of which 160
hold a centroid, D = 128, k = 9) and at shapes that vary one thing at a
time: k = 1 (the cost of the selection rounds), B = 64 and B = 8448 (one
64-query tile, and one tile on each of 132 SMs: the time of a tile), more
slots (a segment of 128 slots more, up to N = 768 where the scores no longer
fit shared memory and the body multiplies twice) and D (depth chunks). Prints
one line per shape and the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from quake_tpu_torch.ops.flat_topk import flat_topk, flat_topk_body  # noqa: E402

SHAPES = (  # (B, N, D, k, slots that hold a centroid: None = all)
    (16384, 256, 128, 9, 160), (16384, 256, 128, 1, 160), (8448, 256, 128, 9, 160),
    (64, 256, 128, 9, 160), (16384, 128, 128, 9, None), (16384, 256, 128, 9, None),
    (16384, 384, 128, 9, None), (16384, 640, 128, 9, None), (16384, 768, 128, 9, None),
    (16384, 256, 32, 9, None), (16384, 256, 256, 9, None),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_topk_shapes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, N, D, k, valid in SHAPES:
        codes = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(dev)
        bias = -(codes * codes).sum(1)
        if valid is not None:
            bias[valid:] = float("-inf")
        bias = bias.contiguous()
        ms = chip_smoke.time_ms(torch, lambda: flat_topk(codes, bias, q, k, "l2"), reps=20)
        print(f"B={B} N={N} (valid {valid or N}) D={D} k={k} body={flat_topk_body(N, D)}: "
              f"{ms:.4f} ms", flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
