#!/usr/bin/env python3
"""The kernels' small-shape parity calls, for a run under a memory checker.

    compute-sanitizer --tool memcheck python3 scripts/sanitize_kernels.py
    python3 scripts/sanitize_kernels.py          # the same calls, unchecked

Run from the root of a checkout on a machine with a CUDA card: the analog of
the reference's opt-in sanitizer builds (CMakeLists.txt:186-196) for the
hand-written kernels. Builds the kernel library (quake_tpu_torch/_ext.py) and
runs chip_smoke.py's small-shape parity phase (phase_small_parity: K1-K9,
sized_topk and multi_topk against their plain versions at small shapes and
at the shapes that stress their tensor-core tiles, K1 on bf16 codes), then
synchronizes, so that memcheck sees every launch to its end. PyTorch's
caching allocator is switched off (PYTORCH_NO_CUDA_MEMORY_CACHING=1) so that
each tensor is an allocation of its own and an access past its end is an
access outside any allocation. Exits non-zero where a check fails or there
is no card; prints one JSON line with the launches and seconds.
chip_smoke.py does not run it.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("PYTORCH_NO_CUDA_MEMORY_CACHING", "1")
sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke as cs
    from quake_tpu_torch import _ext

    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _ext.lib()
    build_s = time.perf_counter() - t0
    _ext.reset_launches()
    t0 = time.perf_counter()
    cs.phase_small_parity(torch, dev)
    torch.cuda.synchronize()
    print(json.dumps({"card": cs.card_line(), "build_s": build_s,
                      "parity_s": time.perf_counter() - t0,
                      "launches": {k: v for k, v in _ext.launches.items() if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
