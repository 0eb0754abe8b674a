#!/usr/bin/env python3
"""K6's scores, its f32 plain version's and its plain version's on the split
product's model, each against a float64 reference, at the v3 and v2 paths'
inputs, on one card.

    python3 scripts/exact_score_errors.py

Builds chip_smoke.py's main index (1,000,000 x 128 manifold, nlist=160),
groups the first B=16384 queries' nprobe-9 probe lists as the v3 and v2
scans do (qt = 64, kk = 10), runs K6 in mode slot and mode id, its f32 plain
version and that plain version on ops/split_product.py's model, and scores
every winner of each again in float64 (the same f32 inputs; mode slot with
the store's f32 norms). Prints, per mode and side, the largest absolute
error, the largest error over chip_smoke.py's score tolerance (rtol = atol =
SCORE_TOL) with the float64 score where it falls, the share of winners
beyond the tolerance, and the mean absolute error; then the card's name and
power limit. The package and chip_smoke.py are imported from the current
directory, so run from the root of another checkout it measures that
checkout's kernels and model.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from quake_tpu_torch import IndexBuildParams, QuakeIndex  # noqa: E402
from quake_tpu_torch.coordinator import rank_parents  # noqa: E402
from quake_tpu_torch.ops.grouped import build_groups  # noqa: E402
from quake_tpu_torch.ops.grouped_exact import exact_scan, exact_scan_plain  # noqa: E402
from quake_tpu_torch.ops.split_product import bmm_as_split_product  # noqa: E402

NPROBE, QT, KK = 9, 64, 10


def main() -> int:
    if not torch.cuda.is_available():
        print("exact_score_errors: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    x = cs.make_manifold(cs.N, cs.D, 4096, seed=1)
    queries = cs.make_manifold(cs.BATCH, cs.D, 4096, seed=7)
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(cs.N, dtype=np.int64),
              IndexBuildParams(nlist=cs.NLIST, metric="l2", niter=cs.NITER, calibrate_aps=False))
    st, pst = idx.store.state, idx.parent.store.state
    P, C, D = st.codes.shape
    q = torch.from_numpy(queries).to(dev)
    pids = rank_parents(pst.codes, pst.ids, pst.norms, q, NPROBE, "l2", "pallas")
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    gpid, qlist, _, _ = build_groups(pids, P, QT)
    qg = q[qlist.clamp(min=0).long()].contiguous()
    gsize = torch.where(gpid >= 0, st.sizes[gpid.clamp(min=0).long()],
                        torch.zeros_like(gpid)).to(torch.int32).contiguous()
    # Row of the slabs viewed as [P C, D] that holds each id.
    where = torch.full((int(st.ids.max()) + 1,), -1, dtype=torch.long, device=dev)
    flat = st.ids.reshape(-1).long()
    where[flat[flat >= 0]] = torch.nonzero(flat >= 0).flatten()
    codes2 = st.codes.reshape(P * C, D)
    for mode, kw in (("slot", dict(group_size=gsize, norms=st.norms)), ("id", dict(ids=st.ids))):
        sides = {"kernel": exact_scan(gpid, qg, st.codes, KK, "l2", mode, **kw),
                 "f32 plain": exact_scan_plain(gpid, qg, st.codes, KK, "l2", mode, **kw)}
        with bmm_as_split_product():
            sides["split model"] = exact_scan_plain(gpid, qg, st.codes, KK, "l2", mode, **kw)
        for name, (s, i) in sides.items():
            won = i >= 0
            g, r, _ = torch.nonzero(won, as_tuple=True)
            idx_ = i[won].long()
            row = gpid[g].long() * C + idx_ if mode == "slot" else where[idx_]
            xv, qv = codes2[row].double(), qg[g, r].double()
            dot = (xv * qv).sum(-1)
            if mode == "slot":
                s64 = 2.0 * dot - st.norms.reshape(-1)[row].double()
            else:
                s64 = 2.0 * dot - (qv * qv).sum(-1) - (xv * xv).sum(-1)
            err = (s[won].double() - s64).abs()
            ratio = err / (cs.SCORE_TOL + cs.SCORE_TOL * s64.abs())
            j = int(ratio.argmax())
            print(f"K6 mode {mode}, {name}: max abs error {float(err.max()):.3g}, worst error / "
                  f"tolerance {float(ratio.max()):.3f} at a float64 score of {float(s64[j]):.4f}, "
                  f"beyond it {float((ratio > 1).double().mean()):.2e} of {int(won.sum())} "
                  f"winners, mean abs error {float(err.mean()):.3g}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
