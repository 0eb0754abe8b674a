#!/usr/bin/env python3
"""The scores of K6, K8 and sized_topk, of their f32 plain versions and of
their plain versions on the split product's model, each against a float64
reference, at the v3, v2, approx and sized paths' inputs, on one card; and
the keys of K1's bf16 body at the headline bf16 path's inputs.

    python3 scripts/exact_score_errors.py [k6] [k8] [sized] [k1bf16]

Builds chip_smoke.py's main index (1,000,000 x 128 manifold, nlist=160),
groups the first B=16384 queries' nprobe-9 probe lists as the v3, v2 and
approx scans do (qt = 64, kk = 10). k6: runs K6 in mode slot and mode id,
its f32 plain version and that plain version on ops/split_product.py's
model, and scores every winner of each again in float64 (the same f32
inputs; mode slot with the store's f32 norms). k8: runs K8 (raw_scores), its
f32 plain version and that on the model, 64 groups at a time, against
2 <q, x> - |q|^2 - |x|^2 in float64 at every lane that holds a vector.
sized: runs sized_topk, its f32 plain version and that on the model at the
sized path's inputs (kk = 10, ct = 256), and scores every winner again in
float64 (2 <q, x> - |q|^2 - |x|^2, the norms summed in float64: the kernel
sums both itself). Prints, per kernel, mode and side, the largest absolute error, the largest
error over chip_smoke.py's score tolerance (rtol = atol = SCORE_TOL) with
the float64 score where it falls, the share of scores beyond the tolerance,
and the mean absolute error; then the card's name and power limit. With no
argument all run. k1bf16: builds the same corpus with precision="bf16",
takes the v11 path's K1 inputs of the first B=16384 queries at nprobe 9,
and holds the key of every winner of K1's bf16 body, of the same body built
with QK_BF16_PARTIAL_STEPS 1 and 16 (a partial sum on the tensor cores of
one depth-16 step, and of a whole ring stage, against the package's 4) and
of its f32 plain version to the float64 key floor(<qg, x> - normsT) of the
same lane (bf16 operands, normsT's f32 values): the share of winners whose
key differs and the largest difference; with each build's ms per launch.
The package and chip_smoke.py are imported from the current directory, so
run from the root of another checkout it measures that checkout's kernels
and model.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from quake_tpu_torch import IndexBuildParams, QuakeIndex, _ext  # noqa: E402
from quake_tpu_torch.coordinator import rank_parents  # noqa: E402
from quake_tpu_torch.ops.grouped import build_groups  # noqa: E402
from quake_tpu_torch.ops.grouped_exact import exact_scan, exact_scan_plain  # noqa: E402
from quake_tpu_torch.ops.grouped_scan import (FOLD, grouped_scan_kernel,  # noqa: E402
                                              grouped_scan_plain)
from quake_tpu_torch.ops.grouped_variants import (raw_scores, raw_scores_plain,  # noqa: E402
                                                  sized_topk, sized_topk_plain)
from quake_tpu_torch.ops.split_product import bmm_as_split_product  # noqa: E402

NPROBE, QT, KK = 9, 64, 10
K8_CHUNK = 64  # groups a step of the k8 section
SECTIONS = ("k6", "k8", "sized", "k1bf16")
PARTIAL_STEPS = (1, 16)  # the K1 bf16 builds beside the package's (4 steps a partial sum)
SIZED_CT = cs.SIZED_CT


class Errors:
    """Running error statistics of one side against float64."""

    def __init__(self):
        self.n, self.beyond, self.sum, self.max, self.ratio, self.at = 0, 0, 0.0, 0.0, -1.0, 0.0

    def add(self, s, s64):
        if s64.numel() == 0:
            return
        err = (s.double() - s64).abs()
        ratio = err / (cs.SCORE_TOL + cs.SCORE_TOL * s64.abs())
        j = int(ratio.argmax())
        if float(ratio[j]) > self.ratio:
            self.ratio, self.at = float(ratio[j]), float(s64[j])
        self.n += err.numel()
        self.beyond += int((ratio > 1).sum())
        self.sum += float(err.sum())
        self.max = max(self.max, float(err.max()))

    def line(self, what: str) -> str:
        return (f"{what}: max abs error {self.max:.3g}, worst error / tolerance {self.ratio:.3f} "
                f"at a float64 score of {self.at:.4f}, beyond it {self.beyond / self.n:.2e} of "
                f"{self.n} scores, mean abs error {self.sum / self.n:.3g}")


def k8_errors(gpid, qg, st):
    """K8, its f32 plain version and that on the model, against float64, at
    every lane with a vector, K8_CHUNK groups at a time."""
    sides = {name: Errors() for name in ("kernel", "f32 plain", "split model")}
    for g0 in range(0, gpid.shape[0], K8_CHUNK):
        gp, q = gpid[g0:g0 + K8_CHUNK].contiguous(), qg[g0:g0 + K8_CHUNK].contiguous()
        alive = gp >= 0
        got = {"kernel": raw_scores(gp, q, st.codes, st.ids, "l2"),
               "f32 plain": raw_scores_plain(gp, q, st.codes, st.ids, "l2")}
        with bmm_as_split_product():
            got["split model"] = raw_scores_plain(gp, q, st.codes, st.ids, "l2")
        x = st.codes[gp[alive].long()].double()
        q64 = q[alive].double()
        s64 = (2.0 * torch.bmm(q64, x.transpose(1, 2)) - (q64 * q64).sum(-1, keepdim=True)
               - (x * x).sum(-1)[:, None, :])
        valid = (st.ids[gp[alive].long()] >= 0)[:, None, :].expand_as(s64)
        for name, s in got.items():
            sides[name].add(s[alive][valid], s64[valid])
    for name, e in sides.items():
        print(e.line(f"K8, {name}"), flush=True)


def k6_errors(gpid, qg, gsize, st):
    """K6 in both modes, its f32 plain version and that on the model, at
    every winner, against float64."""
    P, C, D = st.codes.shape
    # Row of the slabs viewed as [P C, D] that holds each id.
    where = torch.full((int(st.ids.max()) + 1,), -1, dtype=torch.long, device=st.codes.device)
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
            e = Errors()
            e.add(s[won], s64)
            print(e.line(f"K6 mode {mode}, {name}"), flush=True)


def sized_errors(gpid, qg, gsize, st):
    """sized_topk, its f32 plain version and that on the model, at every
    winner (a slot below the size), against float64."""
    P, C, D = st.codes.shape
    codes2 = st.codes.reshape(P * C, D)
    sides = {"kernel": sized_topk(gpid, gsize, qg, st.codes, KK, "l2", ct=SIZED_CT),
             "f32 plain": sized_topk_plain(gpid, gsize, qg, st.codes, KK, "l2", ct=SIZED_CT)}
    with bmm_as_split_product():
        sides["split model"] = sized_topk_plain(gpid, gsize, qg, st.codes, KK, "l2", ct=SIZED_CT)
    for name, (s, i) in sides.items():
        won = i >= 0
        g, r, _ = torch.nonzero(won, as_tuple=True)
        row = gpid[g].long() * C + i[won].long()
        xv, qv = codes2[row].double(), qg[g, r].double()
        s64 = 2.0 * (xv * qv).sum(-1) - (qv * qv).sum(-1) - (xv * xv).sum(-1)
        e = Errors()
        e.add(s[won], s64)
        print(e.line(f"sized_topk, {name}"), flush=True)


def start_partial_builds(tmp: str) -> dict:
    """nvcc of csrc/quake_kernels.cu with each of PARTIAL_STEPS, all started
    together: {steps: (library path, process)}."""
    out = {}
    for n in PARTIAL_STEPS:
        so = os.path.join(tmp, f"libk1_partial_{n}.so")
        out[n] = (so, subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, f"-DQK_BF16_PARTIAL_STEPS={n}", "-shared",
             str(_ext.CSRC / "quake_kernels.cu"), "-ldl", "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return out


def k1_bf16_errors(x, queries, dev, builds):
    """K1's bf16 body (the package's and the PARTIAL_STEPS builds) and its
    f32 plain version at the headline bf16 inputs: every winner's key
    against the float64 key of its lane, and ms per launch."""
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(cs.N, dtype=np.int64),
              IndexBuildParams(nlist=cs.NLIST, metric="l2", niter=cs.NITER, precision="bf16",
                               calibrate_aps=False))
    st = idx.store.state
    P, C, D = st.codes.shape
    q = torch.from_numpy(queries).to(dev)
    pids = cs.probe_lists(torch, idx, q, NPROBE)
    qt, inp, args = cs.k1_args(idx, q, pids)
    gp, gsize, qg, _, normsT, kk, slot_mult, levels = args
    Gn = qg.shape[0]
    package_ms = cs.time_ms(torch, lambda: grouped_scan_kernel(*args))
    sides = {"kernel, 4 steps a partial sum": (grouped_scan_kernel(*args), package_ms)}
    for n, (so, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {n}-step build:\n{log}")
        entry = _ext.entry(ctypes.CDLL(so), "qk_grouped_scan_bf16")
        out = torch.empty((Gn, qt, kk), device=dev, dtype=torch.float32)

        def launch():
            _ext.check(entry(gp.data_ptr(), gsize.data_ptr(), qg.data_ptr(), st.codes.data_ptr(),
                             normsT.data_ptr(), out.data_ptr(), Gn, qt, D, P, C, kk,
                             float(slot_mult), float(levels), FOLD, _ext.stream_ptr(dev)),
                       f"grouped_scan_bf16 ({n} steps)")

        launch()
        sides[f"kernel, {n} step{'s' if n > 1 else ''} a partial sum"] = (out.clone(),
                                                                          cs.time_ms(torch, launch))
    sides["f32 plain version"] = (grouped_scan_plain(*args), None)
    codes2 = st.codes.reshape(P * C, D)
    for name, (packed, ms) in sides.items():
        won = packed >= 0
        g, r, _ = torch.nonzero(won, as_tuple=True)
        v = packed[won]
        lane = torch.remainder(v, slot_mult).long()
        row = gp[g].long() * C + lane
        dot = (codes2[row].double() * qg[g, r].double()).sum(-1)
        key64 = torch.clamp(torch.floor(dot - normsT.reshape(-1)[row].double()), 0, levels)
        diff = (torch.floor(v / slot_mult).double() - key64).abs()
        print(f"K1 bf16, {name}: {won.sum().item()} winners, key differs from float64 at "
              f"{(diff > 0).double().mean().item():.2e} of them, max difference "
              f"{diff.max().item():.0f}" + (f"; {ms:.4f} ms" if ms is not None else ""),
              flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("exact_score_errors: no CUDA device", file=sys.stderr)
        return 1
    sections = argv or list(SECTIONS)
    if set(sections) - set(SECTIONS):
        print(f"exact_score_errors: choose sections from {SECTIONS}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    builds = start_partial_builds(tmp.name) if "k1bf16" in sections else {}
    x = cs.make_manifold(cs.N, cs.D, 4096, seed=1)
    queries = cs.make_manifold(cs.BATCH, cs.D, 4096, seed=7)
    if "k1bf16" in sections:
        k1_bf16_errors(x, queries, dev, builds)
    tmp.cleanup()
    if not set(sections) - {"k1bf16"}:
        print(cs.card_line())
        return 0
    idx = QuakeIndex(device=dev)
    idx.build(x, np.arange(cs.N, dtype=np.int64),
              IndexBuildParams(nlist=cs.NLIST, metric="l2", niter=cs.NITER, calibrate_aps=False))
    st, pst = idx.store.state, idx.parent.store.state
    P = st.codes.shape[0]
    q = torch.from_numpy(queries).to(dev)
    pids = rank_parents(pst.codes, pst.ids, pst.norms, q, NPROBE, "l2", "pallas")
    pids = torch.where(pids >= 0, pids, pids[:, :1])
    gpid, qlist, _, _ = build_groups(pids, P, QT)
    qg = q[qlist.clamp(min=0).long()].contiguous()
    gsize = torch.where(gpid >= 0, st.sizes[gpid.clamp(min=0).long()],
                        torch.zeros_like(gpid)).to(torch.int32).contiguous()
    if "k8" in sections:
        k8_errors(gpid, qg, st)
    if "k6" in sections:
        k6_errors(gpid, qg, gsize, st)
    if "sized" in sections:
        sized_errors(gpid, qg, gsize, st)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
