"""The seam between the kernel wrappers and the CUDA library, on the CPU
(no card, no nvcc): the launcher types read from the C prototypes of
csrc/*.cu, `_ext.launch` against a fake library of ctypes callbacks typed
from those prototypes, and the wrappers' tensor contract
(`ops.grouped.check_operands`)."""

import ctypes
import re
import types

import pytest
import torch

from quake_tpu_torch import _ext
from quake_tpu_torch.ops import (flat_topk, grouped_chunked, grouped_exact, grouped_family,
                                 grouped_scan, grouped_variants)
from quake_tpu_torch.ops.grouped import check_operands, launch_name, use_kernel

_F, _P = ctypes.c_float, ctypes.c_void_p

# --------------------------------------------------------------- the parse


def test_table_holds_every_prototype_and_each_bf16_twin():
    source = "\n".join(src.read_text() for src in _ext._sources())
    blocks = "\n".join(re.findall(r'extern "C" \{(.*?)\}  // extern "C"', source, re.S))
    plain = set(re.findall(r"^(?:int|const char\*) (qk_\w+)\(", blocks, re.M))
    twinned = set(re.findall(r"^int QK_ENTRY\((qk_\w+)\)\(", blocks, re.M))
    assert twinned and "qk_grouped_scan" in plain
    want = (plain | twinned | {f"{n}_bf16" for n in twinned}) - {"qk_empty"}
    assert set(_ext.signatures()) == want
    assert set(_ext.signatures(product_only=True)) == want | {"qk_empty"}


def test_parse_spot_checks():
    table = _ext.signatures()
    restype, argtypes = table["qk_grouped_scan"]
    assert restype is ctypes.c_int and len(argtypes) == 16
    assert [i for i, t in enumerate(argtypes) if t is _F] == [12, 13]
    assert argtypes[-1] is _P and table["qk_grouped_scan_bf16"] == table["qk_grouped_scan"]
    assert len(table["qk_exact_topk"][1]) == len(table["qk_exact_topk_bf16"][1]) == 17
    assert table["qk_error_string"] == (ctypes.c_char_p, (ctypes.c_int,))
    assert _ext.signatures(product_only=True)["qk_empty"] == (ctypes.c_int, (ctypes.c_int, _P))


def test_unknown_parameter_type_raises():
    src = ('extern "C" {\n\nint qk_x(const void* a, double b, void* stream) {\n}\n\n'
           '}  // extern "C"\n')
    with pytest.raises(ValueError, match="qk_x"):
        _ext.parse_signatures(src)
    ok = src.replace("double", "float").replace("int qk_x(", "int QK_ENTRY(qk_x)(")
    assert _ext.parse_signatures(ok) == dict.fromkeys(("qk_x", "qk_x_bf16"),
                                                      (ctypes.c_int, (_P, _F, _P)))


def test_launch_counts_are_the_launchers_and_the_budget_grid():
    assert set(_ext.launches) == set(_ext.KERNELS) == {
        "grouped_scan", "grouped_scan_bf16", "grouped_scan_budget", "grouped_scan_budget_bf16",
        "merge_positions", "flat_topk", "rowscale_topk", "rowscale_fold", "exact_topk",
        "chunk_merge", "raw_scores", "packed_topk", "sized_topk", "multi_topk",
        "flat_topk_bf16", "rowscale_topk_bf16", "rowscale_fold_bf16", "exact_topk_bf16",
        "chunk_merge_bf16", "raw_scores_bf16", "packed_topk_bf16", "sized_topk_bf16",
        "multi_topk_bf16", "group_count", "group_scan", "group_scatter", "group_tables"}


# ---------------------------------------------------------------- launch

STREAM = 0x5EED


@pytest.fixture
def fake_lib(monkeypatch):
    """A library of ctypes callbacks typed from the prototypes: launchers
    record their arguments and return `rc["value"]`, body queries answer 0
    (the CUDA-core bodies). Returns (calls, rc, checked outputs)."""
    calls, rc, seen = [], {"value": 0}, []

    def entry(name, restype, argtypes):
        def fn(*args):
            if name.endswith(("_body", "_uses_mma")):
                return 0
            calls.append((name, args))
            return rc["value"]
        return ctypes.CFUNCTYPE(restype, *argtypes)(fn)

    lib = types.SimpleNamespace(**{n: entry(n, *sig) for n, sig in _ext.signatures().items()
                                   if n != "qk_error_string"},
                                qk_error_string=lambda code: b"an error string")
    monkeypatch.setattr(_ext, "lib", lambda: lib)
    monkeypatch.setattr(_ext, "stream_ptr", lambda device: STREAM)
    monkeypatch.setattr(_ext.debug, "check_kernel_outputs",
                        lambda name, *outputs: seen.append((name, outputs)))
    _ext.reset_launches()
    yield calls, rc, seen
    _ext.reset_launches()


def test_launch_passes_pointers_nulls_and_the_stream_last(fake_lib):
    calls, _, seen = fake_lib
    m, out = torch.zeros((4, 256)), torch.zeros((4, 8), dtype=torch.int32)
    _ext.launch("merge_positions", m, out, 4, 256, 8, 256, 0.5, count="exact_topk",
                outputs=(m,))
    assert calls == [("qk_merge_positions", (m.data_ptr(), out.data_ptr(), 4, 256, 8, 256, 0.5,
                                             STREAM))]
    assert _ext.launches["exact_topk"] == 1 and _ext.launches["merge_positions"] == 0
    assert seen == [("exact_topk", (m,))]
    _ext.launch("merge_positions", m, None, 4, 256, 8, 256, 0.5)
    assert calls[-1][1][:2] == (m.data_ptr(), None) and _ext.launches["merge_positions"] == 1


def test_launch_raises_the_launchers_error(fake_lib):
    calls, rc, _ = fake_lib
    rc["value"] = 7
    with pytest.raises(RuntimeError, match=r"merge_positions: CUDA error 7 \(an error string\)"):
        _ext.launch("merge_positions", torch.zeros(4), None, 4, 1, 1, 2, 1.0)
    assert len(calls) == 1 and _ext.launches["merge_positions"] == 0


@pytest.mark.parametrize("extra", [-1, 1])
def test_launch_rejects_a_wrong_argument_count_before_the_call(fake_lib, extra):
    calls, _, _ = fake_lib
    args = [torch.zeros(4), None, 4, 1, 1, 2, 1.0, 3][:7 + extra]
    with pytest.raises(TypeError, match="qk_merge_positions takes 7 arguments"):
        _ext.launch("merge_positions", *args)
    assert calls == [] and _ext.launches["merge_positions"] == 0


# ----------------------------------------- every launch site against the table

Gn, QT, D, P, C, KK = 2, 8, 8, 2, 128, 4


def _site(site, dtype):
    """(call, input tensors, null pointers, launcher name, count name) of one
    launch site on CPU tensors of the codes' dtype."""
    z = torch.zeros
    i32 = dict(dtype=torch.int32)
    gp, gsize = z(Gn, **i32), z(Gn, **i32) + C
    qg, codes = z((Gn, QT, D), dtype=dtype), z((P, C, D), dtype=dtype)
    norms, ids = z((P, C)), z((P, C), **i32)
    ins = (gp, gsize, qg, codes, norms)
    if site in ("grouped_scan", "grouped_scan_budget"):
        budget = site == "grouped_scan_budget"
        return (lambda: grouped_scan.grouped_scan_kernel(gp, gsize, qg, codes, norms, KK, 256,
                                                         1000, budget=budget),
                ins, 0, "grouped_scan", site)
    if site == "merge_positions":
        m = z((4, 256))
        return lambda: grouped_scan.merge_positions(m, KK, 256), (m,), 0, site, site
    if site == "flat_topk":
        codes2d, bias, q = z((C, D), dtype=dtype), z(C), z((4, D), dtype=dtype)
        return (lambda: flat_topk.flat_topk(codes2d, bias, q, KK, "l2"), (codes2d, bias, q), 0,
                site, site)
    if site in ("rowscale_topk", "rowscale_fold"):
        select = "topk" if site == "rowscale_topk" else "fold"
        return (lambda: grouped_family.rowscale_scan(gp, gsize, qg, codes, norms, KK, 256, 1000,
                                                     "l2", select=select),
                ins, 2 if select == "topk" else 0, site, site)
    if site == "rowscale_topk_chunked":
        qsrc, row_off = z(Gn, **i32), z(Gn, **i32)
        return (lambda: grouped_family.rowscale_scan(gp, gsize, qg, codes, norms, KK, 256, 1000,
                                                     "l2", qsrc=qsrc, row_off=row_off, ct=128),
                ins + (qsrc, row_off), 0, "rowscale_topk", "rowscale_topk")
    if site == "exact_topk_slot":
        return (lambda: grouped_exact.exact_scan(gp, qg, codes, KK, "l2", "slot",
                                                 group_size=gsize, norms=norms),
                ins, 1, "exact_topk", "exact_topk")
    if site == "exact_topk_id":
        return (lambda: grouped_exact.exact_scan(gp, qg, codes, KK, "l2", "id", ids=ids),
                (gp, qg, codes, ids), 2, "exact_topk", "exact_topk")
    if site == "chunk_merge":
        return (lambda: grouped_chunked.chunk_merge(gp, gsize, qg, codes, norms, KK, 128, 128,
                                                    1000, "l2"), ins, 0, site, site)
    if site == "sized_topk":
        return (lambda: grouped_variants.sized_topk(gp, gsize, qg, codes, KK, "l2"),
                (gp, gsize, qg, codes), 0, site, site)
    kw = {"multi_topk": dict(gb=2), "raw_scores": {}}.get(site, {})
    args = (gp, qg, codes, ids) + (() if site == "raw_scores" else (KK,))
    return (lambda: getattr(grouped_variants, site)(*args, "l2", **kw), (gp, qg, codes, ids), 0,
            site, site)


SITES = ("grouped_scan", "grouped_scan_budget", "merge_positions", "flat_topk", "rowscale_topk",
         "rowscale_topk_chunked", "rowscale_fold", "exact_topk_slot", "exact_topk_id",
         "chunk_merge", "raw_scores", "sized_topk", "packed_topk", "multi_topk")


@pytest.mark.parametrize("site, dtype", [
    pytest.param(s, d, id=f"{s}-{str(d)[6:]}") for s in SITES
    for d in (torch.float32, torch.bfloat16) if s != "merge_positions" or d == torch.float32])
def test_every_launch_site_passes_its_prototype(fake_lib, monkeypatch, site, dtype):
    """Each wrapper's launch, on CPU tensors taken for the card's: the
    prototype's argument count and types (the callbacks convert each
    argument as a C call would), every input tensor as its pointer, the
    nulls it means, the stream last and one count under its name."""
    calls, _, _ = fake_lib
    for mod in (grouped_scan, flat_topk, grouped_family, grouped_exact, grouped_chunked,
                grouped_variants):
        monkeypatch.setattr(mod, "use_kernel", lambda name, t: True)
    call, inputs, nulls, kernel, count = _site(site, dtype)
    call()
    name = launch_name(kernel, torch.float32 if kernel == "merge_positions" else dtype)
    assert [n for n, _ in calls] == [f"qk_{name}"]
    args = calls[0][1]
    assert len(args) == len(_ext.signatures()[f"qk_{name}"][1]) and args[-1] == STREAM
    assert all(t.data_ptr() in args for t in inputs) and args.count(None) == nulls
    counted = launch_name(count, torch.float32 if count == "merge_positions" else dtype)
    assert {k: v for k, v in _ext.launches.items() if v} == {counted: 1}


# ------------------------------------------------------------ the contract


def test_use_kernel_takes_cuda_runs_cpu_plain_and_rejects_others():
    assert use_kernel("k", torch.zeros(1)) is False
    with pytest.raises(ValueError, match="k: unsupported device meta"):
        use_kernel("k", torch.zeros(1, device="meta"))


def _operands(qg, normsT=None, gp=None):
    gp = torch.zeros(2, dtype=torch.int32) if gp is None else gp
    normsT = torch.zeros((2, 128)) if normsT is None else normsT
    return (("gp", gp, torch.int32, (2,)), ("qg", qg, torch.float32, (2, 8, 16)),
            ("normsT", normsT, torch.float32, (2, 128)))


def test_contract_accepts_a_launch_that_keeps_it():
    cpu = torch.device("cpu")
    check_operands("k", cpu, _operands(torch.zeros((2, 8, 16))), 8, mma=True)
    buf = torch.zeros(2 * 8 * 16 + 4)
    check_operands("k", cpu, _operands(buf[1:257].view(2, 8, 16)), 8)  # no body copies it
    gp = torch.zeros(3, dtype=torch.int32)[1:]
    check_operands("k", cpu, _operands(torch.zeros((2, 8, 16)), gp=gp), 8, mma=True)


@pytest.mark.parametrize("qt", [0, 4, 12, 128])
def test_contract_rejects_an_unserved_query_tile(qt):
    with pytest.raises(ValueError, match=rf"k: qt must be 8, 16, 32 or 64 \(qt={qt}\)"):
        check_operands("k", torch.device("cpu"), _operands(torch.zeros((2, 8, 16))), qt)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device", "missing"])
def test_contract_rejects_a_tensor_that_breaks_it(bad):
    qg = {"dtype": torch.zeros((2, 8, 16), dtype=torch.bfloat16),
          "shape": torch.zeros((2, 8, 17)),
          "strided": torch.zeros((2, 16, 8)).transpose(1, 2),
          "device": torch.zeros((2, 8, 16), device="meta"),
          "missing": None}[bad]
    with pytest.raises(ValueError, match=r"k: qg must be a contiguous torch.float32 "
                                         r"\(2, 8, 16\) tensor on cpu"):
        check_operands("k", torch.device("cpu"), _operands(qg), 8)


def test_contract_rejects_misaligned_operands_of_the_tensor_core_body():
    cpu = torch.device("cpu")
    buf = torch.zeros(2 * 8 * 16 + 4)
    with pytest.raises(ValueError, match="k: qg must start on a 16-byte boundary"):
        check_operands("k", cpu, _operands(buf[1:257].view(2, 8, 16)), 8, mma=True)
    norms = torch.zeros(2 * 128 + 2)
    with pytest.raises(ValueError, match="k: normsT must start on a 8-byte boundary"):
        check_operands("k", cpu, _operands(torch.zeros((2, 8, 16)), norms[1:257].view(2, 128)),
                       8, mma=True)
    check_operands("k", cpu, _operands(torch.zeros((2, 8, 16)), norms[2:258].view(2, 128)), 8,
                   mma=True)
