"""Build, load and count the package's CUDA kernels.

The kernels live in ``csrc/*.cu`` (their shared helpers in ``csrc/*.cuh``)
behind a plain C interface: one ``extern "C"`` launcher per kernel that
takes raw device pointers and a stream and returns ``cudaGetLastError()``.
At first use every source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (K1, K3-K9, sized_topk and multi_topk use
``mma.sync`` TF32 products, on bf16 codes bf16 ones, and bulk tensor
copies; the tensor map's encoder,
``cuTensorMapEncodeTiled``, is looked up in libcuda at run time with
``dlsym``, so only ``-ldl`` is linked); the objects are linked into one
shared library under ``quake_tpu_torch/_build/``, named by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is built or loaded at
import, so the CPU-only tests import every module freely.

``launches`` counts the launches of each kernel (K1 grouped_scan, and on
the budget grid of the masked APS scans grouped_scan_budget, K2
merge_positions, K3 flat_topk, K4 rowscale_topk, K5 rowscale_fold, K6
exact_topk, K7 chunk_merge, K8 raw_scores, K9 packed_topk, and sized_topk and
multi_topk; each but K2 on bf16 codes under its name with ``_bf16`` at the
end). Each of those kernels has a launcher for each dtype, the bf16 one
named with ``_bf16`` (``qk_grouped_scan_bf16``, ``qk_exact_topk_bf16``);
the ``*_body`` queries of K3-K9, sized_topk and multi_topk take the element
size (``elem_bytes``: 4 for f32, 2 for bf16). A wrapper calls
``launched`` where it launches its kernel and
nowhere else, so a run can show that a path went through the kernels; the
count is taken under a lock, as threads may search one index at once, and
in debug mode ``launched`` checks the kernel's floating outputs for NaNs
(debug.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from quake_tpu_torch import debug

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every launcher returns a cudaError_t as int, the
# qk_grouped_scan_uses_mma and qk_*_body entries the body chosen.
_SIGNATURES = {
    # gp, gsize, qg, codes, normsT, out, Gn, qt, D, P, C, kk, slot_mult, levels, fold,
    # stream
    "qk_grouped_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    # the same on bf16 qg and codes
    "qk_grouped_scan_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P),
    # qt, D, fold, kk: whether K1's launcher runs the tensor-core body (f32,
    # bf16 codes)
    "qk_grouped_scan_uses_mma": (_I, _I, _I, _I),
    "qk_grouped_scan_bf16_uses_mma": (_I, _I, _I, _I),
    # qt, D, kk, chunked, elem_bytes: the body K4's launcher runs (2 tensor
    # cores, 1 the persistent chunk-table body, 0 one block a group)
    "qk_rowscale_topk_body": (_I, _I, _I, _I, _I),
    # m_packed, out, B, pool, kfin, lane_mult, 1 / slot_mult, stream
    "qk_merge_positions": (_P, _P, _I, _I, _I, _I, _F, _P),
    # q, codes2d, bias, out, B, N, D, k, is_l2, slot_mult, levels, stream
    "qk_flat_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # N, D, elem_bytes: the body K3's launcher runs (2 tensor cores, scores
    # kept in shared memory; 1 tensor cores, two passes; 0 CUDA cores)
    "qk_flat_topk_body": (_I, _I, _I),
    # gp, gsize, qsrc, row_off (both may be null), qg, codes, norms, out, stats,
    # Gn, qt, D, P, C, kk, is_l2, slot_mult, levels, stream
    "qk_rowscale_topk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _F, _P),
    # the same without qsrc and row_off, with the fold width before the stream
    "qk_rowscale_fold": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                         _P),
    # qt, D, kk, elem_bytes, fold: the body K5's launcher runs (2 tensor
    # cores, 0 CUDA cores)
    "qk_rowscale_fold_body": (_I, _I, _I, _I, _I),
    # gp, gsize, qg, codes, norms, ids (gsize and norms, or ids, may be null),
    # out_s, out_i, Gn, qt, D, P, C, kk, is_l2, id_mode, stream
    "qk_exact_topk": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # qt, D, kk, elem_bytes: the body K6's launcher runs in either mode (1
    # tensor cores, 0 CUDA cores)
    "qk_exact_topk_body": (_I, _I, _I, _I),
    # gp, gsize, qg, codes, norms, out_s, out_i, Gn, qt, D, P, C, ct, kk, is_l2,
    # slot_mult, levels, stream
    "qk_chunk_merge": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    # qt, D, kk, elem_bytes: the body K7's launcher runs (1 tensor cores, 0
    # CUDA cores)
    "qk_chunk_merge_body": (_I, _I, _I, _I),
    # gp, qg, codes, ids, out, Gn, qt, D, P, C, is_l2, stream
    "qk_raw_scores": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # qt, D, elem_bytes: the body K8's launcher runs (1 tensor cores, 0 CUDA
    # cores)
    "qk_raw_scores_body": (_I, _I, _I),
    # gp, qg, codes, ids, out, Gn, qt, D, P, C, kk, is_l2, slot_bits, stream
    "qk_packed_topk": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # qt, D, kk, elem_bytes: the body K9's launcher runs (1 tensor cores, 0
    # CUDA cores)
    "qk_packed_topk_body": (_I, _I, _I, _I),
    # gp, gsize, qg, codes, out_s, out_i, Gn, qt, D, P, C, kk, is_l2, stream
    "qk_sized_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # qt, D, kk, elem_bytes: the body sized_topk's launcher runs (1 tensor
    # cores, 0 CUDA cores)
    "qk_sized_topk_body": (_I, _I, _I, _I),
    # gp, qg, codes, ids, out_s, out_i, Gn, qt, D, P, C, kk, is_l2, gb, stream
    "qk_multi_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # qt, D, kk, elem_bytes: the body multi_topk's launcher runs (1 tensor
    # cores, 0 CUDA cores)
    "qk_multi_topk_body": (_I, _I, _I, _I),
}

# Each launcher of K3-K9, sized_topk and multi_topk has a bf16 twin, its name
# with _bf16, that takes the same arguments on bf16 qg and codes (K1's is
# qk_grouped_scan_bf16, above).
_SIGNATURES.update({f"qk_{k}_bf16": _SIGNATURES[f"qk_{k}"]
                    for k in ("flat_topk", "rowscale_topk", "rowscale_fold", "exact_topk",
                              "chunk_merge", "raw_scores", "packed_topk", "sized_topk",
                              "multi_topk")})

KERNELS = ("grouped_scan", "grouped_scan_bf16", "grouped_scan_budget",
           "grouped_scan_budget_bf16", "merge_positions", "flat_topk", "rowscale_topk",
           "rowscale_fold", "exact_topk", "chunk_merge", "raw_scores", "packed_topk", "sized_topk",
           "multi_topk", "flat_topk_bf16", "rowscale_topk_bf16", "rowscale_fold_bf16",
           "exact_topk_bf16", "chunk_merge_bf16", "raw_scores_bf16", "packed_topk_bf16",
           "sized_topk_bf16", "multi_topk_bf16")
launches = dict.fromkeys(KERNELS, 0)

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in KERNELS:
            launches[name] = 0


def launched(name: str, *outputs) -> None:
    """Count one launch of kernel `name` (a key of `launches`); in debug
    mode, hold its floating outputs to the NaN check."""
    with _count_lock:
        launches[name] += 1
    debug.check_kernel_outputs(name, *outputs)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built at first use on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libquake_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link the library.
    Returns its path; a library already built from the same sources is
    reused."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-ldl", "-o", str(so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.qk_error_string.argtypes = (ctypes.c_int,)
            handle.qk_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def launcher(name: str):
    """The C launcher of the kernel counted as `name` (a key of
    `launches`): qk_`name`, the bf16 twin for a name that ends in _bf16."""
    return getattr(lib(), f"qk_{name}")


def check(rc: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib().qk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
