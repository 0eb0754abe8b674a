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

The launchers' ctypes types are read from the ``extern "C"`` prototypes of
the same sources (``signatures``), so a launcher changes in one file only.
Each kernel has a launcher for each dtype, the bf16 one named with ``_bf16``
(``qk_grouped_scan_bf16``, ``qk_exact_topk_bf16``); the ``*_body`` queries
of K3-K9, sized_topk and multi_topk take the element size (``elem_bytes``:
4 for f32, 2 for bf16).

``launches`` counts the launches of each kernel (K1 grouped_scan, and on
the budget grid of the masked APS scans grouped_scan_budget, K2
merge_positions, K3 flat_topk, K4 rowscale_topk, K5 rowscale_fold, K6
exact_topk, K7 chunk_merge, K8 raw_scores, K9 packed_topk, and sized_topk and
multi_topk; each but K2 on bf16 codes under its name with ``_bf16`` at the
end; and the grouping prologue's group_count, group_scan, group_scatter and
group_tables, one name for both dtypes). Every wrapper launches through ``launch``, which counts the launch,
so a run can show that a path went through the kernels; the count is taken
under a lock, as threads may search one index at once, and in debug mode the
kernel's floating outputs are checked for NaNs (debug.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from types import MappingProxyType

from quake_tpu_torch import debug

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


# The C types of the launchers' prototypes. Every launcher returns a
# cudaError_t as int, the qk_*_uses_mma and qk_*_body queries the body chosen.
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "const char*": ctypes.c_char_p}
_EXTERN_C = re.compile(r'^extern "C" \{$(.*?)^\}  // extern "C"$', re.S | re.M)
_PRODUCT_ONLY = re.compile(r"^#ifdef QK_PRODUCT_ONLY$.*?^#endif$", re.S | re.M)
_PROTOTYPE = re.compile(r"^([A-Za-z_][\w ]*?\**) *(QK_ENTRY\()?(qk_\w+)\)?\(([^)]*)\)", re.M)


def parse_signatures(source: str, product_only: bool = False) -> dict:
    """C entry -> (restype, argtypes) of every prototype in the extern "C"
    blocks of `source`. QK_ENTRY(qk_x) declares qk_x and its bf16 twin
    qk_x_bf16; what stands under #ifdef QK_PRODUCT_ONLY belongs only to the
    product-only build (a timing aid). A type outside _CTYPES raises."""
    table = {}
    for block in _EXTERN_C.findall(source):
        if not product_only:
            block = _PRODUCT_ONLY.sub("", block)
        for ret, twin, name, params in _PROTOTYPE.findall(re.sub(r"//[^\n]*", "", block)):
            decl = [ret] + [re.fullmatch(r"(.+?) *\w+", p.strip())[1]
                            for p in params.split(",") if p.strip()]
            decl = [re.sub(r" *\*", "*", " ".join(t.split())) for t in decl]
            if any(t not in _CTYPES for t in decl):
                raise ValueError(f"{name}: no ctypes type for {decl} in its prototype")
            sig = (_CTYPES[decl[0]], tuple(_CTYPES[t] for t in decl[1:]))
            table.update({name: sig, **({f"{name}_bf16": sig} if twin else {})})
    return table


@functools.cache
def signatures(product_only: bool = False) -> MappingProxyType:
    """parse_signatures of csrc/*.cu, the sources whose hash names the
    library, so the types are those of the binary (read once a process)."""
    return MappingProxyType(
        parse_signatures("\n".join(src.read_text() for src in _sources()), product_only))


def entry(handle: ctypes.CDLL, name: str, product_only: bool = False):
    """C entry `name` of a loaded library, typed from its prototype (a
    product-only build's entries with product_only)."""
    fn = getattr(handle, name)
    fn.restype, fn.argtypes = signatures(product_only)[name]
    return fn


# The launch counts: each launcher without qk_, and K1 on the budget grid.
KERNELS = tuple(sorted({n[3:] for n in signatures()
                        if not n.endswith(("_body", "_uses_mma")) and n != "qk_error_string"}
                       | {"grouped_scan_budget", "grouped_scan_budget_bf16"}))
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
    """The loaded kernel library (built on first call), every entry typed
    from its prototype."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name in signatures():
                entry(handle, name)
            _lib = handle
    return _lib


def launch(name: str, *args, count: str | None = None, outputs=()) -> None:
    """Launch qk_`name` on the current stream of its first tensor's device:
    a tensor argument passes as its data_ptr(), None as a null pointer, the
    stream last. A count of arguments other than the prototype's raises
    before the call (ctypes passes extra ones unchecked); a CUDA error that
    the launcher reports raises. The launch counts under `count` (default
    `name`), and in debug mode its floating `outputs` are held to the NaN
    check."""
    fn = getattr(lib(), f"qk_{name}")
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"qk_{name} takes {len(fn.argtypes) - 1} arguments and the stream, "
                        f"not {len(args)}")
    device = next(a.device for a in args if hasattr(a, "data_ptr"))
    check(fn(*(a.data_ptr() if hasattr(a, "data_ptr") else a for a in args),
             stream_ptr(device)), name)
    launched(count or name, *outputs)


def check(rc: int, what: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        msg = lib().qk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
