"""ctypes bindings for the native resident-id map (idmap.cpp, a copy of the
JAX package's source with the same C ABI).

The shared library is built at first use with ``g++ -O3 -shared -fPIC`` into
``quake_tpu_torch/_build/``, named by a hash of the source and the flags (as
``_ext.py`` names the CUDA library), so an edited source never loads a stale
build. It is compiled to a temporary file and moved into place with
``os.replace``: processes that build at once each write their own file, and
the last rename wins with an identical library. Nothing is built or loaded at
import. Callers check ``native_available()`` and fall back to the dict map
(``storage/idmap.py``) where ``g++`` is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "idmap.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_build_failed = False

_P, _N = ctypes.c_void_p, ctypes.c_int64
# C entry -> (restype, argtypes)
_SIGNATURES = {
    "idmap_create": (ctypes.c_void_p, (_N,)),
    "idmap_destroy": (None, (_P,)),
    "idmap_size": (_N, (_P,)),
    "idmap_set_batch": (_N, (_P, _P, _P, _N)),
    "idmap_get_batch": (None, (_P, _P, _P, _N)),
    "idmap_contains_batch": (None, (_P, _P, _P, _N)),
    "idmap_erase_batch": (_N, (_P, _P, _N)),
    "idmap_items": (_N, (_P, _P, _P)),
    "idmap_rows_of": (_N, (_P, _P, _N, _P)),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libquake_idmap_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile idmap.cpp (once per source and flags) and return the path."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.CalledProcessError):
                _build_failed = True
                return None
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the native map builds and loads here."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeIdMap:
    """int64 id -> int32 partition row, batch-oriented. items() returns the
    keys in the table's slot order, not in insertion order."""

    def __init__(self, initial_capacity: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native id map is unavailable (its g++ build failed)")
        self._lib = lib
        self._h = lib.idmap_create(int(initial_capacity))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.idmap_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.idmap_size(self._h))

    def set_batch(self, keys, values) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype=np.int32)
        return int(self._lib.idmap_set_batch(self._h, _ptr(keys), _ptr(values), len(keys)))

    def get_batch(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(len(keys), dtype=np.int32)
        self._lib.idmap_get_batch(self._h, _ptr(keys), _ptr(out), len(keys))
        return out

    def contains_batch(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(len(keys), dtype=np.uint8)
        self._lib.idmap_contains_batch(self._h, _ptr(keys), _ptr(out), len(keys))
        return out.astype(bool)

    def erase_batch(self, keys) -> int:
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        return int(self._lib.idmap_erase_batch(self._h, _ptr(keys), len(keys)))

    def items(self):
        n = len(self)
        keys = np.empty(n, dtype=np.int64)
        values = np.empty(n, dtype=np.int32)
        written = self._lib.idmap_items(self._h, _ptr(keys), _ptr(values))
        return keys[:written], values[:written]

    def rows_of(self, keys) -> np.ndarray:
        """Distinct partition rows holding any of the given ids, in the order
        of their first id."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        out = np.empty(max(len(keys), 1), dtype=np.int32)
        n = self._lib.idmap_rows_of(self._h, _ptr(keys), len(keys), _ptr(out))
        return out[:n]
