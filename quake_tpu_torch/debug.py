"""Opt-in debug mode: the analog of the reference's sanitizer builds (the
counterpart of quake_tpu/debug.py).

The reference offers opt-in TSAN/ASAN Debug builds (CMakeLists.txt:186-196)
to catch data races and memory errors in the worker pool. The failure
class this package's users meet instead is numerical: a NaN leaking through
a masked lane into a result. Debug mode traps the first NaN at the
operation that produces it, and raises FloatingPointError naming it:

  * ``NanTrap``, a TorchDispatchMode, checks the floating outputs of every
    PyTorch operation that computes new values (views, in-place and out=
    writes, and allocations of uninitialised memory are not checked: their
    contents were checked where they were computed, or are not values yet);
  * the CUDA kernels launch through ctypes, which the dispatch mode does not
    see, so each kernel wrapper checks its own floating outputs as it counts
    its launch (``check_kernel_outputs``, from ``_ext.launched``) and names
    the kernel.

Enable it with QUAKE_TPU_DEBUG=1 in the environment (read when the package
is imported) or by calling enable_debug_mode(). Every check waits for the
device, so debug mode is for finding a fault, never for timing.

The scans legitimately use -inf as the masked-lane and empty-result
sentinel, so infs stay allowed; trap_infs=True or QUAKE_TPU_DEBUG_INFS=1
traps them too (meaningful only on unmasked paths).

PyTorch keeps dispatch modes per thread. enable_debug_mode() pushes a trap
on the calling thread, and disable_debug_mode() pops the calling thread's
trap. The kernel checks, and whether any pushed trap checks at all, follow
one process-wide switch: after disable_debug_mode() no thread checks
anything, and a trap still on another thread's stack (one that enabled
debug mode and has not disabled it) passes every operation through
unchecked until that thread calls disable_debug_mode().
"""

from __future__ import annotations

import os
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Factories whose output is uninitialised memory, and in-place resizing.
_UNINITIALISED = frozenset(("aten::empty", "aten::empty_like", "aten::empty_strided",
                            "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
                            "aten::set_"))

_lock = threading.Lock()
_state = {"on": False, "trap_infs": False}
_traps: dict[int, "NanTrap"] = {}  # thread ident -> the trap it pushed


def enabled() -> bool:
    return _state["on"]


def _floating(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _floating(o)


def _check(what: str, out) -> None:
    for t in _floating(out):
        if t.numel() == 0:
            continue
        if bool(torch.isnan(t).any()):
            raise FloatingPointError(f"debug mode: {what} produced a NaN "
                                     f"(shape {tuple(t.shape)}, {t.dtype}, on {t.device})")
        if _state["trap_infs"] and bool(torch.isinf(t).any()):
            raise FloatingPointError(f"debug mode: {what} produced an inf "
                                     f"(shape {tuple(t.shape)}, {t.dtype}, on {t.device})")


def check_kernel_outputs(name: str, *outputs) -> None:
    """In debug mode, raise FloatingPointError where a kernel's floating
    output holds a NaN (or an inf, where infs are trapped)."""
    if _state["on"]:
        _check(f"kernel {name}", outputs)


class NanTrap(TorchDispatchMode):
    """Checks the floating outputs of every value-computing operation while
    debug mode is on (see the module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if (_state["on"] and not func.is_view and not schema.is_mutable
                and schema.name not in _UNINITIALISED):
            _check(f"operation {func}", out)
        return out


def enable_debug_mode(trap_infs: bool | None = None) -> None:
    """Turn the checks on for every thread, and push a trap on the calling
    thread (once; a second call only updates trap_infs)."""
    if trap_infs is None:
        trap_infs = os.environ.get("QUAKE_TPU_DEBUG_INFS", "") == "1"
    with _lock:
        _state["trap_infs"] = bool(trap_infs)
        _state["on"] = True
        me = threading.get_ident()
        if me not in _traps:
            trap = NanTrap()
            trap.__enter__()
            _traps[me] = trap


def disable_debug_mode() -> None:
    """Turn the checks off for every thread, and pop the calling thread's
    trap."""
    with _lock:
        _state["on"] = False
        _state["trap_infs"] = False
        trap = _traps.pop(threading.get_ident(), None)
    if trap is not None:
        trap.__exit__(None, None, None)


if os.environ.get("QUAKE_TPU_DEBUG", "") == "1":  # pragma: no cover
    enable_debug_mode()
