"""The ctypes binding for the native pack kernels (the port of
``cook_tpu/native/pack.py``), over the repo-root ``native/pack.cpp``,
which g++ builds into ``build/native/libcookpack.so`` on first use.

Three host-side array passes of the cycle:

* ``pack_diff`` — the resident wire's delta extraction: positions where
  the freshly staged rows/flags differ from the host shadow (the
  scatter batch shipped to the device; ``sched/fused.sync_resident``);
* ``order_merge`` — the columnar index's order-cache repair: sorted
  deletes + inserts across the four parallel order arrays in one native
  pass (``state/index.py``);
* ``prune_rows`` — the post-match apply: drop launched/conflicted
  positions from the published queue's row list
  (``FusedCycleDriver._apply_pool``).

Each takes the C++ library when g++ built it and the numpy branch of
``ops/delta.py`` otherwise, as the JAX package does; the two branches
return the same arrays.  :func:`numpy_branch` forces the numpy branch
inside its block (a host-code choice, for measuring the two in turns).
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops import delta as _numpy

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "pack.cpp"
_LIB = _REPO_ROOT / "build" / "native" / "libcookpack.so"

_lib_handle = None
_lib_tried = False
_forced_numpy = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_tried
    if _forced_numpy:
        return None
    if _lib_tried:
        return _lib_handle
    _lib_tried = True
    from .build import build_if_stale
    path = build_if_stale([_SRC], _LIB, ["-shared", "-fPIC"], timeout_s=120)
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.cpk_diff_pack.restype = ctypes.c_long
    lib.cpk_diff_pack.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_long, ctypes.c_void_p]
    lib.cpk_order_merge.restype = ctypes.c_long
    lib.cpk_order_merge.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_long]
        + [ctypes.c_void_p, ctypes.c_long]
        + [ctypes.c_void_p] * 5 + [ctypes.c_long]
        + [ctypes.c_void_p] * 4)
    lib.cpk_prune_rows.restype = ctypes.c_long
    lib.cpk_prune_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    """True when libcookpack built (g++ present) and the numpy branch is
    not forced; the numpy branches keep every caller working without
    it."""
    return _load() is not None


@contextlib.contextmanager
def numpy_branch():
    """Run the block on the numpy branches (not thread-scoped: the
    whole process takes them while the block runs)."""
    global _forced_numpy
    prev, _forced_numpy = _forced_numpy, True
    try:
        yield
    finally:
        _forced_numpy = prev


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


# ------------------------------------------------------------------ diff
def pack_diff(rows_old: np.ndarray, rows_new: np.ndarray,
              flags_old: np.ndarray, flags_new: np.ndarray) -> np.ndarray:
    """Flat positions (i32) where (rows, flags) differ — the resident
    pack's scatter batch.  Inputs are same-shape i32 / u8 arrays (any
    shape; compared raveled)."""
    lib = _load()
    if lib is None:
        return _numpy.pack_diff(rows_old, rows_new, flags_old, flags_new)
    ro = np.ascontiguousarray(rows_old, dtype=np.int32).ravel()
    rn = np.ascontiguousarray(rows_new, dtype=np.int32).ravel()
    fo = np.ascontiguousarray(flags_old, dtype=np.uint8).ravel()
    fn = np.ascontiguousarray(flags_new, dtype=np.uint8).ravel()
    n = ro.size
    out = np.empty(n, dtype=np.int32)
    k = lib.cpk_diff_pack(_ptr(ro), _ptr(rn), _ptr(fo), _ptr(fn),
                          ctypes.c_long(n), _ptr(out))
    return out[:k].copy()


# ----------------------------------------------------------- order merge
def order_merge(kb: np.ndarray, st: np.ndarray, uid: np.ndarray,
                rows: np.ndarray, del_pos: np.ndarray, ins_pos: np.ndarray,
                akb: Optional[np.ndarray], ast: Optional[np.ndarray],
                auid: Optional[np.ndarray], arows: Optional[np.ndarray],
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Apply sorted deletes (positions into the original arrays) and
    inserts (np.insert semantics against the post-delete array) to the
    four parallel order-cache arrays.  ``kb``/``akb`` are fixed-width
    byte-string arrays (S-dtype)."""
    lib = _load()
    if lib is None:
        return _numpy.order_merge(kb, st, uid, rows, del_pos, ins_pos,
                                  akb, ast, auid, arows)
    na = len(ins_pos) if akb is not None else 0
    nd = len(del_pos)
    n = len(rows)
    knb = kb.dtype.itemsize
    m = n - nd + na
    out_kb = np.empty(m, dtype=kb.dtype)
    out_st = np.empty(m, dtype=np.int64)
    out_uid = np.empty(m, dtype=np.int32)
    out_rows = np.empty(m, dtype=np.int64)
    if na:
        akb = np.ascontiguousarray(akb)
        ast = np.ascontiguousarray(ast, dtype=np.int64)
        auid = np.ascontiguousarray(auid, dtype=np.int32)
        arows = np.ascontiguousarray(arows, dtype=np.int64)
        ins_pos = np.ascontiguousarray(ins_pos, dtype=np.int64)
    kb = np.ascontiguousarray(kb)
    st = np.ascontiguousarray(st, dtype=np.int64)
    uid = np.ascontiguousarray(uid, dtype=np.int32)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    del_pos = np.ascontiguousarray(del_pos, dtype=np.int64)
    got = lib.cpk_order_merge(
        _ptr(kb), _ptr(st), _ptr(uid), _ptr(rows),
        ctypes.c_long(n), ctypes.c_long(knb),
        _ptr(del_pos), ctypes.c_long(nd),
        _ptr(ins_pos) if na else None,
        _ptr(akb) if na else None, _ptr(ast) if na else None,
        _ptr(auid) if na else None, _ptr(arows) if na else None,
        ctypes.c_long(na),
        _ptr(out_kb), _ptr(out_st), _ptr(out_uid), _ptr(out_rows))
    if got != m:
        raise RuntimeError(f"cpk_order_merge wrote {got} rows, want {m}")
    return out_kb, out_st, out_uid, out_rows


# ------------------------------------------------------------ apply side
def prune_rows(rows: np.ndarray, drop_pos: np.ndarray) -> np.ndarray:
    """``rows`` (i32) minus the entries at ``drop_pos`` (sorted unique
    positions) — the published queue's launched/conflicted prune."""
    lib = _load()
    if lib is None or not len(drop_pos):
        return _numpy.prune_rows(rows, drop_pos)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    drop = np.ascontiguousarray(drop_pos, dtype=np.int64)
    out = np.empty(len(rows), dtype=np.int32)
    k = lib.cpk_prune_rows(_ptr(rows), ctypes.c_long(len(rows)),
                           _ptr(drop), ctypes.c_long(len(drop)), _ptr(out))
    return out[:k].copy()
