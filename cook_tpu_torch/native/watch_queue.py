"""The port's copy of ``cook_tpu/native/watch_queue.py``: the scheduler's
status shards.

Loads (building on first use, with g++, into ``build/native``, which git
ignores) the repo-root source ``native/watch_queue.cpp`` via ctypes and
exposes :class:`ShardedWatchQueue`: submit(key, event) fan-in, per-key FIFO
processing on parallel shard threads.  Payloads stay on the Python side
(keyed by sequence number); the native layer owns routing, ordering, worker
threads, and flush accounting.

When no C++ toolchain is available the pure-Python :class:`PyWatchQueue`
provides identical semantics (shard threads + per-shard FIFO).  This is
host code: the scheduler's status updates never touch the card.
"""

from __future__ import annotations

import ctypes
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "watch_queue.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
_LIB = _BUILD_DIR / "libwatchqueue.so"

_CALLBACK_T = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_longlong,
                               ctypes.c_void_p)


def _build_library() -> Optional[Path]:
    from .build import build_if_stale
    return build_if_stale([_SRC], _LIB, ["-shared", "-fPIC"],
                          timeout_s=120)


_lib_handle = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_tried
    if _lib_tried:
        return _lib_handle
    _lib_tried = True
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.wq_create.restype = ctypes.c_void_p
    lib.wq_create.argtypes = [ctypes.c_int, _CALLBACK_T, ctypes.c_void_p]
    lib.wq_submit.restype = ctypes.c_int
    lib.wq_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_longlong]
    lib.wq_processed.restype = ctypes.c_longlong
    lib.wq_processed.argtypes = [ctypes.c_void_p]
    lib.wq_pending.restype = ctypes.c_longlong
    lib.wq_pending.argtypes = [ctypes.c_void_p]
    lib.wq_flush.argtypes = [ctypes.c_void_p]
    lib.wq_destroy.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class ShardedWatchQueue:
    """Native-backed sharded in-order executor.

    ``handler(key, payload)`` runs on shard threads; events with equal keys
    run in submission order (reference: ParallelWatchQueue.java semantics).
    """

    def __init__(self, handler: Callable[[str, Any], None],
                 shards: int = 19):
        lib = _load()
        if lib is None:
            raise RuntimeError("native watch queue unavailable "
                               "(no C++ toolchain?)")
        self._lib = lib
        self._handler = handler
        self._payloads: Dict[int, Any] = {}
        self._payload_lock = threading.Lock()
        self._seq = 0
        self._errors: list = []

        def _invoke(key: bytes, seq: int, _user) -> None:
            with self._payload_lock:
                payload = self._payloads.pop(seq, None)
            try:
                self._handler(key.decode(), payload)
            except Exception as e:  # noqa: BLE001 - surfaced via errors()
                self._errors.append(e)

        self._cb = _CALLBACK_T(_invoke)  # keep a reference: ctypes trampoline
        self._handle = lib.wq_create(shards, self._cb, None)
        if not self._handle:
            raise RuntimeError("wq_create failed")

    def submit(self, key: str, payload: Any = None) -> None:
        with self._payload_lock:
            self._seq += 1
            seq = self._seq
            self._payloads[seq] = payload
        rc = self._lib.wq_submit(self._handle, key.encode(), seq)
        if rc != 0:
            with self._payload_lock:
                self._payloads.pop(seq, None)
            raise RuntimeError("submit on closed queue")

    def flush(self) -> None:
        self._lib.wq_flush(self._handle)

    @property
    def processed(self) -> int:
        return int(self._lib.wq_processed(self._handle))

    @property
    def pending(self) -> int:
        return int(self._lib.wq_pending(self._handle))

    def errors(self) -> list:
        return list(self._errors)

    def close(self) -> None:
        if self._handle:
            self._lib.wq_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class PyWatchQueue:
    """Pure-Python fallback with identical semantics."""

    def __init__(self, handler: Callable[[str, Any], None],
                 shards: int = 19):
        self._handler = handler
        self._queues = [queue.Queue() for _ in range(shards)]
        self._stop = threading.Event()
        self._submitted = 0
        self._processed = 0
        self._count_lock = threading.Lock()
        self._flush_cv = threading.Condition(self._count_lock)
        self._errors: list = []
        self._threads = []
        for q in self._queues:
            t = threading.Thread(target=self._run, args=(q,), daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, q: "queue.Queue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            key, payload = item
            try:
                self._handler(key, payload)
            except Exception as e:  # noqa: BLE001
                self._errors.append(e)
            with self._count_lock:
                self._processed += 1
                self._flush_cv.notify_all()

    def submit(self, key: str, payload: Any = None) -> None:
        if self._stop.is_set():
            raise RuntimeError("submit on closed queue")
        with self._count_lock:
            self._submitted += 1
        shard = hash(key) % len(self._queues)
        self._queues[shard].put((key, payload))

    def flush(self) -> None:
        with self._flush_cv:
            self._flush_cv.wait_for(
                lambda: self._processed >= self._submitted)

    @property
    def processed(self) -> int:
        with self._count_lock:
            return self._processed

    @property
    def pending(self) -> int:
        with self._count_lock:
            return self._submitted - self._processed

    def errors(self) -> list:
        return list(self._errors)

    def close(self) -> None:
        self._stop.set()
        for q in self._queues:
            q.put(None)


def make_watch_queue(handler: Callable[[str, Any], None],
                     shards: int = 19):
    """Native when buildable, Python otherwise."""
    if native_available():
        return ShardedWatchQueue(handler, shards)
    return PyWatchQueue(handler, shards)
