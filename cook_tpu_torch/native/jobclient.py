"""The port's copy of ``cook_tpu/native/jobclient.py``: it builds the
repo-root source unchanged, with g++, into ``build/native`` (which git
ignores), under a private name that it renames into place.

ctypes binding for the native job client (``native/jobclient.cpp``).

The reference's programmatic embedding surface is the Java jobclient
(reference: jobclient/java/.../JobClient.java — batched submit/query/abort,
retry, JobListener poll loop, impersonation, basic auth).  This build's
native equivalent is ``libcookjobclient.so``: a dependency-free C++
HTTP/1.1 client any C/C++ program can link, bound here for Python use and
for the test suite.  The pure-Python :class:`cook_tpu_torch.client.JobClient`
remains the ergonomic Python surface; this class proves and exercises the
native one.

Builds the library on first use (same pattern as watch_queue.py); raises
:class:`RuntimeError` when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "jobclient.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
_LIB = _BUILD_DIR / "libcookjobclient.so"

_STATUS_CB_T = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
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
    lib.cjc_create.restype = ctypes.c_void_p
    lib.cjc_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_char_p]
    lib.cjc_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("cjc_set_basic_auth",):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    for fn in ("cjc_set_bearer", "cjc_set_impersonate"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cjc_last_error.restype = ctypes.c_char_p
    lib.cjc_last_error.argtypes = [ctypes.c_void_p]
    lib.cjc_free.argtypes = [ctypes.c_void_p]
    lib.cjc_request.restype = ctypes.c_int
    lib.cjc_request.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_void_p)]
    lib.cjc_submit.restype = ctypes.c_int
    lib.cjc_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_void_p)]
    lib.cjc_submit2.restype = ctypes.c_int
    lib.cjc_submit2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_void_p)]
    lib.cjc_group_query.restype = ctypes.c_int
    lib.cjc_group_query.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_void_p)]
    for fn in ("cjc_query", "cjc_kill", "cjc_group_kill"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_void_p)]
    lib.cjc_retry.restype = ctypes.c_int
    lib.cjc_retry.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.cjc_wait.restype = ctypes.c_int
    lib.cjc_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_long, ctypes.c_long,
                             ctypes.POINTER(ctypes.c_void_p),
                             ctypes.POINTER(ctypes.c_int)]
    lib.cjc_listen.restype = ctypes.c_void_p
    lib.cjc_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_long, _STATUS_CB_T, ctypes.c_void_p]
    lib.cjc_listen_stop.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeJobClientError(RuntimeError):
    def __init__(self, message: str, status: int = -1, body: str = ""):
        super().__init__(message)
        self.status = status
        self.body = body


class NativeJobClient:
    """Python handle over ``libcookjobclient.so``."""

    def __init__(self, host: str, port: int, user: str = "default",
                 basic_auth: Optional[Tuple[str, str]] = None,
                 bearer: Optional[str] = None,
                 impersonate: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native jobclient unavailable (no g++?)")
        self._lib = lib
        self._h = lib.cjc_create(host.encode(), port, user.encode())
        if basic_auth:
            lib.cjc_set_basic_auth(self._h, basic_auth[0].encode(),
                                   basic_auth[1].encode())
        if bearer:
            lib.cjc_set_bearer(self._h, bearer.encode())
        if impersonate:
            lib.cjc_set_impersonate(self._h, impersonate.encode())
        self._listeners: List[ctypes.c_void_p] = []
        self._cb_refs: List[object] = []  # keep callbacks alive

    def close(self) -> None:
        if self._h is not None:
            for lh in self._listeners:
                self._lib.cjc_listen_stop(lh)
            self._listeners.clear()
            self._lib.cjc_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- plumbing
    def _take(self, out: ctypes.c_void_p) -> str:
        if not out.value:
            return ""
        try:
            return ctypes.cast(out, ctypes.c_char_p).value.decode()
        finally:
            self._lib.cjc_free(out)

    def _check(self, status: int, body: str, ok=(200, 201)) -> None:
        if status < 0:
            raise NativeJobClientError(
                self._lib.cjc_last_error(self._h).decode() or
                "transport error", status, body)
        if status not in ok:
            raise NativeJobClientError(
                f"HTTP {status}: {body[:200]}", status, body)

    def request(self, method: str, path: str, body: str = "") -> Tuple[int, str]:
        out = ctypes.c_void_p()
        status = self._lib.cjc_request(self._h, method.encode(),
                                       path.encode(), body.encode(),
                                       ctypes.byref(out))
        return status, self._take(out)

    # ---------------------------------------------------------------- api
    def submit(self, jobs: List[Dict], pool: Optional[str] = None,
               groups: Optional[List[Dict]] = None) -> List[str]:
        out = ctypes.c_void_p()
        if groups:
            status = self._lib.cjc_submit2(
                self._h, json.dumps(jobs).encode(),
                json.dumps(groups).encode(), (pool or "").encode(),
                ctypes.byref(out))
        else:
            status = self._lib.cjc_submit(
                self._h, json.dumps(jobs).encode(), (pool or "").encode(),
                ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body)["jobs"]

    def group(self, uuids: Sequence[str],
              detailed: bool = False) -> List[Dict]:
        """Group query (reference: the Java client's Group support)."""
        out = ctypes.c_void_p()
        status = self._lib.cjc_group_query(
            self._h, ",".join(uuids).encode(), 1 if detailed else 0,
            ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body)

    def kill_groups(self, uuids: Sequence[str]) -> Dict:
        out = ctypes.c_void_p()
        status = self._lib.cjc_group_kill(
            self._h, ",".join(uuids).encode(), ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body) if body else {}

    def query(self, uuids: Sequence[str]) -> List[Dict]:
        out = ctypes.c_void_p()
        status = self._lib.cjc_query(self._h, ",".join(uuids).encode(),
                                     ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body)

    def kill(self, uuids: Sequence[str]) -> Dict:
        out = ctypes.c_void_p()
        status = self._lib.cjc_kill(self._h, ",".join(uuids).encode(),
                                    ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body) if body else {}

    def retry(self, uuid: str, retries: int) -> Dict:
        out = ctypes.c_void_p()
        status = self._lib.cjc_retry(self._h, uuid.encode(), retries,
                                     ctypes.byref(out))
        body = self._take(out)
        self._check(status, body)
        return json.loads(body) if body else {}

    def wait(self, uuids: Sequence[str], timeout_s: float = 300.0,
             poll_s: float = 0.2) -> List[Dict]:
        out = ctypes.c_void_p()
        done = ctypes.c_int(0)
        status = self._lib.cjc_wait(self._h, ",".join(uuids).encode(),
                                    int(timeout_s * 1000),
                                    int(poll_s * 1000),
                                    ctypes.byref(out), ctypes.byref(done))
        body = self._take(out)
        self._check(status, body)
        if not done.value:
            raise TimeoutError(f"jobs not completed within {timeout_s}s")
        return json.loads(body)

    def listen(self, uuids: Sequence[str],
               callback: Callable[[str, str], None],
               interval_s: float = 0.2) -> None:
        """Invoke ``callback(uuid, state)`` on every state change of the
        tracked jobs (reference: JobClient.java JobListener loop)."""

        @_STATUS_CB_T
        def cb(uuid_b, state_b, _arg):
            try:
                callback(uuid_b.decode(), state_b.decode())
            except Exception:
                pass  # never let Python exceptions cross the C boundary

        self._cb_refs.append(cb)
        lh = self._lib.cjc_listen(self._h, ",".join(uuids).encode(),
                                  int(interval_s * 1000), cb, None)
        self._listeners.append(lh)
