"""Per-kernel launch counters, event counts, and the dispatch paths'
transfer and sync-wait accounting.

Each CUDA stage wrapper owns one :class:`LaunchCounter` and adds one to
it where it launches its kernel, and nowhere else: a plain PyTorch run
on the CPU counts nothing.  ``chip_smoke.py`` zeroes every counter, runs
the cycle, and reads them to show the cycle went through the kernels.

:func:`count_transfer`, :func:`sync_wait` and :func:`profile_upload` are
the port of ``cook_tpu/ops/telemetry.py``'s (:94-133): they feed the
metrics registry and the active cycle's flight record, and the first
also counts ``transfer.<direction>`` here.  The reference's
``instrument_jit`` counts JIT recompiles; the port compiles nothing per
shape, so it has no counterpart.  :func:`enable_compilation_cache` is
the counterpart of the reference's (:137-160): the port's one compile
is nvcc's build of the kernels' library, so the cache is the directory
that library is built in and loaded from."""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict

from ..utils.flight import recorder
from ..utils.metrics import registry


class LaunchCounter:
    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1


COUNTERS: Dict[str, LaunchCounter] = {}
# Event counts beside the launch counters: resident repacks by reason,
# delta rows, host-to-device bytes.
EVENTS: Dict[str, int] = {}


def counter(name: str) -> LaunchCounter:
    c = COUNTERS.get(name)
    if c is None:
        c = COUNTERS[name] = LaunchCounter(name)
    return c


def reset_all() -> None:
    for c in COUNTERS.values():
        c.count = 0
    EVENTS.clear()


def snapshot() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def count(name: str, n: int = 1) -> None:
    EVENTS[name] = EVENTS.get(name, 0) + int(n)


def events() -> Dict[str, int]:
    return dict(EVENTS)


def count_transfer(direction: str, nbytes: int) -> None:
    """Record ``nbytes`` crossing the host<->device boundary (direction
    ``h2d`` or ``d2h``)."""
    if nbytes:
        registry.counter_inc("cook_device_transfer_bytes", float(nbytes),
                             {"direction": direction})
        recorder.note_transfer(direction, nbytes)
        count(f"transfer.{direction}", nbytes)


@contextmanager
def sync_wait(kind: str = "fetch"):
    """Time a block that waits on the device: observed on
    ``cook_sync_wait_seconds{kind=}`` and summed into the cycle record's
    sync_wait_ms."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        registry.observe("cook_sync_wait_seconds", dt, {"kind": kind})
        recorder.note_sync_wait(dt)


def profile_upload(stage_ms: float, tensors) -> None:
    """``COOK_PROFILE_UPLOAD=1`` debug probe of the dispatch path: wait
    for the staged inputs to land on the device and print the stage and
    upload times."""
    if not os.environ.get("COOK_PROFILE_UPLOAD"):
        return
    import torch
    t0 = time.perf_counter()
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    print(f"[profile] stage={stage_ms}ms upload="
          f"{(time.perf_counter() - t0) * 1e3:.0f}ms "
          f"({nbytes / 1e6:.1f}MB)", file=sys.stderr)


def enable_compilation_cache(path: str) -> bool:
    """Build the kernels' library into ``path`` (created if missing) and
    load it from there (``ops/cuda_lib.BUILD_DIR``): the library is
    named by a hash of its sources and flags, so a restarted node, or a
    failover successor sharing the directory, loads the library a
    predecessor built instead of running nvcc again.  Returns True when
    the directory is in use; False (never raises) when ``path`` is
    empty or cannot be created, and the default ``build/cuda`` stays.
    A library this process has already loaded stays loaded."""
    if not path:
        return False
    from pathlib import Path

    from . import cuda_lib
    try:
        target = Path(path).expanduser().resolve()
        target.mkdir(parents=True, exist_ok=True)
    except OSError:
        return False
    cuda_lib.BUILD_DIR = target
    return True
