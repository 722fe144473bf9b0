"""Per-kernel launch counters, and event counts.

Each CUDA stage wrapper owns one :class:`LaunchCounter` and adds one to
it where it launches its kernel, and nowhere else: a plain PyTorch run
on the CPU counts nothing.  ``chip_smoke.py`` zeroes every counter, runs
the cycle, and reads them to show the cycle went through the kernels."""

from __future__ import annotations

from typing import Dict


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
