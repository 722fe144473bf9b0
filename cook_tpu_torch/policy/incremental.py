"""The port's copy of ``cook_tpu/policy/incremental.py`` (imports re-rooted).

Incremental configuration: portioned value rollouts.

Mirrors the reference's incremental config plane (reference:
scheduler/src/cook/config_incremental.clj:89-110): a key maps to a list of
{value, portion} entries; a job resolves to one value by hashing its uuid
into [0, 1) and walking the cumulative portions — so "90% old image, 10%
new image" rollouts are stable per job and adjustable without restarts.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple


def _uuid_to_unit_interval(uuid: str) -> float:
    digest = hashlib.sha256(uuid.encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(2**64)


class IncrementalConfig:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._configs: Dict[str, List[Tuple[Any, float]]] = {}

    def set(self, key: str, values: List[Dict[str, Any]]) -> None:
        """values: [{"value": ..., "portion": 0.9}, ...]; portions must sum
        to ~1 (validated like the reference's schema)."""
        self.set_many({key: values})

    def set_many(self, configs: Dict[str, List[Dict[str, Any]]]) -> None:
        """Validate every key, then commit atomically — a rejected request
        must change nothing."""
        validated: Dict[str, List[Tuple[Any, float]]] = {}
        for key, values in configs.items():
            entries = [(v["value"], float(v["portion"])) for v in values]
            total = sum(p for _v, p in entries)
            if entries and abs(total - 1.0) > 1e-6:
                raise ValueError(
                    f"portions for {key} sum to {total}, expected 1")
            validated[key] = entries
        with self._lock:
            self._configs.update(validated)

    def delete(self, key: str) -> None:
        with self._lock:
            self._configs.pop(key, None)

    def resolve(self, key: str, job_uuid: str, default: Any = None) -> Any:
        with self._lock:
            entries = self._configs.get(key)
        if not entries:
            return default
        x = _uuid_to_unit_interval(job_uuid)
        cumulative = 0.0
        for value, portion in entries:
            cumulative += portion
            if x < cumulative:
                return value
        return entries[-1][0]

    def all(self) -> Dict[str, List[Dict[str, Any]]]:
        with self._lock:
            return {k: [{"value": v, "portion": p} for v, p in entries]
                    for k, entries in self._configs.items()}
