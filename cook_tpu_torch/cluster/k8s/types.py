"""The port's copy of ``cook_tpu/cluster/k8s/types.py``
(imports re-rooted).

Shared kubernetes-adapter value types (neutral: returned by both the
in-process fake and the live-apiserver adapter)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease subset (holderIdentity, renewTime,
    leaseDurationSeconds, leaseTransitions) — the object behind k8s-native
    leader election.  ``renew_time_s`` is wall-clock epoch seconds (what a
    real apiserver stamps), so electors must compare against a wall clock.
    ``annotations`` carries the coordinated-promotion candidate positions
    (``cook.io/candidate-*``; sched/election.py) next to the holder-url
    annotation real leases already use.
    """

    name: str
    holder: str = ""
    holder_url: str = ""          # carried as an annotation on real leases
    renew_time_s: float = 0.0
    duration_s: float = 15.0
    transitions: int = 0
    annotations: Dict[str, str] = field(default_factory=dict)
