"""The port's copy of ``cook_tpu/federation/cells.py`` (imports
re-rooted): one federated cell as the router sees it.

A cell is a whole cook_tpu_torch deployment — leader, standbys,
partitions, its own journal and election — reachable at one front URL.  The router
never reaches around that URL: everything it knows about a cell comes
from the wire (``/debug/health`` saturation snapshots, the per-user
summary endpoint, response headers), so a cell can be a single
in-process test server or a real multi-host deployment and the routing
tier cannot tell the difference.

The transport is deliberately raw: the router must see each response's
exact status, headers and body bytes to proxy them through unmodified
(wire parity) and to qualify ``X-Cook-Commit-Offset`` headers — a
convenience client that followed redirects or merged tokens itself
would destroy exactly the information the front door exists to
preserve.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

from ..utils.retry import CircuitBreaker

#: capacity tiers a cell may declare.  ``spot`` capacity is cheap but
#: reclaimable: the router penalizes its score so standard cells absorb
#: steady demand, and a reclaim triggers the mea-culpa re-route path
#: (jobs lose nothing for the platform's decision).
CELL_TIERS = ("standard", "spot")


class CellUnreachable(ConnectionError):
    """The cell did not answer (connect/send/read failure) — recorded
    on the breaker by the caller; distinct from an HTTP error status,
    which IS an answer."""


@dataclass
class CellSpec:
    """Boot-validated declaration of one cell (the ``federation.cells``
    conf entries)."""

    id: str
    url: str
    tier: str = "standard"
    #: data-locality attributes (e.g. ``{"region": "us-east"}``): a job
    #: whose labels pin an attribute routes only to matching cells
    attributes: Dict[str, str] = field(default_factory=dict)
    #: relative capacity weight for load scoring
    weight: float = 1.0

    def __post_init__(self):
        if not self.id or "/" in self.id or "," in self.id:
            # "/" is the token-qualifier separator and "," the vector
            # separator: a cell id containing either would make every
            # session token ambiguous
            raise ValueError(
                f"cell id must be non-empty without '/' or ',', got "
                f"{self.id!r}")
        if not str(self.url).startswith(("http://", "https://")):
            raise ValueError(f"cell {self.id!r} url must be http(s), "
                             f"got {self.url!r}")
        if self.tier not in CELL_TIERS:
            raise ValueError(f"cell {self.id!r} tier must be one of "
                             f"{CELL_TIERS}, got {self.tier!r}")
        if not isinstance(self.attributes, dict):
            raise ValueError(f"cell {self.id!r} attributes must be an "
                             "object of string pairs")
        self.attributes = {str(k): str(v)
                           for k, v in self.attributes.items()}
        if float(self.weight) <= 0:
            raise ValueError(f"cell {self.id!r} weight must be > 0")
        self.weight = float(self.weight)


class CellHandle:
    """Live routing state for one cell: breaker, drain flag, cached
    health snapshot, in-flight counter, and the raw HTTP transport."""

    def __init__(self, spec: CellSpec, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 request_timeout_s: float = 5.0):
        self.spec = spec
        self.breaker = CircuitBreaker(
            f"cell:{spec.id}", failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        #: operator intent: a drained cell takes no NEW demand and its
        #: summary table leaves the global merge (its load was either
        #: finished or re-routed; keeping a tombstone table would
        #: double-count users forever) — the dynamic-cluster drain
        #: contract, one level up
        self.drained = False
        # per-thread keep-alive connections: the front door serves many
        # client threads at once and one shared socket would serialize
        # every proxied exchange behind a lock
        self._local = threading.local()
        self.inflight = 0
        self.routed_total = 0
        self.last_error: Optional[str] = None
        #: last /debug/health snapshot: worst saturation gauge + the
        #: brownout stage, aged so a stale probe decays to "unknown"
        self._health: Dict[str, Any] = {}
        self._health_at = float("-inf")

    # ---------------------------------------------------------- transport
    def _connection(self, scheme: str,
                    netloc: str) -> http.client.HTTPConnection:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        conn = conns.get((scheme, netloc))
        if conn is None:
            cls = http.client.HTTPSConnection if scheme == "https" \
                else http.client.HTTPConnection
            conn = cls(netloc, timeout=self.request_timeout_s)
            conns[(scheme, netloc)] = conn
        return conn

    def _drop_connection(self, scheme: str, netloc: str) -> None:
        conns = getattr(self._local, "conns", None) or {}
        conn = conns.pop((scheme, netloc), None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def request(self, method: str, target: str,
                body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                record: bool = True
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One proxied exchange → ``(status, headers, raw_body)``.

        Raises :class:`CellUnreachable` when the cell never answered;
        records breaker outcomes (an HTTP error status is a SERVED
        answer and counts as transport success — a cell refusing one
        bad request must not trip the whole cell's breaker)."""
        parsed = urlsplit(self.spec.url)
        scheme = parsed.scheme or "http"
        netloc = parsed.netloc
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Length", str(len(body)))
        for attempt in (0, 1):
            conn = self._connection(scheme, netloc)
            try:
                conn.request(method, target, body=body, headers=hdrs)
                resp = conn.getresponse()
                raw = resp.read()
            except (http.client.HTTPException, ConnectionError,
                    BrokenPipeError, OSError) as exc:
                self._drop_connection(scheme, netloc)
                if attempt == 0:
                    # a keep-alive socket the cell closed while idle
                    # is not an outage: one fresh-socket retry
                    continue
                self.last_error = f"{type(exc).__name__}: {exc}"
                if record:
                    self.breaker.record_failure()
                raise CellUnreachable(
                    f"cell {self.spec.id} unreachable: "
                    f"{self.last_error}") from exc
            if record:
                self.breaker.record_success()
                self.last_error = None
            return resp.status, dict(resp.getheaders()), raw
        raise AssertionError("unreachable")  # pragma: no cover

    def get_json(self, path: str,
                 headers: Optional[Dict[str, str]] = None) -> Any:
        status, _, raw = self.request("GET", path, headers=headers)
        if status != 200:
            raise CellUnreachable(
                f"cell {self.spec.id} GET {path} -> {status}")
        return json.loads(raw.decode() or "null")

    # ------------------------------------------------------------- health
    def probe_health(self) -> Optional[Dict[str, Any]]:
        """Refresh the cached ``/debug/health`` snapshot; ``None`` when
        the cell did not answer (the breaker already recorded it)."""
        try:
            doc = self.get_json("/debug/health")
        except (CellUnreachable, ValueError):
            return None
        self._health = doc if isinstance(doc, dict) else {}
        self._health_at = time.monotonic()
        return self._health

    def health_age_s(self) -> float:
        return time.monotonic() - self._health_at

    def saturation(self) -> float:
        """Worst normalized saturation gauge from the last health
        probe; 0.0 when never probed (optimism is safe — the breaker
        catches a cell that cannot even answer)."""
        sat = self._health.get("saturation")
        if isinstance(sat, dict) and sat:
            try:
                return max(float(v) for v in sat.values())
            except (TypeError, ValueError):
                return 0.0
        return 0.0

    def browning_out(self) -> bool:
        """The brownout ladder, read from the cell's own health
        panel: stage >= 3 means the cell is shedding writes — routing
        MORE submissions there would be feeding the fire."""
        stage = self._health.get("admission", {})
        if isinstance(stage, dict):
            try:
                return int(stage.get("brownout_stage", 0)) >= 3
            except (TypeError, ValueError):
                return False
        return False

    # ------------------------------------------------------------ routing
    def eligible(self) -> bool:
        """May NEW demand route here right now?"""
        return (not self.drained) and self.breaker.allow() \
            and not self.browning_out()

    def serving(self) -> bool:
        """Does this cell participate in the global summary merge?
        Drain is the only exclusion: an UNREACHABLE cell stays in the
        merge so its table ages loudly toward the staleness bound
        instead of its users silently vanishing from enforcement."""
        return not self.drained

    def to_doc(self) -> Dict[str, Any]:
        return {
            "id": self.spec.id, "url": self.spec.url,
            "tier": self.spec.tier, "weight": self.spec.weight,
            "attributes": dict(self.spec.attributes),
            "drained": self.drained,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "routed_total": self.routed_total,
            "saturation": round(self.saturation(), 4),
            "browning_out": self.browning_out(),
            "health_age_s": (round(self.health_age_s(), 3)
                             if self._health_at > float("-inf") else None),
            "last_error": self.last_error,
        }
