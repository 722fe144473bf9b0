"""The port's copy of ``cook_tpu/sched/admission.py`` (imports re-rooted).

Monitor-driven adaptive admission + saturation-driven brownout.

The serving plane's overload ladder (docs/DEPLOY.md "overload runbook").
Each monitor sweep feeds the six ``cook_saturation{resource=}`` gauges
(sched/fleet.py — the saturation input contract) into
:class:`AdmissionController.decide`, which maintains:

* a **0-1 admission level** with hysteresis: the worst gauge past
  ``engage_saturation`` walks the level down (faster the deeper the
  overload — DAGOR-style feedback admission, Zhou et al., SoCC'18);
  below ``release_saturation`` it recovers by ``recover_step`` per
  sweep; the band between is a dead zone so the level never flaps at
  the threshold.  The level directly scales the front-door token-bucket
  refill rates (policy/rate_limit.py ``set_refill_scale``), so admitted
  load tracks what the control plane can actually digest.
* a **brownout stage ladder**, strictly ordered so the shed order is
  provably monotone (the metastable-failure guard of Bronson et al.,
  HotOS'21 — sustained retries against a saturated core are what turn
  overload into outage):

  ====  ===================  ==========================================
  stage name                 what sheds
  ====  ===================  ==========================================
  0     none                 nothing
  1     shed-observability   advisory audit flush folds, slow-ring
                             request capture off (the cardinality-
                             guard idiom: detail first, signal last)
  2     stale-reads          follower min-offset wait gate relaxed —
                             reads serve bounded-stale with honest
                             ``X-Cook-Replication-Age-Ms``
  3     shed-writes          low-priority submissions 429 at the front
                             door
  ====  ===================  ==========================================

  Committed writes and scheduling decisions degrade last or NEVER:
  no stage touches the journal, group commit, or the match cycle.

Escalation is immediate (a jump past two thresholds engages both
stages — actions are nested ``stage >= k`` checks, so order holds);
de-escalation steps down ONE stage per ``stage_hold_seconds`` of
sustained recovery.  Every stage flip is journaled through the store's
dynamic-config plane (``configs/admission`` rides ordinary ``"w"``
journal records, replicates to standbys, and replays at promotion), so
a leader killed mid-brownout comes back AT ITS STAGE instead of
naively re-admitting the overload that killed it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..utils import tracing
from ..utils.metrics import MetricsRegistry
from ..utils.metrics import registry as default_registry

#: stage index -> wire name (journal doc, /debug/health, gauges docs)
STAGE_NAMES = ("none", "shed-observability", "stale-reads", "shed-writes")

#: the dynamic-config document key stage flips are journaled under
CONFIG_KEY = "admission"


class AdmissionController:
    """One per leader scheduler (the monitor sweep drives
    :meth:`decide`); followers never run one — they read the journaled
    stage off their replicated ``configs`` table (rest/api.py)."""

    def __init__(self, store, config,
                 rate_limits=None,
                 ip_limiter=None,
                 registry: Optional[MetricsRegistry] = None,
                 request_obs=None):
        self.store = store
        self.config = config
        self.ac = config.admission
        self.registry = registry if registry is not None else \
            default_registry
        self.rate_limits = rate_limits
        self.ip_limiter = ip_limiter
        # serving-plane capture rings (rest/instrument.py); default to
        # the module singleton the API serves /debug/requests from
        if request_obs is None:
            from ..rest.instrument import request_log
            request_obs = request_log
        self.request_obs = request_obs
        self.level = 1.0
        self.stage = 0
        self.worst_resource: Optional[str] = None
        self.worst_value = 0.0
        # recovery dwell bookkeeping: ms timestamp since when the level
        # has held above the CURRENT stage's engage threshold
        self._above_since_ms: Optional[int] = None
        # bounded flip history for /debug/health + the golden ordering
        # test (oldest dropped)
        self.transitions: List[Dict] = []
        self.restore()

    # ------------------------------------------------------------- clock
    def _now_ms(self) -> int:
        clock = getattr(self.store, "clock", None)
        if callable(clock):
            return int(clock())
        return int(time.time() * 1000)

    # ----------------------------------------------------------- restore
    def restore(self) -> None:
        """Recover the journaled admission state (leader promotion /
        process restart): the dynamic-config document replayed off the
        journal IS the brownout state — re-apply its side effects so a
        leader killed mid-brownout resumes shedding at its stage."""
        doc = None
        try:
            doc = self.store.dynamic_config(CONFIG_KEY)
        except Exception:
            doc = None
        if doc:
            try:
                self.level = min(max(float(doc.get("level", 1.0)), 0.0),
                                 1.0)
                self.stage = min(max(int(doc.get("stage", 0)), 0),
                                 len(STAGE_NAMES) - 1)
            except (TypeError, ValueError):
                self.level, self.stage = 1.0, 0
        self._apply_level()
        self._apply_stage()
        self._publish()

    # ------------------------------------------------------------ decide
    def decide(self, saturation: Dict[str, float]) -> Dict:
        """One control-loop step off this sweep's saturation gauges.
        Returns the post-step state dict (tests, structured logging)."""
        if saturation:
            self.worst_resource, self.worst_value = max(
                saturation.items(), key=lambda kv: kv[1])
        else:
            self.worst_resource, self.worst_value = None, 0.0
        with tracing.span("admission.decide",
                          worst=self.worst_resource or "",
                          saturation=round(self.worst_value, 4)):
            prev_stage = self.stage
            self._step_level(self.worst_value)
            self._apply_level()
            self._step_stage()
            if self.stage != prev_stage:
                self._flip(prev_stage)
            self._publish()
        return self.state()

    def _step_level(self, worst: float) -> None:
        ac = self.ac
        if worst >= ac.engage_saturation:
            # deeper overload sheds faster, but even AT the threshold a
            # quarter-step applies — a gauge pinned exactly at engage
            # must not be a stable no-op
            span = max(1.0 - ac.engage_saturation, 1e-9)
            severity = min((worst - ac.engage_saturation) / span, 1.0)
            self.level = max(
                ac.level_floor,
                self.level - ac.decrease_step * max(severity, 0.25))
        elif worst < ac.release_saturation:
            self.level = min(1.0, self.level + ac.recover_step)
        # else: the hysteresis dead zone [release, engage) — hold

    def _apply_level(self) -> None:
        """The level IS the refill scale: every adaptive front-door
        bucket replenishes at level * configured rate (launch tokens are
        a saturation INPUT, not an output — scaling them would close a
        feedback loop through the matcher)."""
        for limiter in self._scaled_limiters():
            limiter.set_refill_scale(self.level)

    def _scaled_limiters(self):
        out = []
        rl = self.rate_limits
        if rl is not None and hasattr(rl.job_submission,
                                      "set_refill_scale"):
            out.append(rl.job_submission)
        if self.ip_limiter is not None and hasattr(self.ip_limiter,
                                                   "set_refill_scale"):
            out.append(self.ip_limiter)
        return out

    def _target_stage(self) -> int:
        ac = self.ac
        if self.level < ac.shed_writes_level:
            return 3
        if self.level < ac.stale_reads_level:
            return 2
        if self.level < ac.observability_shed_level:
            return 1
        return 0

    def _step_stage(self) -> None:
        target = self._target_stage()
        now = self._now_ms()
        if target >= self.stage:
            # escalation (or holding): immediate, dwell resets
            self.stage = target
            self._above_since_ms = None
            return
        # de-escalation: one stage per stage_hold_seconds of SUSTAINED
        # recovery — a brief dip below the overload must not whipsaw
        # the shed surface back on (that retry stampede is the exact
        # metastable trigger the ladder exists to break)
        if self._above_since_ms is None:
            self._above_since_ms = now
            return
        if now - self._above_since_ms >= self.ac.stage_hold_seconds * 1000:
            self.stage -= 1
            self._above_since_ms = now

    # ------------------------------------------------- storage escalation
    def force_shed_writes(self, reason: str) -> None:
        """Jump straight to stage 3 (shed-writes) outside the saturation
        loop — the storage plane's ENOSPC clean-abort path
        (state/store.py ``StorageFullError``).  A full disk is not a
        load problem the level feedback can see, but the remedy is the
        same shed surface: stop admitting low-priority writes before
        retries hammer a journal that cannot append.  The level is
        pinned below ``shed_writes_level`` so :meth:`_step_stage` holds
        the stage; normal dwell-gated recovery applies once appends
        succeed again (and a still-full disk re-forces on the next
        failed write).  The journaled flip is best-effort by
        construction — the disk that triggered this is the same disk
        the flip record would land on."""
        if self.stage >= 3:
            return
        prev_stage = self.stage
        self.stage = 3
        self.level = min(self.level,
                         max(self.ac.level_floor,
                             self.ac.shed_writes_level - 1e-6))
        self._above_since_ms = None
        self.worst_resource = reason
        self._apply_level()
        self._flip(prev_stage)
        self._publish()

    # -------------------------------------------------------- stage flip
    def _flip(self, prev_stage: int) -> None:
        now = self._now_ms()
        self._apply_stage()
        flip = {"from": prev_stage, "to": self.stage,
                "from_name": STAGE_NAMES[prev_stage],
                "to_name": STAGE_NAMES[self.stage],
                "level": round(self.level, 4),
                "worst": self.worst_resource,
                "ts_ms": now}
        self.transitions.append(flip)
        del self.transitions[:-64]
        # journal the flip through the dynamic-config plane: an ordinary
        # "w" record — fsynced, replicated, replayed at promotion — so
        # failover recovers the stage without a new journal record kind
        try:
            self.store.update_dynamic_config(CONFIG_KEY, {
                "stage": self.stage,
                "stage_name": STAGE_NAMES[self.stage],
                "level": round(self.level, 4),
                "changed_ms": now,
                "worst": self.worst_resource})
        except Exception:
            # a fenced/deposed leader can't journal; the in-memory stage
            # still applies locally and the NEXT leader re-derives
            pass

    def _apply_stage(self) -> None:
        """Re-apply the current stage's shed side effects (idempotent;
        also the restore path).  Stage actions are nested ``>= k``
        checks, so a multi-threshold jump engages every stage below it
        and the shed order stays monotone by construction."""
        shed_obs = self.stage >= 1
        from ..state.partition import substores
        for shard in substores(self.store):
            audit = getattr(shard, "audit", None)
            if audit is not None:
                audit.shed_advisory = shed_obs
        obs = self.request_obs
        if obs is not None:
            obs.capture = not shed_obs

    # ----------------------------------------------------------- surface
    def _publish(self) -> None:
        self.registry.gauge_set("cook_admission_level",
                                round(self.level, 4))
        self.registry.gauge_set("cook_brownout_stage", float(self.stage))

    def state(self) -> Dict:
        """The /debug/health "admission" block (also what tests poll)."""
        return {
            "enabled": bool(self.ac.enabled),
            "level": round(self.level, 4),
            "stage": self.stage,
            "stage_name": STAGE_NAMES[self.stage],
            "worst_resource": self.worst_resource,
            "worst_saturation": round(self.worst_value, 4),
            "transitions": list(self.transitions[-8:]),
        }


def stage_from_store(store) -> int:
    """The journaled brownout stage as visible in ``store`` — the
    follower-side read (the ``configs`` table replicates like any other
    entity state, so standbys see flips at replication latency)."""
    try:
        doc = store.dynamic_config(CONFIG_KEY)
    except Exception:
        return 0
    if not doc:
        return 0
    try:
        return min(max(int(doc.get("stage", 0)), 0), len(STAGE_NAMES) - 1)
    except (TypeError, ValueError):
        return 0
