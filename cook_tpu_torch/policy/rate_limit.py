"""The port's copy of ``cook_tpu/policy/rate_limit.py`` (imports re-rooted).

Token-bucket rate limiting.

Mirrors the reference's rate-limit engine (reference:
scheduler/src/cook/rate_limit/token_bucket_filter.clj — lazy-replenish token
buckets — and rate_limit/generic.clj:86-157 — a keyed cache of buckets with
an enforce? flag).  Instances cover the same three planes the reference
wires (rate_limit.clj:30-56): job submission per user, per-user-per-pool
launches, and per-compute-cluster launches.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class _Bucket:
    tokens: float
    last_update_s: float


class TokenBucketRateLimiter:
    """Keyed token buckets: ``bucket_size`` capacity, replenished at
    ``tokens_per_minute``; going into debt is allowed (the caller spends
    first, then asks ``time_until_out_of_debt``), matching the reference's
    earn-then-spend filter semantics."""

    def __init__(self, tokens_per_minute: float, bucket_size: float,
                 enforce: bool = True,
                 clock=time.monotonic):
        self.tokens_per_minute = float(tokens_per_minute)
        self.bucket_size = float(bucket_size)
        self.enforce = enforce
        self._clock = clock
        self._buckets: Dict[str, _Bucket] = {}
        self._lock = threading.Lock()
        # adaptive-admission handle (sched/admission.py): the effective
        # refill rate is tokens_per_minute * refill_scale.  Replenishment
        # is lazy, so a scale change applies from the NEXT refresh on —
        # tokens already earned are never clawed back.
        self._refill_scale = 1.0

    @property
    def refill_scale(self) -> float:
        return self._refill_scale

    def set_refill_scale(self, scale: float) -> None:
        """Scale the refill rate by ``scale`` in [0, 1] (the admission
        level).  Buckets are refreshed lazily, so tokens accrued under
        the old scale stay earned; only future replenishment slows."""
        with self._lock:
            # settle every bucket at the OLD rate first so the scale
            # change is not applied retroactively to elapsed time
            for key in list(self._buckets):
                self._refresh(key)
            self._refill_scale = min(max(float(scale), 0.0), 1.0)

    def _effective_rate(self) -> float:
        return self.tokens_per_minute * self._refill_scale

    def _refresh(self, key: str) -> _Bucket:
        now = self._clock()
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = _Bucket(tokens=self.bucket_size, last_update_s=now)
            self._buckets[key] = bucket
        else:
            earned = (now - bucket.last_update_s) / 60.0 \
                * self._effective_rate()
            bucket.tokens = min(self.bucket_size, bucket.tokens + earned)
            bucket.last_update_s = now
        return bucket

    def get_token_count(self, key: str) -> float:
        with self._lock:
            return self._refresh(key).tokens

    def spend(self, key: str, n: float = 1.0) -> None:
        with self._lock:
            bucket = self._refresh(key)
            bucket.tokens -= n

    def within_limit(self, key: str) -> bool:
        """True when the key has tokens (or enforcement is off)."""
        if not self.enforce:
            return True
        return self.get_token_count(key) > 0

    def try_spend(self, key: str, n: float = 1.0,
                  max_keys: int = 65536) -> bool:
        """Atomic check-and-spend: admit only when the key holds >= n full
        tokens (a separate check-then-spend would let N concurrent callers
        all pass on one token).

        The bucket map is bounded at ~``max_keys`` (keys are
        caller-controlled for HTTP clients).  Eviction preference:
        (1) fully-refilled buckets — lossless, an evicted key is
        recreated in the same full state; (2) longest-untouched buckets
        that are NOT in debt — evicting a throttled (in-debt) client
        would recreate it full and forgive the throttle; (3) only when
        everything is in debt (pathological flood), oldest-touched
        regardless — bounded memory wins."""
        if not self.enforce:
            return True
        with self._lock:
            if len(self._buckets) > max_keys:
                import heapq
                need = max(1024, len(self._buckets) - max_keys)
                full = [k for k, b in self._buckets.items()
                        if b.tokens >= self.bucket_size and k != key]
                for k in full[:need]:
                    del self._buckets[k]
                need -= min(need, len(full))
                if need > 0:
                    solvent = [k for k, b in self._buckets.items()
                               if b.tokens >= 0 and k != key]
                    pool = solvent if len(solvent) >= need else [
                        k for k in self._buckets if k != key]
                    for k in heapq.nsmallest(
                            need, pool,
                            key=lambda k: self._buckets[k].last_update_s):
                        del self._buckets[k]
            bucket = self._refresh(key)
            if bucket.tokens < n:
                return False
            bucket.tokens -= n
            return True

    def time_until_out_of_debt_s(self, key: str) -> float:
        with self._lock:
            tokens = self._refresh(key).tokens
            rate = self._effective_rate()
        if tokens >= 0:
            return 0.0
        if rate <= 0:
            return float("inf")
        return -tokens / rate * 60.0

    def retry_after_s(self, key: str, n: float = 1.0) -> float:
        """Seconds until ``key`` can afford ``n`` tokens at the current
        (scaled) refill rate — the honest ``Retry-After`` value for an
        admission 429.  Infinite when the scaled rate is zero."""
        with self._lock:
            tokens = self._refresh(key).tokens
            rate = self._effective_rate()
        short = n - tokens
        if short <= 0:
            return 0.0
        if rate <= 0:
            return float("inf")
        return short / rate * 60.0

    def flush(self) -> None:
        with self._lock:
            self._buckets.clear()

    def saturation(self) -> float:
        """Worst-key consumption fraction in [0, 1] — the launch-token
        saturation signal (sched/fleet.py): 0 = every bucket full,
        1 = some key fully spent (or in debt, which clamps).  Buckets
        are lazily refreshed first, so a key idle since its last spend
        reads its EARNED-BACK level, not its historical debt."""
        if self.bucket_size <= 0:
            return 0.0
        with self._lock:
            if not self._buckets:
                return 0.0
            low = min(self._refresh(key).tokens
                      for key in list(self._buckets))
        return min(max(1.0 - low / self.bucket_size, 0.0), 1.0)


class UnlimitedRateLimiter:
    """The no-op limiter used when a plane is unconfigured."""

    enforce = False
    refill_scale = 1.0

    def get_token_count(self, key: str) -> float:
        return float("inf")

    def spend(self, key: str, n: float = 1.0) -> None:
        pass

    def within_limit(self, key: str) -> bool:
        return True

    def try_spend(self, key: str, n: float = 1.0,
                  max_keys: int = 65536) -> bool:
        return True

    def set_refill_scale(self, scale: float) -> None:
        pass

    def time_until_out_of_debt_s(self, key: str) -> float:
        return 0.0

    def retry_after_s(self, key: str, n: float = 1.0) -> float:
        return 0.0

    def flush(self) -> None:
        pass

    def saturation(self) -> float:
        return 0.0


def pool_user_key(pool: str, user: str) -> str:
    return f"{pool}/{user}"


def submission_limiter(admission_conf, clock=time.monotonic):
    """Build the submission-side per-user limiter from an
    ``config.AdmissionConfig`` (rest/api.py front door).  Unconfigured
    (disabled, or refill 0) -> the no-op limiter, matching the other
    planes' unconfigured behavior."""
    if admission_conf is None or not getattr(admission_conf, "enabled",
                                             False):
        return UnlimitedRateLimiter()
    rate = float(getattr(admission_conf, "submissions_per_minute", 0.0))
    if rate <= 0:
        return UnlimitedRateLimiter()
    burst = float(getattr(admission_conf, "submission_burst", 0.0)) or rate
    return TokenBucketRateLimiter(rate, burst, enforce=True, clock=clock)


@dataclass
class RateLimits:
    """The three rate-limit planes (reference: rate_limit.clj)."""

    job_submission: object = None    # key: user
    job_launch: object = None        # key: pool/user
    cluster_launch: object = None    # key: cluster name

    def __post_init__(self):
        self.job_submission = self.job_submission or UnlimitedRateLimiter()
        self.job_launch = self.job_launch or UnlimitedRateLimiter()
        self.cluster_launch = self.cluster_launch or UnlimitedRateLimiter()
