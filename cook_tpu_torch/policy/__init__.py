"""The port's copy of ``cook_tpu/policy/__init__.py``."""

from .plugins import (  # noqa: F401
    FileUrlGenerator,
    InstanceCompletionHandler,
    JobAdjuster,
    JobLaunchFilter,
    JobRouter,
    JobSubmissionModifier,
    JobSubmissionValidator,
    PluginRegistry,
    PluginResult,
    PoolSelector,
)
from .queue_limit import QueueLimits  # noqa: F401
from .rate_limit import (  # noqa: F401
    RateLimits,
    TokenBucketRateLimiter,
    UnlimitedRateLimiter,
    pool_user_key,
    submission_limiter,
)
