"""The port's copy of ``cook_tpu/utils/__init__.py``."""

from .logging import (  # noqa: F401
    JsonFormatter,
    Passport,
    log_structured,
    passport,
    wire_store_passport,
)
from .metrics import MetricsRegistry, registry  # noqa: F401
