"""The port's copy of ``cook_tpu/utils/logging.py`` (imports re-rooted).

Structured logging + the passport audit event stream.

Mirrors the reference's JSON structured logging with standardized keys
(reference: log_structured.clj:17-91) and the passport audit trail —
one JSON document per lifecycle event routed to a dedicated logger for
offline joining (reference: passport.clj:21-41).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Optional

_structured = logging.getLogger("cook.structured")
_passport = logging.getLogger("cook.passport")


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {"ts": time.time(), "level": record.levelname.lower(),
               "logger": record.name, "message": record.getMessage()}
        extra = getattr(record, "doc", None)
        if extra:
            doc.update(extra)
        return json.dumps(doc, default=str)


def log_structured(level: int, message: str, *, pool: Optional[str] = None,
                   job: Optional[str] = None, instance: Optional[str] = None,
                   user: Optional[str] = None, **kw: Any) -> None:
    doc: Dict[str, Any] = {k: v for k, v in
                           [("pool", pool), ("job", job),
                            ("instance", instance), ("user", user)]
                           if v is not None}
    doc.update(kw)
    _structured.log(level, message, extra={"doc": doc})


class Passport:
    """Audit events: job-created, instance-launched, instance-completed,
    job-completed, preemption, ... (reference passport event types)."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or _passport
        self.events: list = []  # in-memory tail for tests/debug endpoint
        self.max_events = 10_000

    def log(self, event_type: str, **data: Any) -> None:
        doc = {"event": event_type, "ts": time.time(), **data}
        self.logger.info(event_type, extra={"doc": doc})
        self.events.append(doc)
        if len(self.events) > self.max_events:
            del self.events[:len(self.events) // 2]


passport = Passport()


def wire_store_passport(store) -> None:
    """Subscribe the passport to a store's tx feed."""

    def on_events(tx_id: int, events) -> None:
        for e in events:
            passport.log(e.kind, tx_id=tx_id, **{
                k: v for k, v in e.data.items()})

    store.subscribe(on_events)
