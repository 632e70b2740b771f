"""Structured trace events + the bounded trace log.

``ctx.planner_trace`` / ``ctx.fallback_trace`` historically were unbounded
plain lists; a long-lived serving session accumulated entries forever.
:class:`TraceLog` is the drop-in replacement: a ``list`` subclass whose
``append`` evicts the oldest entries past a configurable limit
(``session(trace_limit=...)``), counting what it dropped.

:class:`PlannerEvent` migrates the planner's string trace onto structured
events without breaking a single existing consumer: it *is* a ``str`` (the
legacy rendering — ``"device-resident" in line`` keeps working) carrying a
``kind`` tag and a ``fields`` dict for programmatic access.
"""
from __future__ import annotations

import threading

DEFAULT_TRACE_LIMIT = 10_000


class TraceLog(list):
    """Bounded append-log: keeps the newest ``limit`` entries, counts
    evictions in ``dropped``.  ``limit=None`` (or 0) disables bounding.

    Appends are lock-guarded: the eviction step is a read-modify-write
    (append, then trim) that two racing appenders could interleave into a
    lost ``dropped`` count or an over-limit log.  Sessions are single-owner
    by contract, but facade fallbacks and engine callbacks may append from
    worker threads, so the log itself stays safe."""

    def __init__(self, limit: int | None = DEFAULT_TRACE_LIMIT):
        super().__init__()
        self.limit = limit
        self.dropped = 0
        self._lock = threading.Lock()

    def append(self, item) -> None:
        with self._lock:
            super().append(item)
            if self.limit and len(self) > self.limit:
                excess = len(self) - self.limit
                del self[:excess]
                self.dropped += excess

    def extend(self, items) -> None:
        for item in items:
            self.append(item)


class PlannerEvent(str):
    """A planner-trace entry: a structured event that renders as (and *is*)
    its legacy string form.

    ``kind`` tags the event type (``"segment"``, ``"handoff"``,
    ``"calibration"``, ``"peak-calibration"``, ``"native-fallback"``,
    ``"note"``); ``fields`` holds the typed payload that used to be
    embedded in the string."""

    def __new__(cls, text: str, kind: str = "note", **fields):
        self = super().__new__(cls, text)
        self.kind = kind
        self.fields = fields
        return self

    def to_dict(self) -> dict:
        return {"kind": self.kind, "text": str(self), **self.fields}
