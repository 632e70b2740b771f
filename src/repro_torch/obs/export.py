"""Profile exporters: Chrome trace-event JSON (perfetto-compatible), JSONL
span sink, and a schema validator used by tests and CI.

The Chrome trace format is the ``{"traceEvents": [...]}`` object form of
the Trace Event specification: complete events (``ph: "X"``) with
microsecond ``ts``/``dur``, one row per thread, span attributes in
``args``.  Open the file at https://ui.perfetto.dev or
``chrome://tracing``.
"""
from __future__ import annotations

import json
from typing import Iterable

_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def _display_name(span) -> str:
    op = span.attrs.get("op")
    if span.name == "operator" and op:
        return f"op:{op}"
    if span.name == "segment":
        return f"segment:{span.attrs.get('engine', '?')}"
    return span.name


def to_chrome_trace(spans: Iterable, counters: dict | None = None,
                    session: str = "") -> dict:
    """Chrome trace-event JSON for a span list.  Timestamps are rebased to
    the earliest span so traces start at t=0."""
    spans = list(spans)
    base = min((s.t0 for s in spans), default=0.0)
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": f"repro_torch session={session or '?'}"}}]
    for s in spans:
        end = s.t1 if s.t1 is not None else s.t0
        events.append({
            "name": _display_name(s),
            "cat": s.name,
            "ph": "X",
            "ts": (s.t0 - base) * 1e6,
            "dur": max((end - s.t0) * 1e6, 0.001),
            "pid": 1,
            "tid": s.thread_id % 100_000,
            "args": {"span_id": s.id, "parent_id": s.parent_id,
                     **{k: _jsonable(v) for k, v in s.attrs.items()}},
        })
    if counters:
        ts = max((e["ts"] + e.get("dur", 0) for e in events[1:]), default=0)
        events.append({
            "name": "counters", "ph": "C", "ts": ts, "pid": 1, "tid": 0,
            "args": {k: v for k, v in counters.items()
                     if isinstance(v, (int, float))}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def validate_chrome_trace(obj) -> bool:
    """Assert ``obj`` is schema-valid trace-event JSON; raises
    ``ValueError`` with the first violation, returns True when clean."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("name", "ph", "pid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        if not isinstance(ev["name"], str):
            raise ValueError(f"event {i} name must be a string")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
                raise ValueError(f"event {i} needs numeric ts >= 0")
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} needs numeric dur >= 0")
    return True


def write_jsonl(spans: Iterable, path: str) -> int:
    """One span per line as JSON; returns the number written."""
    n = 0
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.to_dict(), default=str) + "\n")
            n += 1
    return n
