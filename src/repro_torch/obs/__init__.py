"""``repro_torch.obs`` — structured telemetry: spans, metrics, profile export.

Every execution layer (JIT analysis, planner, runtime segments, physical
operators, handoffs, fallbacks) emits hierarchical :class:`Span` records
through the session context's :class:`Tracer`.  Tracing is **near-zero-cost
when disabled**: the hot-path gate is a single module-global integer check
(``spans.tracing_active``) and operators receive a shared no-op span — the
``benchmarks/run.py observability`` figure measures and CI bounds the
overhead (< 3% vs an uninstrumented baseline).

User surface (re-exported as ``repro_torch.pandas.profile``):

    with pd.profile() as prof:
        ...plain pandas-style code...
    print(prof.render())            # span tree with durations + attributes
    prof.counters                   # counter deltas for the profiled block
    prof.to_chrome_trace()          # trace-event JSON; open in perfetto
    prof.save_chrome_trace("t.json")

Module map
----------
``spans``    Span / Tracer / no-op fast path / ``traced_op`` decorator
``metrics``  per-session counters + gauges registry
``events``   bounded TraceLog ring + structured PlannerEvent strings
``export``   Chrome trace-event JSON, JSONL sink, schema validation
``profile``  Profile object + ``profile()`` context manager
"""
from __future__ import annotations

from .events import DEFAULT_TRACE_LIMIT, PlannerEvent, TraceLog
from .export import to_chrome_trace, validate_chrome_trace, write_jsonl
from .metrics import MetricsRegistry
from .profile import Profile, profile
from .spans import (NOOP_SPAN, Span, Tracer, metric_inc, op_span, traced_op,
                    tracing_active)

__all__ = [
    "Span", "Tracer", "NOOP_SPAN", "tracing_active", "traced_op", "op_span",
    "metric_inc", "MetricsRegistry", "TraceLog", "PlannerEvent",
    "DEFAULT_TRACE_LIMIT", "to_chrome_trace", "validate_chrome_trace",
    "write_jsonl", "Profile", "profile",
]
