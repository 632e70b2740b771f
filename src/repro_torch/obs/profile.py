"""`Profile` — what ``with pd.profile() as prof:`` yields.

A profile attaches to the current session's tracer for the duration of the
block, collecting every finished span into a bounded ring plus the counter
deltas accumulated while it was open.  Exporters: ``render()`` (text span
tree), ``to_chrome_trace()`` / ``save_chrome_trace()`` (perfetto), and
``to_jsonl()``.
"""
from __future__ import annotations

import contextlib
import json

from .export import to_chrome_trace, write_jsonl
from .spans import Span

DEFAULT_MAX_SPANS = 65_536

_DETAIL_ATTRS = ("op", "engine", "force_reason", "segment", "rows_in",
                 "rows_out", "bytes_out", "bytes_moved", "peak_bytes",
                 "est_work", "segments", "device_resident", "status",
                 "jit_seconds", "node_id", "payload")


class Profile:
    """Completed-span ring + counter deltas for one profiled block."""

    def __init__(self, session: str = "",
                 max_spans: int = DEFAULT_MAX_SPANS):
        self.session = session
        self.max_spans = max_spans
        self.spans: list[Span] = []          # completion order
        self.dropped = 0
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}

    # -- collection (called by Tracer._finish) ------------------------------

    def _add(self, span: Span) -> None:
        self.spans.append(span)
        if self.max_spans and len(self.spans) > self.max_spans:
            excess = len(self.spans) - self.max_spans
            del self.spans[:excess]
            self.dropped += excess

    # -- queries ------------------------------------------------------------

    def find(self, name: str | None = None, **attrs) -> list[Span]:
        """Spans matching a name and/or attribute equality filters."""
        out = []
        for s in self.spans:
            if name is not None and s.name != name:
                continue
            if any(s.attrs.get(k) != v for k, v in attrs.items()):
                continue
            out.append(s)
        return out

    def span_names(self) -> set[str]:
        return {s.name for s in self.spans}

    def total_seconds(self) -> float:
        if not self.spans:
            return 0.0
        return max(s.t1 or s.t0 for s in self.spans) \
            - min(s.t0 for s in self.spans)

    # -- rendering -----------------------------------------------------------

    def render(self) -> str:
        """Human-readable span tree (chronological, indented by parent)."""
        lines = [f"profile session={self.session} spans={len(self.spans)}"
                 + (f" dropped={self.dropped}" if self.dropped else "")]
        ids = {s.id for s in self.spans}
        children: dict[int | None, list[Span]] = {}
        for s in self.spans:
            parent = s.parent_id if s.parent_id in ids else None
            children.setdefault(parent, []).append(s)
        for group in children.values():
            group.sort(key=lambda s: s.t0)

        def emit(span: Span, depth: int) -> None:
            detail = " ".join(
                f"{k}={span.attrs[k]}" for k in _DETAIL_ATTRS
                if k in span.attrs)
            lines.append(f"{'  ' * depth}{span.name} "
                         f"{span.duration * 1e3:.3f}ms"
                         + (f" {detail}" if detail else ""))
            for child in children.get(span.id, ()):
                emit(child, depth + 1)

        for root in children.get(None, ()):
            emit(root, 1)
        if self.counters:
            lines.append("counters: " + " ".join(
                f"{k}={v}" for k, v in sorted(self.counters.items())))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        return to_chrome_trace(self.spans, counters=self.counters,
                               session=self.session)

    def save_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def to_jsonl(self, path: str) -> int:
        return write_jsonl(self.spans, path)


@contextlib.contextmanager
def profile(ctx=None, max_spans: int = DEFAULT_MAX_SPANS):
    """Collect a :class:`Profile` of everything the session executes inside
    the block:

        with pd.profile() as prof:
            pd.analyze()
            ...
        print(prof.render())

    Attaches to the *current* session's tracer (or ``ctx``'s, when given):
    sessions opened inside the block have their own tracers and are not
    captured.  Profiles nest — each sees the spans finished while it was
    open."""
    from repro_torch.core.context import get_context
    ctx = ctx if ctx is not None else get_context()
    tracer = ctx.tracer
    prof = Profile(session=getattr(ctx, "session_name", ""),
                   max_spans=max_spans)
    metrics = getattr(ctx, "metrics", None)
    counters_before = metrics.snapshot() if metrics is not None else {}
    persist_before = dict(getattr(ctx, "persist_stats", {}))
    tracer.attach(prof)
    try:
        yield prof
    finally:
        tracer.detach(prof)
        if metrics is not None:
            prof.counters = metrics.delta(counters_before,
                                          metrics.snapshot())
            prof.gauges = metrics.gauges()
        for key, value in getattr(ctx, "persist_stats", {}).items():
            delta = value - persist_before.get(key, 0)
            if delta:
                prof.counters[f"persist.{key}"] = delta
        if self_dropped := prof.dropped:
            prof.counters["spans.dropped"] = self_dropped
