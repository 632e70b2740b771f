"""Spans and tracers — the core of the telemetry subsystem.

A :class:`Span` is one timed region with attributes (rows in/out, bytes
moved, peak memory, engine, …) and a parent link, so force points nest as
``execute → plan → segment → operator / handoff / fallback`` trees.

The :class:`Tracer` lives on the session context (``ctx.tracer``) and is
*disabled* until a :class:`~repro_torch.obs.profile.Profile` attaches.  Disabled
tracing must cost nearly nothing on hot paths, so there are two gates:

* ``tracing_active()`` — one module-global integer check, no context
  lookup.  ``traced_op``-wrapped physical operators test this first and
  call straight through when no profile exists anywhere in the process.
* ``Tracer.span()`` — returns the shared :data:`NOOP_SPAN` when this
  particular session has no attached profile.

``Tracer.timed_span()`` always returns a real span: the runtime uses it
for segment/engine wall time, which feeds the planner's cost calibration
(``StatsStore.record_runtime``) whether or not anyone is profiling — spans
are the *single* timing instrumentation point.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time

_ids = itertools.count(1)

# module-global count of tracers with an attached profile; the process-wide
# fast gate for operator instrumentation (one int check when disabled)
_ACTIVE_TRACERS = 0
_ACTIVE_LOCK = threading.Lock()


def tracing_active() -> bool:
    """True when any session in the process has an attached profile."""
    return _ACTIVE_TRACERS > 0


class Span:
    """One timed region.  Context-manager use finishes the span and hands
    it to the owning tracer's attached profiles."""

    __slots__ = ("id", "parent_id", "name", "t0", "t1", "attrs",
                 "thread_id", "_tracer")

    def __init__(self, name: str, parent_id: int | None = None,
                 attrs: dict | None = None, tracer: "Tracer | None" = None):
        self.id = next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.thread_id = threading.get_ident()
        self._tracer = tracer
        self.t1: float | None = None
        self.t0 = time.perf_counter()

    @property
    def duration(self) -> float:
        """Wall seconds (to now, for a still-open span)."""
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self) -> "Span":
        if self.t1 is None and self._tracer is not None:
            self._tracer._finish(self)
        elif self.t1 is None:
            self.t1 = time.perf_counter()
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def to_dict(self) -> dict:
        return {"id": self.id, "parent_id": self.parent_id,
                "name": self.name, "t0": self.t0, "t1": self.t1,
                "duration": self.duration, "thread_id": self.thread_id,
                "attrs": dict(self.attrs)}

    def __repr__(self) -> str:
        return (f"Span({self.name!r} #{self.id} {self.duration * 1e3:.3f}ms "
                f"{self.attrs})")


class _NoopSpan:
    """Shared do-nothing span returned on every disabled-tracing path."""

    __slots__ = ()
    id = 0
    parent_id = None
    name = "noop"
    duration = 0.0
    attrs: dict = {}

    def set(self, **attrs):
        return self

    def finish(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Per-session span factory.  Thread-safe: the open-span stack is
    thread-local, so concurrent sessions (or one session crossing threads)
    never mis-parent spans."""

    def __init__(self, session: str = ""):
        self.session = session
        self._profiles: list = []       # attached Profile sinks
        self._tls = threading.local()

    # -- state -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._profiles)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Span | None:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- span creation -----------------------------------------------------

    def span(self, name: str, **attrs) -> Span | _NoopSpan:
        """A span recorded only while a profile is attached; the no-op
        fast path otherwise."""
        if not self._profiles:
            return NOOP_SPAN
        return self._start(name, attrs)

    def timed_span(self, name: str, **attrs) -> Span:
        """A real (self-timing) span regardless of profiling state — for
        sites whose duration feeds calibration, not just profiles."""
        return self._start(name, attrs)

    def event(self, name: str, **attrs) -> Span | _NoopSpan:
        """Zero-duration instant event (recorded only when enabled)."""
        sp = self.span(name, **attrs)
        if sp is not NOOP_SPAN:
            sp.finish()
        return sp

    def _start(self, name: str, attrs: dict) -> Span:
        stack = self._stack()
        parent = stack[-1].id if stack else None
        sp = Span(name, parent_id=parent, attrs=attrs, tracer=self)
        stack.append(sp)
        return sp

    def _finish(self, sp: Span) -> None:
        sp.t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:                            # out-of-order finish: best effort
            try:
                stack.remove(sp)
            except ValueError:
                pass
        for prof in tuple(self._profiles):
            prof._add(sp)

    # -- profile attachment ------------------------------------------------

    def attach(self, profile) -> None:
        global _ACTIVE_TRACERS
        with _ACTIVE_LOCK:
            self._profiles.append(profile)
            _ACTIVE_TRACERS += 1

    def detach(self, profile) -> None:
        global _ACTIVE_TRACERS
        with _ACTIVE_LOCK:
            try:
                self._profiles.remove(profile)
            except ValueError:
                return
            _ACTIVE_TRACERS -= 1


# ---------------------------------------------------------------------------
# Hot-path helpers for code without a context in hand (physical operators).


def _current_tracer() -> Tracer | None:
    from repro_torch.core.context import get_context
    return getattr(get_context(), "tracer", None)


def op_span(op: str, **attrs) -> Span | _NoopSpan:
    """Operator span via the current session's tracer; no-op when the
    process has no active profile (one int check) or this session's tracer
    is disabled."""
    if not _ACTIVE_TRACERS:
        return NOOP_SPAN
    tracer = _current_tracer()
    if tracer is None or not tracer._profiles:
        return NOOP_SPAN
    return tracer.span("operator", op=op, **attrs)


def io_span(op: str, tracer: Tracer | None = None, **attrs) -> Span | _NoopSpan:
    """IO-layer span (partition load, prefetch, ingest) with the same
    disabled-cost profile as :func:`op_span`.  Accepts an explicit tracer
    for call sites off the session thread — the prefetch worker passes the
    owning session's tracer, since the context lookup is thread-local."""
    if not _ACTIVE_TRACERS:
        return NOOP_SPAN
    t = tracer if tracer is not None else _current_tracer()
    if t is None or not t._profiles:
        return NOOP_SPAN
    return t.span("io", op=op, **attrs)


def metric_inc(name: str, n: int = 1) -> None:
    """Increment a counter on the current session's metrics registry."""
    from repro_torch.core.context import get_context
    metrics = getattr(get_context(), "metrics", None)
    if metrics is not None:
        metrics.inc(name, n)


def _rows_of(value) -> int | None:
    if isinstance(value, dict):
        if not value:
            return 0
        shape = getattr(next(iter(value.values())), "shape", None)
        return int(shape[0]) if shape else None
    rows = getattr(value, "rows", None)
    if callable(rows) and hasattr(value, "valid"):    # ShardedTable
        try:
            return int(value.rows())
        except Exception:  # noqa: BLE001 — metadata only, never fail the op
            return None
    return None


def _bytes_of(value) -> int | None:
    if isinstance(value, dict):
        return int(sum(int(getattr(c, "nbytes", 0) or 0)
                       for c in value.values()))
    nbytes = getattr(value, "nbytes", None)
    if callable(nbytes):
        try:
            return int(nbytes())
        except Exception:  # noqa: BLE001
            return None
    return int(nbytes) if isinstance(nbytes, (int, float)) else None


rows_of = _rows_of
bytes_of = _bytes_of


def traced_op(op: str):
    """Instrument a physical operator with a per-call span (rows in/out,
    bytes out).  The disabled path is one module-global int check before
    calling straight through; the original is kept on ``__wrapped__`` so
    the observability benchmark can measure a truly uninstrumented
    baseline."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE_TRACERS:
                return fn(*args, **kwargs)
            sp = op_span(op)
            if sp is NOOP_SPAN:
                return fn(*args, **kwargs)
            with sp:
                rows_in = _rows_of(args[0]) if args else None
                if rows_in is not None:
                    sp.attrs["rows_in"] = rows_in
                out = fn(*args, **kwargs)
                rows_out = _rows_of(out)
                if rows_out is not None:
                    sp.attrs["rows_out"] = rows_out
                bytes_out = _bytes_of(out)
                if bytes_out is not None:
                    sp.attrs["bytes_out"] = bytes_out
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco
