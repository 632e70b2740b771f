"""Session context: engine choice, sink ordering chain, persist cache,
static-analysis hints (the runtime side of the paper's JIT analysis).

Contexts are *session-scoped*: ``get_context()`` returns the top of a
thread-local session stack, falling back to a process-wide default session.
``session(...)`` is the public context manager (re-exported as
``repro_torch.pandas.session``) giving an isolated planner / persist / sink /
stats state; nested sessions stack, and each thread gets its own stack so
concurrent sessions never share mutable state.

Engines are addressed by **string name** (``"eager"``, ``"streaming"``,
``"distributed"``, ``"auto"``, plus anything registered through
``repro_torch.register_engine`` / the ``repro_torch.engines`` entry-point group).
``BackendEngines`` survives as a deprecated ``str``-mixin enum alias layer:
its members compare and hash equal to the plain names, so legacy code
keeps working while new code writes ``session(engine="streaming")``.

Concurrency invariants (the contract the serving tests in
``tests/test_serving.py`` pin down):

* The session stack is **thread-local**: ``get_context()`` in one thread
  never sees another thread's pushed sessions.  A serving worker must push
  its own session (``with session(...)``) — the process-wide default
  context is shared by every thread that never pushed one and is *not*
  synchronized; concurrent work must not run against it.
* Everything hanging off one ``LaFPContext`` (persist cache, stats store,
  traces, run records) is owned by that session; two sessions share no
  mutable state.  Sharing one context across threads is not supported.
* Cross-session shared state is individually synchronized: the engine
  registry (``RLock``), ``MetricsRegistry`` (lock per registry),
  ``TraceLog`` (lock per log), the process-global plan cache
  (``planner.plancache.PlanCache``, lock + immutable entries, fresh node
  clones per hit), and the stats persistence files (``StatsStore.save`` /
  ``load`` append to a log under an ``fcntl`` file lock)."""
from __future__ import annotations

import contextlib
import enum
import threading
import warnings
from typing import Any

from . import graph
from .engines import normalize_engine
from ..obs.events import DEFAULT_TRACE_LIMIT, TraceLog
from ..obs.metrics import MetricsRegistry
from ..obs.spans import Tracer


class BackendEngines(str, enum.Enum):
    """DEPRECATED alias layer for the string-named engine API.

    Members are ``str`` subclasses equal to their engine name, so
    ``BackendEngines.STREAMING == "streaming"`` and either form is accepted
    anywhere an engine is named.  New code should pass the strings; the
    open registry (``repro_torch.register_engine``) admits engines this closed
    enum can never know about."""
    EAGER = "eager"            # device-resident tensors, whole-table (Pandas analogue)
    STREAMING = "streaming"    # host out-of-core, partition-at-a-time (Dask analogue)
    DISTRIBUTED = "distributed"  # sharded over devices (Modin/cluster analogue)
    AUTO = "auto"              # cost-based per-force-point choice (planner/)


class LaFPContext:
    def __init__(self, name: str = "default",
                 trace_limit: int | None = DEFAULT_TRACE_LIMIT):
        self.session_name = name
        # telemetry (repro_torch.obs): per-session span tracer (no-op until a
        # profile attaches) + counters/gauges registry.  trace_limit bounds
        # the string/event trace logs below so long-lived serving sessions
        # can't grow without limit.
        self.trace_limit = trace_limit
        self.tracer = Tracer(session=name)
        self.metrics = MetricsRegistry()
        self._backend: str = "eager"
        self.backend_options: dict[str, Any] = {}
        # AUTO candidate allow-list (None → every registered engine)
        self.engine_allowlist: tuple[str, ...] | None = None
        # §3.3 lazy print: chain of sink nodes not yet flushed.
        self.last_sink: graph.SinkPrint | None = None
        self.pending_sinks: list[graph.SinkPrint] = []
        # §3.5 common computation reuse: structural-key → materialized value.
        self.persist_cache: dict[tuple, Any] = {}
        self.persist_stats = {"hits": 0, "misses": 0}
        # JIT static analysis results (source_analysis.py):
        #   usecols:   {(var, lineno) | var: tuple(cols) | None}
        #   live_at:   {lineno: [frame var names]}
        self.analysis: dict[str, Any] = {}
        # registry for f-string escapes (§3.3): uid -> node
        self.scalar_registry: dict[int, graph.Node] = {}
        # live frame tracking: var name -> LazyFrame (filled by analyze())
        self.optimizer_trace: list[str] = TraceLog(trace_limit)
        self.memory_budget: int | None = None   # bytes; chunked engines enforce
        self.last_peak_bytes: int = 0           # metered peak accounting
        self.last_run_peak_bytes: int = 0       # peak of the latest single run
        # engine that produced last_run_peak_bytes (peak-calibration samples
        # are recorded under this stats-store namespace)
        self.last_run_peak_engine: str | None = None
        # cost-based planner (planner/): AUTO plan-choice trace + feedback
        # stats store (observed cardinalities keyed by structural node key,
        # plus per-engine runtime samples for cost calibration).  AUTO
        # placement strategy is per-session via backend_options:
        #   backend_options["placement"] = "operator" (segments, default)
        #                                | "per_root" (PR-1 behaviour)
        self.planner_trace: list[str] = TraceLog(trace_limit)
        from .planner.feedback import StatsStore
        self.stats_store = StatsStore()
        # stats-store persistence: when REPRO_STATS_CACHE_DIR is set (or a
        # session passes stats_path=...), calibration + cardinality feedback
        # is reloaded here and re-saved after every execute, so AUTO
        # calibration survives process restarts (per-context cache file,
        # keyed by session name)
        import os as _os
        cache_dir = _os.environ.get("REPRO_STATS_CACHE_DIR")
        self.stats_path: str | None = (
            _os.path.join(cache_dir, f"{name}.json") if cache_dir else None)
        if self.stats_path:
            self.stats_store.load(self.stats_path)
        self.planner_decisions: list[Any] = []  # last force point's Decisions
        # plan cache (planner/plancache.py): repeated plan shapes skip
        # optimize/rewrite/segment-DP.  Per-session opt-out via
        # session(plan_cache=False); the cache itself is process-global.
        self.plan_cache_enabled = True
        self.last_plan_seconds: float = 0.0     # planning wall of last force point
        # structured per-force-point records (segments, handoffs) consumed
        # by ``repro_torch.core.explain`` — the typed counterpart of the string
        # traces above
        self.run_records: list[Any] = []
        self.print_fn = print                   # patched in tests
        # facade fallback protocol (repro_torch.pandas): every op the lazy layer
        # serves by eager materialization (or fails to serve at all) is
        # recorded here — coverage gaps are measured, not guessed.
        self.fallback_trace: list[Any] = TraceLog(trace_limit)  # FallbackEvents
        # force-point log: why each execute() was triggered (user compute,
        # fallback materialization, repr, flush, …)
        self.force_log: list[str] = TraceLog(trace_limit)
        # metrics
        self.exec_count = 0

    # -- engine choice (string-named; enum members accepted as aliases) -----

    @property
    def backend(self) -> str:
        return self._backend

    @backend.setter
    def backend(self, value) -> None:
        self._backend = normalize_engine(value)

    def reset(self):
        self.__init__(self.session_name, trace_limit=self.trace_limit)

    def sink_chain_add(self, sink: graph.SinkPrint):
        self.last_sink = sink
        self.pending_sinks.append(sink)

    def sinks_flushed(self):
        self.pending_sinks.clear()
        self.last_sink = None

    def report(self):
        """Typed introspection report of everything this session ran so
        far: segments (chosen engine, rejected candidates, costs), handoff
        payloads, fallback events, calibration scales.  See
        ``repro_torch.core.explain``."""
        from .explain import build_report
        return build_report(self)


# ---------------------------------------------------------------------------
# Session stack.  The default session preserves the pre-session global
# behaviour (module-level scripts, benchmarks); pushed sessions shadow it
# per-thread.

_DEFAULT_CTX = LaFPContext()
_CTX = _DEFAULT_CTX  # back-compat alias
_TLS = threading.local()


def _stack() -> list[LaFPContext]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def get_context() -> LaFPContext:
    stack = _stack()
    return stack[-1] if stack else _DEFAULT_CTX


def default_context() -> LaFPContext:
    return _DEFAULT_CTX


def push_session(ctx: LaFPContext | None = None) -> LaFPContext:
    ctx = ctx if ctx is not None else LaFPContext(name="session")
    _stack().append(ctx)
    return ctx


def pop_session() -> LaFPContext:
    stack = _stack()
    if not stack:
        raise RuntimeError("pop_session() with no active session")
    return stack.pop()


def session_depth() -> int:
    return len(_stack())


@contextlib.contextmanager
def session(engine: str | BackendEngines | None = None,
            memory_budget: int | None = None,
            name: str = "session",
            stats_path: str | None = None,
            engines: tuple | list | None = None,
            backend: str | BackendEngines | None = None,
            trace_limit: int | None = DEFAULT_TRACE_LIMIT,
            plan_cache: bool = True,
            **backend_options):
    """Isolated execution session: fresh engine choice, persist cache,
    sink chain, stats store (planner feedback + runtime calibration), and
    traces.

        with repro_torch.pandas.session(engine="streaming",
                                  memory_budget=1 << 28) as ctx:
            ...plain pandas-style code...

    ``engine`` names any registered engine (or ``"auto"``); ``backend`` is
    the deprecated alias for it and still accepts ``BackendEngines``
    members.  ``engines`` is an AUTO candidate allow-list — e.g.
    ``session(engine="auto", engines=("eager", "streaming"))`` keeps the
    planner from ever considering other engines for the block.

    Extra keyword options flow into ``ctx.backend_options`` — e.g.
    ``session(engine="auto", placement="per_root")`` selects the legacy
    per-root planner strategy for the block.  IO-layer knobs:
    ``pushdown=False`` disables the scan-pushdown optimizer pass (filters
    stay as plan nodes — the differential-testing escape hatch), and
    ``io_prefetch=N`` sets the async partition-prefetch depth for
    prefetchable on-disk sources (0 disables; default 2).

    ``stats_path`` persists the session's stats store (cardinality feedback
    + runtime/peak calibration samples) to a JSON file: reloaded here,
    re-saved after every execute — AUTO calibration survives process
    restarts.  ``REPRO_STATS_CACHE_DIR`` enables the same per-context
    persistence globally.

    ``plan_cache=False`` opts the session out of the process-global plan
    cache (``repro_torch.core.planner.plancache``): every force point re-plans
    from scratch — the escape hatch the conformance suite uses to prove
    warm-hit results bit-identical to cold plans.

    ``trace_limit`` bounds the session's trace logs (``planner_trace``,
    ``fallback_trace``, ``force_log``, ``optimizer_trace``): the newest
    entries are kept, evictions counted on each log's ``.dropped``.  Pass
    ``None`` (or 0) for unbounded legacy behaviour.

    Pending lazy sinks are flushed on clean exit (so deferred prints inside
    the block don't silently vanish); on exception the session is popped
    unflushed."""
    if backend is not None:
        if engine is not None:
            raise TypeError("pass engine=... or backend=..., not both")
        warnings.warn(
            "session(backend=...) is deprecated; use session(engine=...) "
            "with a string engine name", DeprecationWarning, stacklevel=3)
        engine = backend
    ctx = LaFPContext(name=name, trace_limit=trace_limit)
    if engine is not None:
        ctx.backend = normalize_engine(engine, warn_enum=True)
    ctx.memory_budget = memory_budget
    if engines is not None:
        ctx.engine_allowlist = tuple(
            normalize_engine(e) for e in engines)
    if stats_path is not None:
        ctx.stats_path = stats_path
        ctx.stats_store.load(stats_path)
    ctx.plan_cache_enabled = bool(plan_cache)
    ctx.backend_options.update(backend_options)
    push_session(ctx)
    try:
        yield ctx
        if ctx.last_sink is not None:
            from .runtime import flush
            flush()
    finally:
        pop_session()
