"""Execution orchestration: optimize → plan persists → dispatch to engine →
flush sinks in order (paper §2.6).

Engines are addressed through the open registry (``repro_torch.core.engines``) by
string name; nothing here knows a concrete engine.  Every force point also
appends a typed run record (segments + handoff payloads) consumed by
``repro_torch.core.explain`` / ``pd.explain()``.
"""
from __future__ import annotations

from time import perf_counter
from typing import Any

from . import graph as G
from .context import get_context
from .engines import AUTO, create_engine
from .liveness import apply_persist_marks, evict_dead_entries, plan_persists
from .optimizer import optimize


def _live_nodes_from(live_df) -> list[G.Node]:
    if not live_df:
        return []
    nodes = []
    for f in live_df:
        node = getattr(f, "_node", None)
        nodes.append(node if node is not None else f)
    return nodes


def execute(roots: list[G.Node], live_df=None,
            force_reason: str | None = None) -> list[Any]:
    """Force computation of ``roots``.  Any pending lazy sinks are chained in
    front (paper §3.4: forced computation processes pending prints first, in
    order).  Returns materialized values for ``roots``.

    ``force_reason`` labels the force point in ``ctx.force_log`` (user
    compute, len, repr, facade fallback materialization, flush, …) so the
    measured fallback protocol can attribute every execution."""
    ctx = get_context()
    ctx.exec_count += 1
    ctx.force_log.append(force_reason or "compute")
    live_nodes = _live_nodes_from(live_df)

    # "execute" is the root telemetry span of one force point; a no-op
    # unless a profile is attached to this session's tracer (pd.profile()).
    with ctx.tracer.span("execute", force_reason=force_reason or "compute",
                         engine=ctx.backend) as exec_span:
        all_roots = list(roots)
        sink_roots: list[G.Node] = []
        if ctx.last_sink is not None:
            sink_roots = [ctx.last_sink]
            all_roots = sink_roots + all_roots

        # §3.5 reuse: substitute cached subexpressions BEFORE optimization so
        # physical rewrites (column narrowing, dead-assign elimination) can't
        # change the lookup key.
        if ctx.persist_cache:
            from .optimizer import _rebuild
            replace = {}
            for n in G.walk(all_roots):
                if isinstance(n, G.Materialized) or isinstance(n, G.SinkPrint):
                    continue
                hit = ctx.persist_cache.get(n.key())
                if hit is not None and isinstance(hit, dict):
                    ctx.persist_stats["hits"] += 1
                    replace[n.id] = G.Materialized(hit, n.key())
            if replace:
                all_roots, sub_map = _rebuild(all_roots, replace)
                live_nodes = [sub_map.get(n.id, n) for n in live_nodes]
                roots = [sub_map.get(n.id, n) for n in roots]
                if sink_roots:
                    sink_roots = [all_roots[0]]

        persist_ids = plan_persists(all_roots, live_nodes)
        apply_persist_marks(all_roots, persist_ids)
        walk_nodes = G.walk(all_roots)
        logical_keys = {n.id: n.key() for n in walk_nodes}

        # -- plan cache: a repeated plan shape skips optimize/rewrite and
        # (under AUTO) the segment DP entirely, rebinding the cached
        # optimized plan to this run's sources (planner/plancache.py)
        from .planner import plancache as PC
        cache = (PC.default_plan_cache()
                 if getattr(ctx, "plan_cache_enabled", True) else None)
        ckey = None
        bound = None
        t_plan0 = perf_counter()
        if cache is not None:
            ckey = PC.cache_key(all_roots, ctx, walk=walk_nodes)
            if ckey is None:
                cache.record_uncacheable()
                ctx.metrics.inc("plan_cache.uncacheable")
            else:
                entry = cache.lookup(ckey)
                if entry is not None:
                    bound = entry.bind(walk_nodes)

        ctx._cached_decisions = None
        ctx._place_seconds = 0.0
        plan_cached = bound is not None
        if plan_cached:
            opt_roots, idmap, ctx._cached_decisions = bound
            bind_seconds = perf_counter() - t_plan0
            cache.record_hit(bind_seconds)
            ctx.metrics.inc("plan_cache.hits")
            ctx.last_plan_seconds = bind_seconds
            from ..obs.events import PlannerEvent
            ctx.planner_trace.append(PlannerEvent(
                f"plan-cache: hit fp={ckey[0][:12]} epoch={ckey[1][:8]} "
                f"bind={bind_seconds * 1e3:.2f}ms",
                kind="plan_cache", status="hit",
                fingerprint=ckey[0], epoch=ckey[1],
                bind_seconds=bind_seconds))
        else:
            t_opt0 = perf_counter()
            opt_roots, idmap = optimize(all_roots, ctx)
            ctx._opt_seconds = perf_counter() - t_opt0
        ctx._last_plan_cached = plan_cached
        # re-mark persists on the rewritten nodes; store under the LOGICAL key
        for old_id in persist_ids:
            if old_id in idmap:
                idmap[old_id].persist = True
                idmap[old_id].cache_key = logical_keys[old_id]

        results, backend_name = _dispatch(opt_roots, ctx)
        exec_span.set(executed=backend_name)

        if not plan_cached:
            ctx.last_plan_seconds = ctx._opt_seconds + ctx._place_seconds
        if cache is not None and ckey is not None and not plan_cached:
            plan_seconds = ctx.last_plan_seconds
            decisions = (list(ctx.planner_decisions)
                         if ctx.backend == AUTO else None)
            cache.store(PC.CachedPlan.build(
                ckey, walk_nodes, opt_roots, idmap, decisions, plan_seconds))
            cache.record_miss(plan_seconds)
            ctx.metrics.inc("plan_cache.misses")
            from ..obs.events import PlannerEvent
            ctx.planner_trace.append(PlannerEvent(
                f"plan-cache: miss fp={ckey[0][:12]} epoch={ckey[1][:8]} "
                f"plan={plan_seconds * 1e3:.2f}ms",
                kind="plan_cache", status="miss",
                fingerprint=ckey[0], epoch=ckey[1],
                plan_seconds=plan_seconds))

        # planner feedback (§ runtime optimization): observed cardinalities
        # recalibrate future estimates for repeated plans
        from .planner.feedback import record_execution
        record_execution(opt_roots, results, ctx, backend_name)
        # typed run record (segments + handoffs) for pd.explain()
        from .explain import record_run
        record_run(ctx, force_reason or "compute", backend_name, opt_roots)
        if getattr(ctx, "stats_path", None):
            ctx.stats_store.save(ctx.stats_path)

    if sink_roots:
        ctx.sinks_flushed()
    # eviction compares LOGICAL keys — use the pre-optimization live nodes
    evict_dead_entries(ctx, live_nodes)

    out = []
    for r in roots:
        rn = idmap.get(r.id, r)
        out.append(_wrap(rn, results[rn.id]))
    return out


def flush():
    """Execute all pending lazy sinks (pd.flush(), paper §3.3)."""
    ctx = get_context()
    if ctx.last_sink is None:
        return
    execute([], None, "flush")


def _wrap(node: G.Node, value):
    from .lazyframe import Result
    if isinstance(node, (G.Reduce, G.Length, G.SinkPrint)):
        return value
    vocab = _collect_vocab(node)
    return Result(value, vocab)


def _collect_vocab(node: G.Node):
    vocab = {}
    for n in G.walk([node]):
        if isinstance(n, G.Scan):
            vocab.update(n.source.dicts)
    return vocab


def _dispatch(opt_roots, ctx):
    """Run the optimized plan: fixed engine, or cost-based AUTO placement
    (plan → select → chain engine segments through Handoff pipe breakers).

    Spans are the single timing instrumentation point: every engine run
    executes inside a ``timed_span`` whose duration feeds the planner's
    cost calibration (``StatsStore.record_runtime``) — and, when a profile
    is attached, lands in the profile's span tree."""
    engine = ctx.backend
    if engine != AUTO:
        backend = create_engine(engine, ctx.backend_options)
        ctx.planner_decisions = []
        with ctx.tracer.timed_span("segment", engine=backend.name,
                                   segment=0) as sp:
            results = backend.execute(opt_roots, ctx)
        ctx._last_segment_spans = {0: sp.id}
        _record_runtime_sample(opt_roots, ctx, engine, backend.name, sp)
        return results, backend.name
    decisions = getattr(ctx, "_cached_decisions", None)
    if decisions is None:
        from .planner.select import plan_placement
        t_place0 = perf_counter()
        with ctx.tracer.span("plan", engine=AUTO) as psp:
            decisions = plan_placement(opt_roots, ctx)
            psp.set(segments=len(decisions))
        ctx._place_seconds = perf_counter() - t_place0
    ctx.planner_decisions = decisions
    return execute_segments(decisions, ctx,
                            final_root_ids={r.id for r in opt_roots})


def execute_segments(decisions, ctx, final_root_ids=frozenset()):
    """Run planner segments in topological order, chaining boundary values
    through ``Handoff`` leaves.

    Boundary payloads are host-normalized (the transfer the cost model
    charges) — except when the producing segment *and every consumer* of a
    value run on the same engine and that engine keeps device-resident
    payloads (``supports_device_handoff``): then the payload stays on
    device and the consuming segment uses it in place, so same-engine
    chains never re-materialize from host.  Each kept payload is recorded
    in ``ctx.planner_trace`` (``payload=<type>``) and as a typed handoff
    event for ``pd.explain()``.

    ``final_root_ids`` are plan roots the caller will unwrap: those are
    always gathered to host values."""
    from . import physical as X
    from ..obs.events import PlannerEvent
    from ..obs.spans import bytes_of
    results: dict[int, object] = {}
    names: list[str] = []
    produced: dict[int, object] = {}     # original node id -> handoff payload
    handoff_events: list[dict] = []
    segment_spans: dict[int, int] = {}   # segment index -> span id
    tracer = ctx.tracer
    # who consumes each cross-segment value, by engine
    consumers: dict[int, set] = {}
    for d in decisions:
        for b in d.boundary:
            consumers.setdefault(b.id, set()).add(d.backend)
    for si, d in enumerate(decisions):
        backend = create_engine(d.backend, ctx.backend_options)
        seg_roots = _segment_subgraph(d, produced)
        device_resident: set[int] = set()
        if getattr(backend, "supports_device_handoff", False):
            device_resident = {
                orig.id for orig in d.roots
                if orig.id not in final_root_ids
                and consumers.get(orig.id)
                and all(c == d.backend for c in consumers[orig.id])}
        keep = frozenset(new.id for orig, new in zip(d.roots, seg_roots)
                         if orig.id in device_resident)
        with tracer.timed_span("segment", engine=backend.name, segment=si,
                               est_work=d.cost.total) as sp:
            if keep:
                vals = backend.execute(seg_roots, ctx, keep_sharded=keep)
            else:
                vals = backend.execute(seg_roots, ctx)
        segment_spans[si] = sp.id
        raw_est_peak = (d.cost.raw_peak_bytes
                        if d.cost.raw_peak_bytes is not None
                        else d.cost.peak_bytes)
        _record_calibration(ctx, backend.name, d.cost.total,
                            raw_est_peak, sp)
        for orig, new in zip(d.roots, seg_roots):
            v = vals[new.id]
            results[orig.id] = v
            is_boundary = bool(consumers.get(orig.id))
            if orig.id in device_resident:
                produced[orig.id] = v        # device payload, stays resident
                ctx.planner_trace.append(PlannerEvent(
                    f"auto: handoff #{orig.id} seg{si} "
                    f"payload={type(v).__name__} device-resident "
                    f"({d.cost.backend}->{d.cost.backend})",
                    kind="handoff", node_id=orig.id, segment=si,
                    payload=type(v).__name__, device_resident=True,
                    producer=str(d.cost.backend)))
                tracer.event("handoff", node_id=orig.id, segment=si,
                             device_resident=True, bytes_moved=0,
                             payload=type(v).__name__)
            elif is_boundary:
                with tracer.span("handoff", node_id=orig.id, segment=si,
                                 device_resident=False) as hsp:
                    produced[orig.id] = X.to_host_value(v)
                    if hsp:
                        hsp.set(
                            bytes_moved=bytes_of(produced[orig.id]),
                            payload=type(produced[orig.id]).__name__)
            else:
                produced[orig.id] = X.to_host_value(v)
            if is_boundary:
                payload = produced[orig.id]
                handoff_events.append({
                    "node_id": orig.id, "segment": si,
                    "payload_kind": ("table" if isinstance(payload, dict)
                                     else type(payload).__name__),
                    "device_resident": orig.id in device_resident,
                    "producer": d.cost.backend,
                    "consumers": tuple(sorted(consumers[orig.id]))})
        if backend.name not in names:
            names.append(backend.name)
    ctx._last_handoff_events = handoff_events
    ctx._last_segment_spans = segment_spans
    return results, "+".join(names) or AUTO


def _segment_subgraph(d, produced: dict[int, object]) -> list[G.Node]:
    """Rebuild one planner segment for execution: inputs living in other
    segments are replaced by ``Handoff`` leaves carrying the value the
    producing segment already materialized."""
    if not d.boundary:
        return list(d.roots)
    seg_ids = {n.id for n in d.nodes}
    memo: dict[int, G.Node] = {}

    def rec(n: G.Node) -> G.Node:
        if n.id in memo:
            return memo[n.id]
        if n.id not in seg_ids:
            key = getattr(n, "cache_key", None)
            if key is None:
                try:
                    key = n.key()
                except Exception:  # noqa: BLE001 — side-effect nodes key on id
                    key = ("handoff", n.id)
            out = G.Handoff(produced[n.id], key, producer=n.op)
        else:
            new_inputs = [rec(i) for i in n.inputs]
            if all(a is b for a, b in zip(new_inputs, n.inputs)):
                out = n
            else:
                out = G.copy_runtime_flags(n, n.with_inputs(new_inputs))
        memo[n.id] = out
        return out

    return [rec(r) for r in d.roots]


def _record_calibration(ctx, backend_name: str, est_total, raw_est_peak,
                        span) -> None:
    """THE single feed into ``StatsStore``: pair a finished engine span's
    wall time with the plan's estimated work (runtime calibration), and —
    when the engine metered its own peak — the observed peak with the
    estimated one (peak calibration)."""
    store = getattr(ctx, "stats_store", None)
    if store is None:
        return
    metrics = getattr(ctx, "metrics", None)
    store.record_runtime(backend_name, est_total, span.duration)
    if metrics is not None:
        metrics.inc("calibration.runtime_samples")
    observed_peak = getattr(ctx, "last_run_peak_bytes", 0)
    if (observed_peak and getattr(ctx, "last_run_peak_engine", None)
            == backend_name):
        span.set(peak_bytes=observed_peak)
        store.record_peak(backend_name, observed_peak, est_peak=raw_est_peak)
        if metrics is not None:
            metrics.inc("calibration.peak_samples")


def _record_runtime_sample(opt_roots, ctx, kind, backend_name: str,
                           span) -> None:
    """Calibration sample for a fixed-engine run: estimate the plan's work
    with the a-priori cost model and pair it with the span's wall time.
    Best-effort — estimation failures never affect execution."""
    store = getattr(ctx, "stats_store", None)
    if store is None:
        return
    # once an engine is well-sampled, only refresh every 8th force point —
    # plan estimation is metadata arithmetic, but sessions with many tiny
    # fixed-engine force points shouldn't pay it each time
    samples = store.runtime_samples.get(backend_name, ())
    if len(samples) >= 16 and ctx.exec_count % 8:
        return
    try:
        from .planner.cost import plan_cost
        from .planner.stats import estimate_plan
        stats = estimate_plan(opt_roots, ctx)
        est = plan_cost(opt_roots, stats, kind,
                        ctx.backend_options.get("chunk_rows", 1 << 16))
        span.set(est_work=est.total)
        _record_calibration(ctx, backend_name, est.total, est.peak_bytes,
                            span)
    except Exception:  # noqa: BLE001 — calibration is advisory
        pass
