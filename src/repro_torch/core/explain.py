"""Typed plan/run introspection: ``pd.explain()`` / ``session.report()``.

Before this module, the only way to see what AUTO did was to grep the raw
``ctx.planner_trace`` / ``ctx.fallback_trace`` strings.  ``explain``
unifies that into structured, typed records:

* :class:`SegmentRecord` — one planner segment: the chosen engine, every
  priced candidate (:class:`CandidateRecord`, chosen and rejected alike,
  with calibrated work / estimated peak / over-budget flag / reason), the
  operators it runs, and the boundary handoffs feeding it.
* :class:`HandoffRecord` — one cross-segment value: payload kind
  (``table`` / scalar type / ``ShardedTable``), whether it stayed
  device-resident, producer and consumer engines.
* :class:`FallbackRecord` — one facade fallback event (op, shape, reason,
  served/failed status).
* :class:`CalibrationRecord` — one engine's runtime/peak calibration state
  (regressed scales + sample counts).
* :class:`RunRecord` — one force point: why it fired, the requested
  engine, the engines that executed, its segments and handoffs.
* :class:`ExplainReport` — the whole story; ``render()`` (also
  ``str(report)``) produces a stable, human-readable text plan, and
  ``to_dict()`` a JSON-serializable form (the CI golden artifact).

Two entry points:

* ``explain()`` / ``explain(None)`` — report everything the current
  session ran so far (every segment, handoff, fallback event, and
  calibration scale).
* ``explain(frame)`` — *plan-only*: run the optimizer and the planner on a
  lazy frame without executing it, and report the would-be segment
  placement with full candidate pricing.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class CandidateRecord:
    """One engine priced for one segment (chosen or rejected)."""
    engine: str
    chosen: bool
    work: float | None                  # calibrated work; None → pricing failed
    peak_bytes: float | None
    over_budget: bool
    reason: str                         # "" for the chosen engine


@dataclasses.dataclass(frozen=True)
class SegmentRecord:
    """One planner segment (or the whole plan, for fixed-engine runs)."""
    index: int
    engine: str
    root_ids: tuple[int, ...]
    ops: tuple[str, ...]
    work: float | None
    peak_bytes: float | None
    scale: float
    feasible: bool
    candidates: tuple[CandidateRecord, ...]
    handoff_in: tuple[int, ...]         # boundary node ids feeding this segment
    # telemetry linkage: id of the span that timed this segment's execution
    # (repro_torch.obs) — None for plan-only reports (explain(frame))
    span_id: int | None = None


@dataclasses.dataclass(frozen=True)
class HandoffRecord:
    """One value crossing a segment boundary."""
    node_id: int
    segment: int
    payload_kind: str                   # "table" | "ShardedTable" | scalar type
    device_resident: bool
    producer: str
    consumers: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class FallbackRecord:
    op: str
    shape: tuple | None
    reason: str
    status: str                         # "fallback" (served) | "failed"


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    engine: str
    cost_scale: float | None            # seconds per work unit (None: untrusted)
    peak_scale: float | None            # observed / estimated peak ratio
    runtime_samples: int
    peak_samples: int


@dataclasses.dataclass(frozen=True)
class RewriteRecord:
    """One fired plan rewrite (repro_torch.core.rewrite): which rule replaced
    which node, and the estimated whole-plan work delta (negative =
    cheaper; None when pricing was unavailable)."""
    rule: str
    before_id: int
    before_op: str
    after_id: int
    after_op: str
    detail: str = ""
    cost_delta: float | None = None


@dataclasses.dataclass(frozen=True)
class DiagnosticRecord:
    """One pre-execution linter diagnostic (repro_torch.lint), keyed to the user
    program's source line."""
    line: int
    col: int
    kind: str                           # e.g. "fallback.materialize"
    message: str
    symbol: str = ""
    level: str = "info"                 # "info" | "warn"


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One force point (``execute()`` call)."""
    index: int
    force_reason: str
    engine: str                         # requested engine ("auto" or fixed)
    executed: tuple[str, ...]           # engines that actually ran
    segments: tuple[SegmentRecord, ...]
    handoffs: tuple[HandoffRecord, ...]
    rewrites: tuple[RewriteRecord, ...] = ()
    cached: bool = False                # plan served from the plan cache


@dataclasses.dataclass(frozen=True)
class ExplainReport:
    session: str
    engine: str                         # session engine at report time
    runs: tuple[RunRecord, ...]
    fallbacks: tuple[FallbackRecord, ...]
    calibration: tuple[CalibrationRecord, ...]
    diagnostics: tuple[DiagnosticRecord, ...] = ()
    # cumulative ``io.*`` counters at report time (partitions loaded /
    # pruned / prefetched, bytes read, pushdown row accounting)
    io_counters: dict[str, int] = dataclasses.field(default_factory=dict)

    # -- rendering ----------------------------------------------------------

    def render(self) -> str:
        """Stable text plan: one block per run, one line per segment,
        indented candidate/handoff detail."""
        lines = [f"plan session={self.session} engine={self.engine} "
                 f"runs={len(self.runs)}"]
        for run in self.runs:
            lines.append(
                f"run {run.index} ({run.force_reason}): {run.engine}"
                f" -> {'+'.join(run.executed) or '-'}"
                f"{' cached=hit' if run.cached else ''}")
            for rw in run.rewrites:
                delta = ("" if rw.cost_delta is None
                         else f" Δwork={rw.cost_delta:+.3g}")
                det = f" ({rw.detail})" if rw.detail else ""
                lines.append(
                    f"  rewrite {rw.rule}: {rw.before_op}#{rw.before_id}"
                    f" -> {rw.after_op}#{rw.after_id}{det}{delta}")
            for seg in run.segments:
                hand = ("".join(f" handoff<-#{b}" for b in seg.handoff_in)
                        if seg.handoff_in else "")
                work = "-" if seg.work is None else f"{seg.work:.3g}"
                peak = ("-" if seg.peak_bytes is None
                        else f"{seg.peak_bytes / 1e6:.1f}MB")
                span = (f" span=#{seg.span_id}"
                        if seg.span_id is not None else "")
                lines.append(
                    f"  seg{seg.index} -> {seg.engine} ops={len(seg.ops)} "
                    f"[{','.join(seg.ops)}] work={work} peak={peak} "
                    f"cal=x{seg.scale:.3g}"
                    f"{'' if seg.feasible else ' infeasible!'}{hand}{span}")
                for c in seg.candidates:
                    if c.chosen:
                        continue
                    cw = "-" if c.work is None else f"{c.work:.3g}"
                    cp = ("-" if c.peak_bytes is None
                          else f"{c.peak_bytes / 1e6:.1f}MB")
                    flag = " budget!" if c.over_budget else ""
                    reason = (f" ({c.reason})"
                              if c.work is None and c.reason else "")
                    lines.append(
                        f"    rejected {c.engine}: {cw}/{cp}{flag}{reason}")
            for h in run.handoffs:
                res = "device-resident" if h.device_resident else "host"
                lines.append(
                    f"  handoff #{h.node_id} seg{h.segment} "
                    f"payload={h.payload_kind} {res} "
                    f"{h.producer}->{'+'.join(h.consumers)}")
        if self.fallbacks:
            lines.append(f"fallbacks: {len(self.fallbacks)}")
            for f in self.fallbacks:
                shape = "x".join(map(str, f.shape)) if f.shape else "?"
                lines.append(f"  {f.status}: {f.op} [{shape}] {f.reason}")
        if self.diagnostics:
            lines.append(f"diagnostics: {len(self.diagnostics)}")
            for d in self.diagnostics:
                lines.append(f"  {d.level} L{d.line}: [{d.kind}] {d.message}")
        if self.calibration:
            parts = []
            for c in self.calibration:
                bit = f"{c.engine}"
                if c.cost_scale is not None:
                    bit += f"={c.cost_scale:.3g}s/w"
                if c.peak_scale is not None:
                    bit += f" peak=x{c.peak_scale:.3g}"
                bit += f" (n={c.runtime_samples}/{c.peak_samples})"
                parts.append(bit)
            lines.append("calibration: " + "; ".join(parts))
        if self.io_counters:
            parts = []
            for k, v in sorted(self.io_counters.items()):
                short = k.split(".", 1)[1]
                parts.append(f"{short}={v / 1e6:.1f}MB" if short == "bytes_read"
                             else f"{short}={v}")
            lines.append("io: " + " ".join(parts))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    def to_dict(self) -> dict:
        """JSON-serializable form (uploaded as a CI artifact)."""
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Record construction


def _op_label(n) -> str:
    """Operator label for plan rendering: fused segments expand their
    member ops — ``fused[filter,assign,...]`` — so a plan reader sees what
    the single node executes; scans carrying pushdown state render it —
    ``scan[cols=3,pred=2,pruned 4/16]`` — so a reader sees what never
    leaves the disk."""
    if n.op == "fused_rowwise":
        return "fused[" + ",".join(m.op for m in n.ops) + "]"
    if n.op == "scan":
        bits = []
        if n.columns is not None:
            bits.append(f"cols={len(n.columns)}")
        pushdown = getattr(n, "pushdown", None)
        if pushdown is not None:
            bits.append(f"pred={len(pushdown.conjuncts)}")
        if n.skip_partitions:
            total = getattr(n.source, "n_partitions", "?")
            bits.append(f"pruned {len(n.skip_partitions)}/{total}")
        if bits:
            return "scan[" + ",".join(bits) + "]"
    return n.op


def _candidate_records(candidates: dict[str, dict]
                       ) -> tuple[CandidateRecord, ...]:
    out = []
    for name, rec in candidates.items():
        out.append(CandidateRecord(
            engine=name, chosen=bool(rec.get("chosen")),
            work=rec.get("work"), peak_bytes=rec.get("peak_bytes"),
            over_budget=bool(rec.get("over_budget")),
            reason=rec.get("reason", "")))
    # chosen first, then alphabetical — stable regardless of registry order
    out.sort(key=lambda c: (not c.chosen, c.engine))
    return tuple(out)


def segment_records(decisions, span_ids: dict[int, int] | None = None
                    ) -> tuple[SegmentRecord, ...]:
    """Typed segments from planner ``Decision`` objects; ``span_ids`` maps
    segment index → telemetry span id for executed (not plan-only) runs."""
    span_ids = span_ids or {}
    segs = []
    for si, d in enumerate(decisions):
        segs.append(SegmentRecord(
            index=si,
            engine=str(d.backend),
            root_ids=tuple(r.id for r in d.roots),
            ops=tuple(_op_label(n) for n in d.nodes),
            work=d.cost.total,
            peak_bytes=d.cost.peak_bytes,
            scale=d.scale,
            feasible=d.feasible,
            candidates=_candidate_records(getattr(d, "candidates", {}) or {}),
            handoff_in=tuple(b.id for b in d.boundary),
            span_id=span_ids.get(si)))
    return tuple(segs)


def _drain_rewrites(ctx) -> tuple[RewriteRecord, ...]:
    """Consume the rewrite events the optimizer queued for this force
    point (``ctx._pending_rewrites``, filled by ``rewrite.apply_rewrites``)."""
    pending = getattr(ctx, "_pending_rewrites", None)
    if not pending:
        return ()
    out = tuple(RewriteRecord(
        rule=ev.rule, before_id=ev.before_id, before_op=ev.before_op,
        after_id=ev.after_id, after_op=ev.after_op, detail=ev.detail,
        cost_delta=ev.cost_delta) for ev in pending)
    pending.clear()
    return out


def record_run(ctx, force_reason: str, backend_name: str, opt_roots) -> None:
    """Append one typed RunRecord to ``ctx.run_records`` (called by
    ``runtime.execute`` after every force point)."""
    decisions = getattr(ctx, "planner_decisions", None) or []
    handoff_dicts = getattr(ctx, "_last_handoff_events", None) or []
    ctx._last_handoff_events = []
    span_ids = getattr(ctx, "_last_segment_spans", None) or {}
    ctx._last_segment_spans = {}
    if decisions:
        segments = segment_records(decisions, span_ids)
    else:
        # fixed-engine run: one synthetic segment listing the plan's ops
        from . import graph as G
        segments = (SegmentRecord(
            index=0, engine=str(backend_name),
            root_ids=tuple(r.id for r in opt_roots),
            ops=tuple(_op_label(n) for n in G.walk(opt_roots)),
            work=None, peak_bytes=None, scale=1.0, feasible=True,
            candidates=(), handoff_in=(), span_id=span_ids.get(0)),)
    handoffs = tuple(HandoffRecord(**h) for h in handoff_dicts)
    records = getattr(ctx, "run_records", None)
    if records is None:
        records = ctx.run_records = []
    records.append(RunRecord(
        index=len(records),
        force_reason=force_reason,
        engine=str(ctx.backend),
        executed=tuple(str(backend_name).split("+")),
        segments=segments,
        handoffs=handoffs,
        rewrites=_drain_rewrites(ctx),
        cached=bool(getattr(ctx, "_last_plan_cached", False))))
    if len(records) > 1024:              # bound long-lived sessions
        del records[: len(records) - 1024]


def _fallback_records(ctx) -> tuple[FallbackRecord, ...]:
    out = []
    for ev in getattr(ctx, "fallback_trace", ()):
        out.append(FallbackRecord(
            op=getattr(ev, "op", "?"),
            shape=getattr(ev, "shape", None),
            reason=getattr(ev, "reason", ""),
            status=getattr(ev, "status", "fallback")))
    return tuple(out)


def _calibration_records(ctx) -> tuple[CalibrationRecord, ...]:
    store = getattr(ctx, "stats_store", None)
    if store is None:
        return ()
    engines = sorted(set(store.runtime_samples) | set(store.peak_samples))
    out = []
    for name in engines:
        out.append(CalibrationRecord(
            engine=name,
            cost_scale=store.cost_scale(name),
            peak_scale=store.peak_scale(name),
            runtime_samples=len(store.runtime_samples.get(name, ())),
            peak_samples=len(store.peak_samples.get(name, ()))))
    return tuple(out)


def _diagnostic_records(ctx) -> tuple[DiagnosticRecord, ...]:
    """Linter diagnostics ``pd.analyze()`` attached to ``ctx.analysis``."""
    diags = (getattr(ctx, "analysis", None) or {}).get("diagnostics") or ()
    out = []
    for d in diags:
        out.append(DiagnosticRecord(
            line=getattr(d, "line", 0), col=getattr(d, "col", 0),
            kind=getattr(d, "kind", "?"), message=getattr(d, "message", ""),
            symbol=getattr(d, "symbol", ""),
            level=getattr(d, "level", "info")))
    return tuple(out)


def _io_counter_snapshot(ctx) -> dict[str, int]:
    metrics = getattr(ctx, "metrics", None)
    if metrics is None:
        return {}
    return {k: v for k, v in metrics.snapshot().items()
            if k.startswith("io.")}


def build_report(ctx) -> ExplainReport:
    """Typed report of everything ``ctx`` ran so far."""
    return ExplainReport(
        session=getattr(ctx, "session_name", "?"),
        engine=str(ctx.backend),
        runs=tuple(getattr(ctx, "run_records", ()) or ()),
        fallbacks=_fallback_records(ctx),
        calibration=_calibration_records(ctx),
        diagnostics=_diagnostic_records(ctx),
        io_counters=_io_counter_snapshot(ctx))


def explain(obj=None, ctx=None) -> ExplainReport:
    """Structured plan/run introspection.

    ``explain()`` reports the current session's history: every force
    point's segments (chosen engine + rejected candidates + costs),
    handoff payload kinds, fallback events, and calibration scales.

    ``explain(frame)`` plans a lazy frame **without executing it**: the
    optimizer and the cost-based planner run, and the report contains the
    would-be placement (one planned run, no handoffs/fallbacks)."""
    from .context import get_context
    ctx = ctx if ctx is not None else get_context()
    if obj is None:
        return build_report(ctx)
    node = getattr(obj, "_node", None)
    if node is None and hasattr(obj, "frame"):      # LazyColumn
        node = getattr(obj.frame, "_node", None)
    if node is None:
        node = obj
    from .optimizer import optimize
    from .planner.select import plan_placement
    saved_trace = ctx.planner_trace
    ctx.planner_trace = []
    try:
        roots, _ = optimize([node], ctx)
        decisions = plan_placement(roots, ctx)
    finally:
        ctx.planner_trace = saved_trace
    run = RunRecord(
        index=0, force_reason="explain", engine=str(ctx.backend),
        executed=(), segments=segment_records(decisions), handoffs=(),
        rewrites=_drain_rewrites(ctx))
    return ExplainReport(
        session=getattr(ctx, "session_name", "?"),
        engine=str(ctx.backend),
        runs=(run,),
        fallbacks=(),
        calibration=_calibration_records(ctx),
        diagnostics=_diagnostic_records(ctx))
