"""Pattern-rewrite engine over the logical DAG (Dias-style, PAPERS.md:
"Dias: Dynamic Rewriting of Pandas Code").

A :class:`RewriteRule` recognizes an expensive idiom as a local node
pattern, checks the same safety conditions the optimizer's swap rules use
(single parent, no persist mark, no side effects), and produces a cheaper
equivalent subgraph.  :func:`apply_rewrites` drives the rule set to
fixpoint with the optimizer's immutable ``_rebuild`` machinery, emitting a
structured :class:`RewriteEvent` per fired rule — into the optimizer
trace (as a ``PlannerEvent`` with ``kind="rewrite"``), the
``rewrite.applied`` metric, and the pending-record list ``pd.explain()``
drains into ``RewriteRecord`` entries.

Every rule must be *semantics-preserving under this engine's operators*
(not merely pandas-plausible): the differential conformance suite runs
with rewrites on and off (``session(rewrites=False)``) and the results
must be identical.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Protocol, runtime_checkable

from .. import graph as G


@runtime_checkable
class RewriteRule(Protocol):
    """One idiom rewrite.  ``match`` is the structural pattern test,
    ``guard`` the safety conditions (parents/persist/side effects), and
    ``apply`` builds the replacement subgraph — returning ``None`` to
    decline after a deeper look (e.g. a UDF that fails to vectorize)."""

    name: str
    summary: str                        # one-liner, reused by the linter

    def match(self, n: G.Node) -> bool: ...

    def guard(self, n: G.Node, parents: dict[int, list[G.Node]]) -> bool: ...

    def apply(self, n: G.Node) -> G.Node | None: ...


@dataclasses.dataclass(frozen=True)
class RewriteEvent:
    """One fired rewrite: rule name, replaced/replacement node identity,
    and the whole-plan estimated work delta (negative = cheaper; None when
    pricing failed)."""
    rule: str
    before_id: int
    before_op: str
    after_id: int
    after_op: str
    detail: str = ""
    cost_delta: float | None = None

    def __str__(self):
        delta = ("" if self.cost_delta is None
                 else f" Δwork={self.cost_delta:+.3g}")
        det = f" ({self.detail})" if self.detail else ""
        return (f"rewrite {self.rule}: {self.before_op}#{self.before_id}"
                f" -> {self.after_op}#{self.after_id}{det}{delta}")


def consumed_ok(inner: G.Node, parents: dict[int, list[G.Node]]) -> bool:
    """Safety for a node a rewrite absorbs (it disappears from the plan):
    it must have exactly one parent (others still need its output), no
    persist mark (a planned §3.5 materialization point), and no side
    effects — the same conditions as the optimizer's ``_can_swap``."""
    return (len(parents.get(inner.id, [])) == 1
            and not inner.persist
            and not inner.has_side_effects())


def _plan_work(roots: list[G.Node], ctx) -> float | None:
    """Whole-plan estimated work on the reference capability — only the
    *delta* across one rewrite is meaningful.  Pricing failures (exotic
    sources, missing stats) return None; they must never block a rewrite."""
    try:
        from ..engines import default_registry
        from ..planner.cost import node_work
        from ..planner.stats import estimate_plan
        cap = default_registry().capability_of("eager")
        stats = estimate_plan(roots, ctx)
        return sum(node_work(n, stats, cap) for n in G.walk(roots))
    except Exception:  # noqa: BLE001 — costing is advisory
        return None


def _emit(ctx, trace, ev: RewriteEvent) -> None:
    if trace is not None:
        from ...obs.events import PlannerEvent
        trace.append(PlannerEvent(str(ev), kind="rewrite",
                                  **dataclasses.asdict(ev)))
    if ctx is None:
        return
    metrics = getattr(ctx, "metrics", None)
    if metrics is not None:
        metrics.inc("rewrite.applied")
    pending = getattr(ctx, "_pending_rewrites", None)
    if pending is None:
        pending = ctx._pending_rewrites = []
    pending.append(ev)


def default_rules() -> tuple[RewriteRule, ...]:
    from .rules import DEFAULT_RULES
    return DEFAULT_RULES


def apply_rewrites(roots: list[G.Node], ctx=None,
                   rules: Iterable[RewriteRule] | None = None,
                   trace: list | None = None
                   ) -> tuple[list[G.Node], dict[int, G.Node],
                              list[RewriteEvent]]:
    """Drive ``rules`` to fixpoint over the DAG.

    Returns ``(new_roots, idmap, events)``; the idmap composes with the
    optimizer's combined map exactly like every other pass.  One rule
    fires per iteration (the DAG is rebuilt and parents recomputed before
    the next), and the iteration guard bounds pathological rule sets the
    same way ``push_filters`` bounds itself."""
    from ..optimizer import _rebuild
    rules = tuple(rules) if rules is not None else default_rules()
    total_map: dict[int, G.Node] = {}
    events: list[RewriteEvent] = []
    changed = True
    guard = 0
    while changed and guard < 100:
        guard += 1
        changed = False
        parents = G.parents_map(roots)
        for r in roots:
            # a root is externally consumed: count that as a parent so
            # consumed_ok never lets a rule absorb it out of the plan
            parents.setdefault(r.id, []).append(r)
        for n in G.walk(roots):
            for rule in rules:
                if not rule.match(n) or not rule.guard(n, parents):
                    continue
                repl = rule.apply(n)
                if repl is None:
                    continue
                G.copy_runtime_flags(n, repl)
                before = _plan_work(roots, ctx)
                roots, m = _rebuild(roots, {n.id: repl})
                total_map.update(m)
                after = _plan_work(roots, ctx)
                delta = (after - before
                         if before is not None and after is not None
                         else None)
                detail = getattr(rule, "describe", lambda *_: "")(n, repl)
                ev = RewriteEvent(rule=rule.name, before_id=n.id,
                                  before_op=n.op, after_id=repl.id,
                                  after_op=repl.op, detail=detail,
                                  cost_delta=delta)
                events.append(ev)
                _emit(ctx, trace, ev)
                changed = True
                break
            if changed:
                break
    return roots, total_map, events
