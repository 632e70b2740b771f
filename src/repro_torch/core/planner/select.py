"""AUTO engine selection: operator-granular hybrid placement with
runtime-calibrated costs.

The optimized DAG is partitioned into engine *segments* — connected groups
of operators assigned to one engine — by a min-cut style dynamic program
over per-node per-engine costs with an explicit transfer charge for
materializing at segment boundaries (``cost.transfer_cost``).  Segments
execute in topological order; values crossing a boundary are materialized
to host and re-enter the next segment as ``graph.Handoff`` leaves
(``runtime._dispatch`` chains them).

Candidate engines come from the open registry (``repro_torch.core.engines``):
every registered engine — in-tree or plug-in — is priced by its declared
``BackendCapability``, and ``ctx.engine_allowlist`` (``session(engines=
(...,))``) restricts the candidate set per session.  Calibration keys and
stats-store namespaces are the engines' registry names, so a runtime-
registered engine calibrates exactly like a built-in.

Costs are calibrated: once ``ctx.stats_store`` holds enough observed
(estimated-work, wall-seconds) samples for an engine
(``feedback.MIN_RUNTIME_SAMPLES``), its cost constants are scaled by the
regressed seconds-per-work-unit, so repeated workloads converge to measured
— not guessed — constants.

The plan-choice trace (``ctx.planner_trace``) records one line per segment
(engine names are whatever the registry holds):

    auto: seg0 root#12 ops=4 -> engineA cost=2.1e+05 peak=3.4MB cal=x1 |
    engineB 5.0e+05/0.3MB, engineC 8.7e+05/0.9MB

Read it as: segment 0 (4 operators, output node 12) dispatched to engineA
with calibrated work 2.1e5 and estimated peak 3.4 MB; rejected candidates
follow with their work/peak.  ``budget!`` marks candidates rejected for
exceeding ``ctx.memory_budget``; ``pricing-failed:`` marks candidates the
cost model could not price (with the reason — never silently dropped).
Segments with cross-segment inputs append ``handoff<-#id`` markers; at
execution time ``runtime.execute_segments`` adds one line per boundary
value kept device-resident (``payload=ShardedTable``), and when peak
calibration is active an ``auto: peak-calibration`` summary precedes the
segments.  The same information is available as typed records through
``repro_torch.core.explain`` (``Decision.candidates`` feeds it).

``ctx.backend_options["placement"]`` selects the strategy: ``"operator"``
(default, segments) or ``"per_root"`` (the PR-1 behaviour: one choice per
root subtree; kept for regret comparisons in
``benchmarks/run.py backend_selection``).
"""
from __future__ import annotations

import dataclasses

from .. import graph as G
from ..engines import default_registry
from .cost import CostEstimate, node_work, plan_cost, transfer_cost
from .stats import estimate_plan


def candidate_engines(ctx=None) -> tuple[str, ...]:
    """Engine names the planner may choose from: every registered engine,
    filtered by the session's allow-list when one is set.

    An allow-list that matches *no* registered engine is an error, not a
    silent fall-through — otherwise a typo'd ``session(engines=(...))``
    would dispatch to exactly the engines the user tried to exclude."""
    from ..engines import UnknownEngineError
    names = default_registry().names()
    allow = getattr(ctx, "engine_allowlist", None) if ctx is not None else None
    if allow:
        allowed = tuple(n for n in names if n in allow)
        if not allowed:
            raise UnknownEngineError(
                f"engine allow-list {tuple(allow)!r} matches no registered "
                f"engine; registered engines: {list(names)}")
        return allowed
    return names


@dataclasses.dataclass
class Decision:
    """One planner segment: a connected group of operators dispatched to one
    engine.  ``roots`` are the segment's outputs (nodes consumed by other
    segments, or plan roots); ``nodes`` is every operator the segment runs;
    ``boundary`` lists cross-segment inputs that arrive as handoffs.
    ``candidates`` holds one structured record per priced engine (chosen
    and rejected alike) — the typed source for ``pd.explain()``."""
    roots: list                          # segment output nodes
    backend: str                         # engine name (registry key)
    cost: CostEstimate
    rejected: dict[str, str]             # engine name -> reason string
    nodes: list = dataclasses.field(default_factory=list)
    boundary: list = dataclasses.field(default_factory=list)
    feasible: bool = True                # est. peak fits ctx.memory_budget
    scale: float = 1.0                   # calibrated sec/work for the engine
    # engine name -> {"work", "peak_bytes", "over_budget", "chosen",
    #                 "reason"} (work/peak None when pricing failed)
    candidates: dict[str, dict] = dataclasses.field(default_factory=dict)


def _caps(cands: tuple[str, ...]):
    reg = default_registry()
    return {kind: reg.capability_of(kind) for kind in cands}


def calibration_scales(ctx, cands: tuple[str, ...] | None = None
                       ) -> dict[str, float]:
    """Per-engine cost multipliers regressed from observed runtimes.

    Engines with enough samples get their measured seconds-per-work-unit;
    engines not yet observed get the median of the known scales (so all
    candidates stay comparable); with no observations at all, every scale
    is 1.0 and costs compare raw — exactly the uncalibrated model."""
    cands = cands if cands is not None else candidate_engines(ctx)
    store = getattr(ctx, "stats_store", None)
    known = store.calibration() if store is not None else {}
    if not known:
        return {kind: 1.0 for kind in cands}
    ordered = sorted(known.values())
    default = ordered[len(ordered) // 2]
    return {kind: known.get(kind, default) for kind in cands}


def _price(roots: list[G.Node], boundary_ids: frozenset[int], stats,
           budget, chunk_rows, scales, cands,
           preferred: str | None = None,
           peak_scales: dict[str, float] | None = None,
           sharded_boundary: frozenset[int] = frozenset()) -> Decision:
    """Price one segment on every candidate engine and decide.

    An engine the cost model cannot price is *not* silently dropped: the
    failure reason is recorded in ``Decision.rejected``.  ``preferred``
    (the min-cut assignment) wins when it is budget-feasible; otherwise the
    cheapest calibrated feasible candidate; if nothing fits the budget, the
    smallest-footprint engine survives and ``feasible=False``.

    ``peak_scales`` are the measured observed/estimated peak ratios
    (``StatsStore.peak_scale``): candidate peak estimates are recalibrated
    by them before the budget check, the same way runtime scales calibrate
    work.  ``sharded_boundary`` marks handoff inputs arriving as
    device-resident payloads (only meaningful for candidates whose
    capability ``keeps_device_payloads``)."""
    caps = _caps(cands)
    costs: dict[str, CostEstimate] = {}
    rejected: dict[str, str] = {}
    cand_records: dict[str, dict] = {}
    for kind in cands:
        try:
            sb = (sharded_boundary if caps[kind].keeps_device_payloads
                  else frozenset())
            costs[kind] = plan_cost(roots, stats, kind, chunk_rows,
                                    boundary=boundary_ids,
                                    sharded_boundary=sb)
            costs[kind].raw_peak_bytes = costs[kind].peak_bytes
            ps = (peak_scales or {}).get(caps[kind].name)
            if ps is not None:
                costs[kind].peak_bytes *= ps     # calibrated peak estimate
        except Exception as e:  # noqa: BLE001 — reason recorded, not dropped
            reason = (f"{caps[kind].name} pricing-failed: "
                      f"{type(e).__name__}: {e}")
            rejected[caps[kind].name] = reason
            cand_records[caps[kind].name] = {
                "work": None, "peak_bytes": None, "over_budget": False,
                "chosen": False, "reason": reason}
    if not costs:
        raise RuntimeError(
            f"no engine could price this plan: {rejected}")
    feasible = {k: c for k, c in costs.items()
                if budget is None or c.peak_bytes <= budget}
    ok = True
    if preferred in feasible:
        best = preferred
    elif feasible:
        best = min(feasible, key=lambda k: costs[k].total * scales[k])
    else:
        # nothing fits: take the smallest-footprint engine (a chunked-model
        # engine is the usual survivor) and let the meter arbitrate
        best = min(costs, key=lambda k: costs[k].peak_bytes)
        ok = False
    for k, c in costs.items():
        over = budget is not None and c.peak_bytes > budget
        cand_records[c.backend] = {
            "work": c.total * scales[k], "peak_bytes": c.peak_bytes,
            "over_budget": over, "chosen": k is best,
            "reason": "" if k is best else (
                f"{c.backend} {c.total * scales[k]:.3g}"
                f"/{c.peak_bytes / 1e6:.1f}MB" + (" budget!" if over else ""))}
        if k is best:
            continue
        rejected[c.backend] = cand_records[c.backend]["reason"]
    return Decision(list(roots), best, costs[best], rejected,
                    feasible=ok, scale=scales[best],
                    candidates=cand_records)


# ---------------------------------------------------------------------------
# Per-root placement (PR-1 behaviour, kept for regret comparison)


def _per_root_placement(roots, stats, budget, chunk_rows, scales, cands,
                        peak_scales=None):
    per_root = [_price([r], frozenset(), stats, budget, chunk_rows, scales,
                       cands, peak_scales=peak_scales)
                for r in roots]
    # group same-engine decisions (first-appearance order; safe — at most
    # one root carries the ordered sink chain)
    merged: list[Decision] = []
    by_backend: dict[str, Decision] = {}
    for d in per_root:
        prev = by_backend.get(d.backend)
        if prev is not None:
            prev.roots.extend(d.roots)
            prev.cost = CostEstimate(
                prev.cost.backend, prev.cost.total + d.cost.total,
                max(prev.cost.peak_bytes, d.cost.peak_bytes),
                {**prev.cost.per_node, **d.cost.per_node},
                raw_peak_bytes=max(
                    prev.cost.raw_peak_bytes or prev.cost.peak_bytes,
                    d.cost.raw_peak_bytes or d.cost.peak_bytes))
            prev.feasible = prev.feasible and d.feasible
        else:
            by_backend[d.backend] = d
            merged.append(d)
    if len(merged) > 1:
        seen: dict[int, int] = {}
        overlap = False
        for gi, d in enumerate(merged):
            for n in G.walk(d.roots):
                if seen.setdefault(n.id, gi) != gi:
                    overlap = True
                    break
            if overlap:
                break
        if overlap:
            # subtrees assigned to different engines share nodes — hybrid
            # per-root placement would run the shared work once per group,
            # so fall back to a single whole-plan choice
            merged = [_price(roots, frozenset(), stats, budget, chunk_rows,
                             scales, cands, peak_scales=peak_scales)]
    for d in merged:
        d.nodes = G.walk(d.roots)
    return merged


# ---------------------------------------------------------------------------
# Operator-granular placement (min-cut DP + acyclic segment formation)


def _assign_operators(order, roots, stats, scales, caps):
    """Min-cut style assignment: bottom-up DP minimizing calibrated node
    work plus transfer charges at engine-boundary edges.  Multi-parent
    nodes (and roots that are also consumed elsewhere) are fixed at their
    own subtree optimum so shared work is priced exactly once.  Returns
    (assignment node-id -> engine name, pricing-failure reasons)."""
    errors: dict[str, str] = {}
    w: dict[int, dict[str, float]] = {}
    for n in order:
        w[n.id] = {}
        for kind, cap in caps.items():
            try:
                # amortize the engine's fixed startup over the plan so the
                # per-node DP sees the same constant plan_cost charges once
                # per segment (extra segments pay it again via transfer)
                w[n.id][kind] = (node_work(n, stats, cap)
                                 + cap.startup_cost / len(order)) * scales[kind]
            except Exception as e:  # noqa: BLE001 — reason surfaces in trace
                errors.setdefault(cap.name, (
                    f"{cap.name} pricing-failed: {type(e).__name__}: {e}"))
        if not w[n.id]:
            raise RuntimeError(f"no engine can price node {n!r}: {errors}")

    parents: dict[int, int] = {}
    for n in order:
        for i in n.inputs:
            parents[i.id] = parents.get(i.id, 0) + 1
    for r in roots:
        parents[r.id] = parents.get(r.id, 0) + 1   # the caller consumes roots

    def _transfer(child, b_from, b_to):
        work = transfer_cost(stats[child.id].total_bytes,
                             caps[b_from], caps[b_to])
        return work * 0.5 * (scales[b_from] + scales[b_to])

    dp: dict[int, dict[str, float]] = {}
    choice: dict[int, dict[str, dict[int, str]]] = {}
    fixed: dict[int, str] = {}
    for n in order:
        dp[n.id] = {}
        choice[n.id] = {}
        for b in w[n.id]:
            tot = w[n.id][b]
            ch: dict[int, str] = {}
            for i in n.inputs:
                if i.id in fixed:
                    bi = fixed[i.id]
                    tot += 0.0 if bi == b else _transfer(i, bi, b)
                    ch[i.id] = bi
                else:
                    best_b, best_c = None, float("inf")
                    for bi, ci in dp[i.id].items():
                        c = ci + (0.0 if bi == b else _transfer(i, bi, b))
                        if c < best_c:
                            best_c, best_b = c, bi
                    tot += best_c
                    ch[i.id] = best_b
            dp[n.id][b] = tot
            choice[n.id][b] = ch
        if parents.get(n.id, 0) > 1:
            fixed[n.id] = min(dp[n.id], key=dp[n.id].get)

    assign: dict[int, str] = dict(fixed)

    def backtrack(n: G.Node, b: str):
        for i in n.inputs:
            bi = choice[n.id][b][i.id]
            if i.id not in assign:
                assign[i.id] = bi
                backtrack(i, bi)
            elif i.id in fixed and i.id not in _expanded:
                _expanded.add(i.id)
                backtrack(i, assign[i.id])

    _expanded: set[int] = set()
    for r in roots:
        if r.id not in assign:
            assign[r.id] = min(dp[r.id], key=dp[r.id].get)
        if r.id not in _expanded:
            _expanded.add(r.id)
            backtrack(r, assign[r.id])
    return assign, errors


def _form_segments(order, assign):
    """Group same-engine connected operators into segments, keeping the
    segment graph acyclic: a node may join an input's segment only if no
    other input segment transitively depends on it."""
    seg_of: dict[int, int] = {}
    seg_nodes: list[list[G.Node]] = []
    seg_backend: list[str] = []
    seg_deps: list[set[int]] = []        # direct segment dependencies

    def depends_on(s: int, t: int) -> bool:
        """True if segment s (transitively) depends on segment t."""
        stack, seen = [s], set()
        while stack:
            x = stack.pop()
            if x == t:
                return True
            if x in seen:
                continue
            seen.add(x)
            stack.extend(seg_deps[x])
        return False

    for n in order:
        b = assign[n.id]
        joined = None
        for i in n.inputs:
            s = seg_of[i.id]
            if seg_backend[s] != b:
                continue
            if any(seg_of[j.id] != s and depends_on(seg_of[j.id], s)
                   for j in n.inputs):
                continue                 # joining would create a cycle
            joined = s
            break
        if joined is None:
            joined = len(seg_nodes)
            seg_nodes.append([])
            seg_backend.append(b)
            seg_deps.append(set())
        seg_of[n.id] = joined
        seg_nodes[joined].append(n)
        for i in n.inputs:
            s = seg_of[i.id]
            if s != joined:
                seg_deps[joined].add(s)
    return seg_of, seg_nodes, seg_backend, seg_deps


def _topo_segments(seg_nodes, seg_deps):
    """Topological order of segments (producers before consumers)."""
    remaining = {s: set(d) for s, d in enumerate(seg_deps)}
    out: list[int] = []
    ready = [s for s, d in remaining.items() if not d]
    while ready:
        s = min(ready)                    # deterministic order
        ready.remove(s)
        out.append(s)
        for t, deps in remaining.items():
            if s in deps:
                deps.discard(s)
                if not deps and t not in out and t not in ready:
                    ready.append(t)
    assert len(out) == len(seg_nodes), "segment graph has a cycle"
    return out


def _operator_placement(roots, stats, budget, chunk_rows, scales, cands,
                        peak_scales=None):
    order = G.walk(roots)
    caps = _caps(cands)
    try:
        assign, errors = _assign_operators(order, roots, stats, scales, caps)
    except RuntimeError:
        # some operator priced on no engine: whole-plan choice decides
        return [_price(roots, frozenset(), stats, budget, chunk_rows,
                       scales, cands, peak_scales=peak_scales)]
    seg_of, seg_nodes, seg_backend, seg_deps = _form_segments(order, assign)
    root_ids = {r.id for r in roots}
    consumed_outside: dict[int, bool] = {}
    consumer_backends: dict[int, set] = {}
    for n in order:
        for i in n.inputs:
            if seg_of[i.id] != seg_of[n.id]:
                consumed_outside[i.id] = True
                consumer_backends.setdefault(i.id, set()).add(assign[n.id])
    # a cross-segment value stays device-resident iff its producing engine
    # keeps device payloads and *every* consumer (and no final root) runs
    # the same engine — mirroring runtime.execute_segments' keep rule
    device_resident = {
        nid for nid, bs in consumer_backends.items()
        if caps[assign[nid]].keeps_device_payloads
        and nid not in root_ids
        and all(b == assign[nid] for b in bs)}
    decisions: list[Decision] = []
    for s in _topo_segments(seg_nodes, seg_deps):
        nodes = seg_nodes[s]
        node_ids = {n.id for n in nodes}
        outputs = [n for n in nodes
                   if consumed_outside.get(n.id) or n.id in root_ids]
        boundary = []
        seen_b: set[int] = set()
        for n in nodes:
            for i in n.inputs:
                if i.id not in node_ids and i.id not in seen_b:
                    seen_b.add(i.id)
                    boundary.append(i)
        sharded_b = (frozenset(seen_b & device_resident)
                     if caps[seg_backend[s]].keeps_device_payloads
                     else frozenset())
        d = _price(outputs, frozenset(seen_b), stats, budget, chunk_rows,
                   scales, cands, preferred=seg_backend[s],
                   peak_scales=peak_scales, sharded_boundary=sharded_b)
        d.nodes = nodes
        d.boundary = boundary
        # per-node pricing failures excluded an engine from the assignment
        # DP — surface them over the generic segment-level rejection
        d.rejected.update({k: v for k, v in errors.items()
                           if k != d.cost.backend})
        for k, v in errors.items():
            if k != d.cost.backend and k not in d.candidates:
                d.candidates[k] = {
                    "work": None, "peak_bytes": None, "over_budget": False,
                    "chosen": False, "reason": v}
        decisions.append(d)
    return decisions


# ---------------------------------------------------------------------------
# Entry point


def plan_placement(roots: list[G.Node], ctx) -> list[Decision]:
    """Partition the optimized plan into engine segments (topological
    order).  ``ctx.backend_options["placement"]`` picks the strategy:
    operator-granular segments (default) or the legacy per-root-subtree
    hybrid.  Candidates come from the engine registry, filtered by the
    session allow-list."""
    stats = estimate_plan(roots, ctx)
    budget = ctx.memory_budget
    chunk_rows = ctx.backend_options.get("chunk_rows", 1 << 16)
    cands = candidate_engines(ctx)
    scales = calibration_scales(ctx, cands)
    store = getattr(ctx, "stats_store", None)
    peak_scales = store.peak_calibration() if store is not None else {}
    mode = ctx.backend_options.get("placement", "operator")
    if mode == "per_root":
        decisions = _per_root_placement(roots, stats, budget, chunk_rows,
                                        scales, cands, peak_scales)
    else:
        decisions = _operator_placement(roots, stats, budget, chunk_rows,
                                        scales, cands, peak_scales)
    # only genuinely measured engines appear in the calibration line —
    # unmeasured candidates are priced at the median of the known scales,
    # and printing that default as if profiled would mislead debugging
    from ...obs.events import PlannerEvent
    measured = store.calibration() if store is not None else {}
    if measured:
        ctx.planner_trace.append(PlannerEvent(
            "auto: calibration " + " ".join(
                f"{name}={v:.3g}s/w" for name, v in sorted(measured.items())),
            kind="calibration", scales=dict(measured)))
    if peak_scales:
        ctx.planner_trace.append(PlannerEvent(
            "auto: peak-calibration " + " ".join(
                f"{name}=x{v:.3g}" for name, v in sorted(peak_scales.items())),
            kind="peak-calibration", scales=dict(peak_scales)))
    for si, d in enumerate(decisions):
        ids = ",".join(f"#{r.id}" for r in d.roots)
        alts = ", ".join(d.rejected.values()) or "-"
        hand = ("".join(f" handoff<-#{b.id}" for b in d.boundary)
                if d.boundary else "")
        cal = f"cal=x{d.scale:.3g}"
        if measured and d.cost.backend not in measured:
            cal += "(default)"
        ctx.planner_trace.append(PlannerEvent(
            f"auto: seg{si} root{ids} ops={len(d.nodes)} -> {d.cost.backend} "
            f"cost={d.cost.total * d.scale:.3g} "
            f"peak={d.cost.peak_bytes / 1e6:.1f}MB {cal}"
            f"{hand} | {alts}",
            kind="segment", segment=si, engine=str(d.cost.backend),
            cost=d.cost.total * d.scale, peak_bytes=d.cost.peak_bytes,
            root_ids=tuple(r.id for r in d.roots),
            boundary=tuple(b.id for b in d.boundary)))
    return decisions
