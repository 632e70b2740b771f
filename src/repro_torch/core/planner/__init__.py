"""Cost-based adaptive planner (beyond-paper subsystem).

The paper's headline claim is that a lazy dataframe system "allows the
choice of the best-suited backend for an application based on factors such
as data size" — this package is that choice, made mechanical.  It turns the
manual engine knob into ``"auto"``: at every force point the runtime
estimates the plan, prices it per registered engine, and dispatches to the
cheapest engine whose footprint fits the memory budget.

Candidates, capabilities, cost constants, and calibration namespaces all
flow from the open engine registry (``repro_torch.core.engines``): nothing in
this package names a concrete engine, so engines added at runtime via
``repro_torch.register_engine`` (or the ``repro_torch.engines`` entry-point group) are
planned, priced, and calibrated exactly like the in-tree ones.

Design record
=============

Four layers, each usable on its own:

``stats``
    Cardinality/width estimation.  Leaf statistics come from what the
    engine already maintains for free: partition metas (row counts), zone
    maps (per-partition min/max), and dictionary vocabularies (exact NDV
    for encoded string columns).  ``estimate_plan`` propagates a
    ``TableStats`` (rows, per-column byte widths, NDVs, merged zone map)
    through every DAG node.  ``Filter`` nodes use selectivity estimation:
    range predicates interpolate against the zone map, equality predicates
    use 1/NDV, conjunction multiplies, disjunction adds (inclusion–
    exclusion).  Joins use the classic |L|·|R|/max(ndv_L, ndv_R) rule;
    group-bys cap output rows at the key-NDV product.

``cost``
    A per-operator, per-engine cost function over those stats.  Engines
    publish a ``BackendCapability`` descriptor at registration: supported
    ops, startup overhead, per-byte scan cost, per-row compute cost,
    effective parallelism, transfer cost, and a fallback penalty so ops an
    engine must gather-and-delegate are priced in rather than forbidden.
    ``plan_cost`` also simulates peak memory per the capability's declared
    ``peak_model``: the resident model replays a refcounted topological
    walk; the chunked model charges chunk-sized flow plus pipeline-breaker
    state (join build sides, group-by partials, sort materialization); the
    sharded model divides resident bytes across shards until the first
    fallback gathers.

``select``
    ``"auto"`` resolution: operator-granular hybrid placement.
    ``plan_placement`` prices every operator on every candidate engine and
    partitions the DAG into engine *segments* via a min-cut style dynamic
    program with an explicit transfer charge at cut edges (the cost of
    materializing a boundary and re-ingesting it in the next engine).  Each
    segment then picks the cheapest calibrated engine whose estimated peak
    fits ``ctx.memory_budget`` (falling back to the lowest-footprint engine
    when nothing fits, flagged ``feasible=False``); engines the model
    cannot price are rejected with the recorded reason, never silently
    dropped.  Segments execute in topological order chained by
    ``graph.Handoff`` pipe breakers.  The PR-1 per-root-subtree strategy
    remains selectable via ``ctx.backend_options["placement"]="per_root"``.
    Every segment appends a human-readable line to ``ctx.planner_trace``
    ("plan-choice trace") and a typed ``Decision.candidates`` record
    (rendered by ``repro_torch.core.explain`` / ``pd.explain()``):
      auto: seg0 root#7 ops=3 -> engineA cost=1.2e+05 peak=3.1MB cal=x1 (...)

``feedback``
    The paper's "runtime optimization" leg, twice over.  After execution
    the runtime records actual cardinalities/bytes into ``ctx.stats_store``
    keyed by each node's *structural* key, plus per-engine observed peaks
    — the next estimate of the same (sub)plan overrides the a-priori guess.
    Every run additionally records an (estimated work, wall seconds) sample
    per engine; once ``MIN_RUNTIME_SAMPLES`` accumulate, ``cost_scale``
    regresses (least squares through the origin) the engine's
    seconds-per-work-unit and the selector compares *calibrated* costs, so
    cost constants converge to measured values on this machine.

``plancache``
    Serving-path amortization: the optimized plan (and its segment
    decisions) cached under a structural fingerprint + stats epoch, so a
    repeated plan shape skips optimize/rewrite/segment-DP entirely and
    rebinds cached segments to fresh sources.  Source ``cache_token``s are
    deliberately excluded from the key — the same program over new data
    hits.

The planner never changes results — only where they are computed.  It
reads the optimized DAG (after pushdown/pruning), so its stats reflect
what will actually run.
"""
from .cost import CostEstimate, node_work, plan_cost, transfer_cost
from .feedback import MIN_RUNTIME_SAMPLES, StatsStore, record_execution
from .plancache import (PlanCache, Uncacheable, cache_key,
                        default_plan_cache, plan_fingerprint, stats_epoch)
from .select import (Decision, calibration_scales, candidate_engines,
                     plan_placement)
from .stats import TableStats, estimate_plan, predicate_selectivity, source_stats

__all__ = [
    "CostEstimate", "plan_cost", "node_work", "transfer_cost",
    "StatsStore", "record_execution", "MIN_RUNTIME_SAMPLES",
    "Decision", "plan_placement", "calibration_scales", "candidate_engines",
    "TableStats", "estimate_plan", "predicate_selectivity", "source_stats",
    "PlanCache", "Uncacheable", "cache_key", "default_plan_cache",
    "plan_fingerprint", "stats_epoch",
]
