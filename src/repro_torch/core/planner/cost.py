"""Per-operator, per-engine cost model over ``TableStats``.

Costs are unitless "work" numbers — only comparisons between engines on
the *same* plan matter.  Every engine's constants live in the
``BackendCapability`` it registered with (``repro_torch.core.engines``);
unsupported ops are priced via the fallback penalty plus a gather charge,
mirroring the engines' actual convert-and-delegate fallback paths.

Peak-memory models follow the capability's ``peak_model`` declaration:

* ``"resident"`` — refcounted topological walk: every node's output is
                   resident until its last consumer ran (exactly what a
                   whole-table executor frees).
* ``"chunked"``  — chunk-sized flow for row-wise ops plus pipeline-breaker
                   state: join build sides, group-by partial aggregates,
                   sort materialization, shared-node memoization.
* ``"sharded"``  — resident-model bytes divided across the engine's
                   ``shard_count()`` for all-native segments; the first
                   fallback (or a host-materialized boundary input)
                   gathers the whole table on one host.

Nothing in this module names a concrete engine: candidates, constants, and
model selection all flow from the registry.
"""
from __future__ import annotations

import dataclasses
import math

from .. import graph as G
from ..engines import default_registry
from .stats import TableStats

_LOG_OPS = ("sort_values", "drop_duplicates")  # n log n ops
_BREAKERS = ("sort_values", "groupby_agg", "join", "drop_duplicates",
             "top_k")


@dataclasses.dataclass
class CostEstimate:
    backend: str
    total: float                         # unitless work
    peak_bytes: float                    # estimated resident high-water mark
    per_node: dict[int, float]           # node id -> work contribution
    # pre-calibration peak: ``peak_bytes`` may be rescaled by the measured
    # peak_scale (select._price); calibration samples must pair the *raw*
    # model estimate with the observed peak, or the regression would chase
    # its own output back toward 1
    raw_peak_bytes: float | None = None

    def __repr__(self):
        return (f"<Cost {self.backend} total={self.total:.3g} "
                f"peak={self.peak_bytes / 1e6:.1f}MB>")


def node_work(n: G.Node, stats: dict[int, TableStats], cap) -> float:
    """Estimated work for one operator on one engine (public: the
    operator-granular planner prices nodes individually)."""
    st = stats[n.id]
    in_rows = sum(stats[i.id].rows for i in n.inputs)
    if isinstance(n, G.Scan):
        # price bytes-actually-read: pruned partitions and projected-away
        # columns cost nothing; a pushed-down predicate adds its mask
        # evaluation over every decoded row
        from .stats import scan_read_profile
        prof = scan_read_profile(n)
        if prof is None:
            return st.total_bytes * cap.scan_cost_per_byte
        read_rows, read_bytes = prof
        work = read_bytes * cap.scan_cost_per_byte
        if n.pushdown is not None:
            work += read_rows * cap.row_cost
        return work
    if isinstance(n, (G.Materialized, G.SinkPrint, G.Handoff)):
        return 0.0
    if isinstance(n, G.Join):
        return _join_work(n, stats, cap)
    if isinstance(n, G.FusedRowwise):
        return _fused_work(n, stats, cap)
    rows = max(in_rows, st.rows, 1.0)
    work = rows * cap.row_cost
    if isinstance(n, G.TopK):
        # heap/partial-sort: linear selection over the input, log factor
        # only in the kept k rows — ≪ a full sort's log2(rows)
        work *= max(1.0, math.log2(min(float(n.n), rows) + 2.0))
    elif n.op in _LOG_OPS:
        work *= max(1.0, math.log2(rows + 1))
    native = n.op in cap.native_ops
    if native:
        work /= cap.parallelism
    else:
        in_bytes = sum(stats[i.id].total_bytes for i in n.inputs)
        work = work * cap.fallback_penalty + in_bytes * cap.transfer_cost_per_byte
    return work


# per-member compute discount inside a fused chain: members run in one
# dispatch with no intermediate tables, so each costs a fraction of a
# stand-alone rowwise op
_FUSED_MEMBER_DISCOUNT = 0.25


def _fused_work(n: "G.FusedRowwise", stats: dict[int, TableStats],
                cap) -> float:
    """One pass over the child plus summed (discounted) per-member compute —
    strictly below the op-at-a-time sum for any chain of ≥ 2 members, so
    placement never penalizes a fused segment."""
    in_st = stats[n.inputs[0].id]
    rows = max(in_st.rows, stats[n.id].rows, 1.0)
    work = rows * cap.row_cost * (1.0 + _FUSED_MEMBER_DISCOUNT * len(n.ops))
    if n.op in cap.native_ops:
        return work / cap.parallelism
    return (work * cap.fallback_penalty
            + in_st.total_bytes * cap.transfer_cost_per_byte)


def _join_work(n: G.Join, stats: dict[int, TableStats], cap) -> float:
    """Joins are costed by *build side* (hash-join model): linear probe and
    output plus an n-log-n build on the (right) build side only.  Engines
    with an exchange-based join (``cap.broadcast_join_bytes > 0``) add the
    data movement their strategy implies — replicating the build side when
    it fits the broadcast threshold, an all-to-all shuffle of both sides
    otherwise — so the planner can prefer the exchange engine exactly when
    the build side is small."""
    probe, build = stats[n.inputs[0].id], stats[n.inputs[1].id]
    out_rows = max(stats[n.id].rows, 1.0)
    work = (max(probe.rows, 1.0) + out_rows) * cap.row_cost
    work += (max(build.rows, 1.0) * cap.row_cost
             * max(1.0, math.log2(build.rows + 2)))
    if "join" in cap.native_ops:
        work /= cap.parallelism
        if cap.broadcast_join_bytes:
            if build.total_bytes <= cap.broadcast_join_bytes:
                # broadcast-hash: replicate the small build side
                work += build.total_bytes * cap.transfer_cost_per_byte
            else:
                # shuffle exchange of both sides
                work += ((probe.total_bytes + build.total_bytes)
                         * cap.transfer_cost_per_byte)
    else:
        in_bytes = probe.total_bytes + build.total_bytes
        work = work * cap.fallback_penalty + in_bytes * cap.transfer_cost_per_byte
    return work


def bounded_walk(roots: list[G.Node],
                 boundary: frozenset[int]) -> list[G.Node]:
    """Post-order walk that does not descend past ``boundary`` nodes —
    they are included as leaves (a segment sees its cross-segment inputs
    as already-materialized handoffs)."""
    seen: set[int] = set()
    order: list[G.Node] = []

    def rec(n: G.Node):
        if n.id in seen:
            return
        seen.add(n.id)
        if n.id not in boundary:
            for i in n.inputs:
                rec(i)
        order.append(n)

    for r in roots:
        rec(r)
    return order


def _resident_peak(order, roots, stats) -> float:
    """Replay a whole-table executor's refcounted walk on estimated sizes."""
    refcount: dict[int, int] = {}
    for n in order:
        for i in n.inputs:
            refcount[i.id] = refcount.get(i.id, 0) + 1
    root_ids = {r.id for r in roots}
    resident: dict[int, float] = {}
    peak = 0.0
    for n in order:
        resident[n.id] = stats[n.id].total_bytes
        peak = max(peak, sum(resident.values()))
        for i in n.inputs:
            refcount[i.id] -= 1
            if refcount[i.id] == 0 and i.id not in root_ids:
                resident.pop(i.id, None)
    return peak


_ROWWISE = ("filter", "project", "assign", "rename", "astype", "fillna",
            "map_rows", "head", "fused_rowwise")


def _chunked_peak(order, roots, stats, chunk_rows: int,
                  boundary: frozenset[int] = frozenset()) -> float:
    """Chunked flow + breaker state, as a partition-at-a-time executor
    accounts it.

    Scans stream at *source partition* granularity; row-wise ops keep their
    input's flow size (scaled by their row ratio); everything else
    re-chunks at ``chunk_rows``.  Pipeline breakers add long-lived state.
    ``boundary`` nodes are segment handoffs: their table is fully resident
    host memory for the segment's lifetime and re-streams in chunks.
    """
    parents: dict[int, int] = {}
    for n in order:
        for i in n.inputs:
            parents[i.id] = parents.get(i.id, 0) + 1
    root_ids = {r.id for r in roots}
    state = 0.0                    # long-lived breaker/memo state
    max_flow = 0.0                 # largest transient chunk in flight
    flow_rows: dict[int, float] = {}
    for n in order:
        st = stats[n.id]
        if n.id in boundary:
            state += st.total_bytes
            flow_rows[n.id] = min(float(chunk_rows), st.rows)
            max_flow = max(max_flow, flow_rows[n.id] * st.row_bytes)
            continue
        if isinstance(n, G.Scan):
            fr = 0.0
            for pi in range(n.source.n_partitions):
                if pi in n.skip_partitions:
                    continue
                fr = max(fr, float(n.source.partition_meta(pi).get(
                    "rows", chunk_rows)))
            fr = fr or min(float(chunk_rows), st.rows)
        elif n.op in _ROWWISE and n.inputs:
            in_st = stats[n.inputs[0].id]
            ratio = st.rows / in_st.rows if in_st.rows else 1.0
            fr = flow_rows[n.inputs[0].id] * min(1.0, ratio)
        else:
            fr = min(float(chunk_rows), st.rows)
        flow_rows[n.id] = fr
        max_flow = max(max_flow, fr * st.row_bytes)
        if parents.get(n.id, 0) > 1:
            state += st.total_bytes      # shared nodes are memoized in full
            continue
        if isinstance(n, G.Join):
            state += stats[n.inputs[1].id].total_bytes   # build side held
        elif isinstance(n, G.SortValues):
            state += stats[n.inputs[0].id].total_bytes   # materializes input
        elif isinstance(n, (G.GroupByAgg, G.DropDuplicates)):
            state += st.total_bytes                      # partials ≈ output
        elif isinstance(n, G.TopK):
            state += st.total_bytes                      # best-k accumulator
        elif n.id in root_ids and st.rows:
            state += st.total_bytes                      # root materialized
    return state + max_flow


def plan_cost(roots: list[G.Node], stats: dict[int, TableStats],
              kind, chunk_rows: int = 1 << 16,
              n_shards: int | None = None,
              boundary: frozenset[int] = frozenset(),
              sharded_boundary: frozenset[int] = frozenset()) -> CostEstimate:
    """Price an optimized plan (or one planner segment) on one engine.

    ``kind`` is an engine name (registry key).  ``boundary`` marks
    cross-segment inputs: they are priced as already-materialized handoff
    leaves (no work; resident bytes).  ``sharded_boundary`` names the
    subset whose handoff payload arrives device-resident (same-engine
    producer → consumer for a ``keeps_device_payloads`` engine): those
    cost no re-shard and keep the segment's sharded peak."""
    cap = default_registry().capability_of(kind)
    order = bounded_walk(roots, boundary)
    # a sharded-model segment fed by *host* handoffs runs its ops on the
    # gathered host table (single-host fallback), not across shards;
    # device-resident (sharded) handoffs keep it sharded
    host_boundary = boundary - sharded_boundary
    unsharded = cap.peak_model == "sharded" and bool(host_boundary)
    per_node: dict[int, float] = {}
    total = cap.startup_cost
    for n in order:
        if n.id in boundary:
            w = 0.0
        else:
            w = node_work(n, stats, cap)
            if unsharded and n.op in cap.native_ops:
                w *= cap.parallelism
        per_node[n.id] = w
        total += w
    if cap.peak_model == "chunked":
        peak = _chunked_peak(order, roots, stats, chunk_rows, boundary)
    else:
        peak = _resident_peak(order, roots, stats)
        if cap.peak_model == "sharded":
            if n_shards is None:
                n_shards = cap.shard_count() if cap.shard_count else 1
            # host-handoff-fed segments start from a host-resident table
            # (the runtime hands the engine a plain dict, not shards), so
            # only segments whose inputs are scans or sharded handoffs and
            # whose ops are all native earn the sharded peak
            if not host_boundary and all(n.op in cap.native_ops
                                         for n in order):
                peak /= max(1, n_shards)
            # else: first fallback gathers on one host → full-peak estimate
    return CostEstimate(cap.name, total, peak, per_node)


def transfer_cost(bytes_: float, from_cap, to_cap) -> float:
    """Work charged for materializing a segment boundary: the producer
    gathers/host-normalizes its output and the consumer re-ingests it, plus
    the consumer's fixed startup (a new engine spins up per segment)."""
    per_byte = from_cap.transfer_cost_per_byte + to_cap.transfer_cost_per_byte
    return bytes_ * max(per_byte, 0.25) + to_cap.startup_cost
