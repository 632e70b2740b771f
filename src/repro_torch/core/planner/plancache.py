"""Plan cache: repeated plan *shapes* skip optimize/rewrite/segment-DP.

Serving workloads re-run the same program shape over fresh data (new day's
file, next request's in-memory frame).  Re-planning from scratch at every
force point re-pays JIT analysis amortization: CSE, pattern rewrites,
pushdown, the column/zone-map/dtype passes and — under AUTO — the segment
DP.  This module caches the *optimized* plan keyed by a structural
fingerprint and rebinds it to fresh sources on a hit.

Cache key = ``(plan_fingerprint, stats_epoch)``:

* ``plan_fingerprint`` — graph shape + op kinds/params + source
  schema/dtypes + engine environment (engine choice, allow-list, candidate
  set, placement strategy, chunk size, rewrites flag, memory budget).
  Source ``cache_token``s are deliberately **excluded** so the same program
  shape over new data still hits.  Built only from process-stable values —
  never ``id()`` or object ``repr`` — so fingerprints agree across
  processes.
* ``stats_epoch`` — a content digest of everything the cost planner would
  read for this plan from the session's ``StatsStore`` (bucketed
  calibration scales + observed per-node cardinalities).  New feedback
  changes the epoch, so a stale placement is re-planned instead of reused;
  identical stats views (e.g. two fresh sessions) share entries.

Plans containing opaque or side-effecting nodes (``MapRows``, UDF
expressions, ``SinkPrint``, ``Materialized``, ``Handoff``) are
**uncacheable**: their semantics or payloads are not captured by a
structural fingerprint.  They take the normal cold path and are counted
under ``plan_cache.uncacheable``.

Rebinding rules (``CachedPlan.bind``): the cached template is cloned with
fresh node ids; each template scan is pointed at the new plan's source.
When the new source's ``cache_token`` differs from the one the template
was optimized against, *data-derived* plan state is dropped — zone-map
``skip_partitions`` reset and optimizer dtype-narrowing overrides replaced
by the new scan's own — because those were proven against the old data.
Schema-derived state (column pruning) is kept; the fingerprint already
guarantees equal schemas.
"""
from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

from .. import expr as E
from .. import graph as G


class Uncacheable(Exception):
    """Raised while fingerprinting a plan that must not be cached."""


# -- structural fingerprint --------------------------------------------------

def _expr_fp(e) -> tuple:
    """Expr fingerprint = its structural key, after proving no UDF hides
    anywhere in the tree (``UDF.key()`` leaks ``id(fn)`` — neither stable
    nor a faithful identity for closures)."""
    _check_no_udf(e)
    return e.key()


def _check_no_udf(e) -> None:
    if isinstance(e, E.UDF):
        raise Uncacheable("udf expression")
    import dataclasses as _dc
    if _dc.is_dataclass(e):
        for f in _dc.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                _check_no_udf(v)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, E.Expr):
                        _check_no_udf(item)


def _schema_fp(source) -> tuple:
    return tuple((c.name, str(c.np_dtype), c.is_dict, c.is_datetime)
                 for c in source.schema.columns)


def _scan_fp(n: G.Scan) -> tuple:
    # NO cache_token here — that is the whole point of the cache: the same
    # shape over new data (new token) must still hit.  Source *identity*
    # beyond shape is covered by the source class + schema here and by the
    # bind-time token comparison (which drops data-derived state on
    # mismatch); pushed-down predicates are part of the shape.
    pd_fp = (tuple(_expr_fp(c) for c in n.pushdown.conjuncts)
             if n.pushdown is not None else None)
    return ("scan", type(n.source).__name__, n.columns,
            tuple(sorted(n.dtype_overrides.items())),
            tuple(sorted(n.skip_partitions)), pd_fp, _schema_fp(n.source))


_NODE_FP = {
    "scan": _scan_fp,
    "project": lambda n: ("project", n.columns),
    "filter": lambda n: ("filter", _expr_fp(n.predicate)),
    "assign": lambda n: ("assign", n.name, _expr_fp(n.expr)),
    "rename": lambda n: ("rename", tuple(sorted(n.mapping.items()))),
    "astype": lambda n: ("astype", tuple(sorted(n.dtypes.items()))),
    "fillna": lambda n: ("fillna", repr(n.value), n.columns),
    "sort_values": lambda n: ("sort", n.by, repr(n.ascending)),
    "drop_duplicates": lambda n: ("dropdup", n.subset),
    "head": lambda n: ("head", n.n),
    "top_k": lambda n: ("topk", n.by, n.n, repr(n.ascending), n.mode),
    "groupby_agg": lambda n: ("gb", n.keys, tuple(sorted(n.aggs.items()))),
    "join": lambda n: ("join", n.on, n.how, tuple(n.suffixes)),
    "concat": lambda n: ("concat", len(n.inputs)),
    "reduce": lambda n: ("reduce", n.column, n.fn),
    "length": lambda n: ("length",),
    "fused_rowwise": lambda n: (
        ("fused",) + tuple(_NODE_FP[m.op](m) for m in n.ops)),
    # map_rows / sink_print / materialized / handoff deliberately absent:
    # opaque code, side effects, or embedded payloads → uncacheable.
}


def _env_fp(ctx) -> tuple:
    """Planning environment: everything besides the graph that steers
    optimize() / plan_placement() output."""
    from ..engines import AUTO
    engine = str(ctx.backend)
    allow = (tuple(sorted(ctx.engine_allowlist))
             if ctx.engine_allowlist else None)
    if engine == AUTO:
        from .select import candidate_engines
        cands = tuple(candidate_engines(ctx))
    else:
        cands = (engine,)
    opts = ctx.backend_options
    return ("env", engine, allow, cands,
            str(opts.get("placement", "operator")),
            int(opts.get("chunk_rows", 1 << 16)),
            bool(opts.get("rewrites", True)),
            bool(opts.get("fusion", True)),
            bool(opts.get("pushdown", True)),
            bool(opts.get("zonemap", True)),
            str(opts.get("kernel_impl", "auto")),
            ctx.memory_budget)


def plan_fingerprint(roots: list[G.Node], ctx, walk=None) -> str:
    """Process-stable structural fingerprint of a plan + its planning
    environment.  Raises :class:`Uncacheable` for plans that must not be
    cached."""
    nodes = walk if walk is not None else G.walk(roots)
    idx = {n.id: i for i, n in enumerate(nodes)}
    parts = []
    for n in nodes:
        fp = _NODE_FP.get(n.op)
        if fp is None:
            raise Uncacheable(f"op {n.op!r}")
        parts.append(fp(n) + (tuple(idx[i.id] for i in n.inputs),))
    root_idx = tuple(idx[r.id] for r in roots)
    blob = repr((tuple(parts), root_idx, _env_fp(ctx))).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


# -- stats epoch -------------------------------------------------------------

def _bucket_scale(scale: float) -> int:
    """Half-octave bucket: small calibration jitter keeps the epoch stable,
    a real shift (≥ ~1.4×) re-plans."""
    return round(math.log2(scale) * 2)


def _bucket_rows(rows: float) -> float:
    return float(f"{rows:.2g}") if rows > 0 else 0.0


def stats_epoch(roots: list[G.Node], ctx, walk=None) -> str:
    """Digest of the planner-visible ``StatsStore`` state *for this plan*:
    bucketed runtime/peak calibration scales plus the observed cardinality
    (bucketed rows) of every plan node the store knows.  This is the
    "stats epoch" component of the cache key — when feedback that could
    change placement arrives, the epoch moves and the shape re-plans."""
    store = getattr(ctx, "stats_store", None)
    if store is None:
        return "nostats"
    nodes = walk if walk is not None else G.walk(roots)
    cal = tuple(sorted((b, _bucket_scale(s))
                       for b, s in store.calibration().items()))
    pcal = tuple(sorted((b, _bucket_scale(s))
                        for b, s in store.peak_calibration().items()))
    obs = []
    for i, n in enumerate(nodes):
        try:
            o = store.lookup(n.key())
        except Exception:  # noqa: BLE001 — side-effect nodes key on id
            o = None
        if o:
            obs.append((i, _bucket_rows(o.get("rows", 0.0))))
    blob = repr((cal, pcal, tuple(obs))).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


def cache_key(roots: list[G.Node], ctx, walk=None):
    """``(fingerprint, epoch)`` for a cacheable plan, else ``None``."""
    nodes = walk if walk is not None else G.walk(roots)
    try:
        fp = plan_fingerprint(roots, ctx, walk=nodes)
    except Uncacheable:
        return None
    return fp, stats_epoch(roots, ctx, walk=nodes)


# -- cached plans ------------------------------------------------------------

def _token(source):
    tok = getattr(source, "cache_token", None)
    return tok() if callable(tok) else ("mem", id(source))


@dataclass
class CachedPlan:
    """One cached optimized plan: the post-optimize template, the original→
    optimized image list (re-creating ``optimize``'s idmap on bind), scan
    rebinding slots, and — under AUTO — the segment decisions."""
    key: tuple
    template_roots: list = field(default_factory=list)
    images: list = field(default_factory=list)       # orig walk idx → template node
    scan_bindings: dict = field(default_factory=dict)  # template scan id → orig walk idx
    source_tokens: dict = field(default_factory=dict)  # orig walk idx → cache_token
    decisions: Any = None                            # list[Decision] | None
    plan_seconds: float = 0.0                        # cold planning cost it saves

    @classmethod
    def build(cls, key, orig_walk, opt_roots, idmap, decisions,
              plan_seconds) -> "CachedPlan | None":
        images = [idmap.get(n.id, n) for n in orig_walk]
        src_slots = {id(n.source): i for i, n in enumerate(orig_walk)
                     if isinstance(n, G.Scan)}
        scan_bindings: dict[int, int] = {}
        source_tokens: dict[int, Any] = {}
        for t in G.walk(opt_roots):
            if isinstance(t, G.Scan):
                oi = src_slots.get(id(t.source))
                if oi is None:      # optimizer invented a source? don't cache
                    return None
                scan_bindings[t.id] = oi
                source_tokens[oi] = _token(t.source)
        return cls(key=key, template_roots=list(opt_roots), images=images,
                   scan_bindings=scan_bindings, source_tokens=source_tokens,
                   decisions=decisions, plan_seconds=plan_seconds)

    def bind(self, new_walk: list[G.Node]):
        """Clone the template against the new plan's sources.  Returns
        ``(opt_roots, idmap, decisions|None)`` or ``None`` when the plan
        cannot be bound (caller falls back to cold planning)."""
        if len(new_walk) != len(self.images):
            return None
        memo: dict[int, G.Node] = {}

        def clone(t: G.Node) -> G.Node:
            out = memo.get(t.id)
            if out is not None:
                return out
            if isinstance(t, G.Scan):
                oi = self.scan_bindings[t.id]
                new_scan = new_walk[oi]
                src = new_scan.source
                out = None
                if _token(src) == self.source_tokens[oi]:
                    # same data: data-derived plan state (zone-map skips,
                    # dtype narrowing) is still proven — keep it
                    out = G.Scan(src, t.columns, t.dtype_overrides,
                                 pushdown=t.pushdown)
                    out.skip_partitions = t.skip_partitions
                else:
                    # fresh data: keep schema-derived pruning (columns,
                    # pushed-down predicate — its semantics don't depend on
                    # data), drop data-derived state.  The template's
                    # skip_partitions were proven against the *old*
                    # source's zone maps; carrying them over would
                    # silently drop live partitions of the new data, so
                    # re-derive the prune set from the pushed-down
                    # conjuncts against the new source's partition metas.
                    out = G.Scan(src, t.columns,
                                 dict(new_scan.dtype_overrides),
                                 pushdown=t.pushdown)
                    skips = set(new_scan.skip_partitions)
                    if t.pushdown is not None:
                        usable = [c for c in t.pushdown.conjuncts
                                  if isinstance(c, E.BinOp)]
                        if usable:
                            for pi in range(src.n_partitions):
                                zm = src.partition_meta(pi).get(
                                    "zonemap", {})
                                if zm and any(c.prune_partition(zm)
                                              for c in usable):
                                    skips.add(pi)
                    out.skip_partitions = frozenset(skips)
            else:
                out = t.with_inputs([clone(i) for i in t.inputs])
            memo[t.id] = out
            return out

        try:
            opt_roots = [clone(r) for r in self.template_roots]
            idmap = {n.id: clone(img)
                     for n, img in zip(new_walk, self.images)}
            decisions = None
            if self.decisions is not None:
                import dataclasses as _dc
                decisions = [
                    _dc.replace(d,
                                roots=[clone(r) for r in d.roots],
                                nodes=[clone(n) for n in d.nodes],
                                boundary=[clone(b) for b in d.boundary])
                    for d in self.decisions]
        except (KeyError, IndexError, AttributeError, AssertionError):
            return None
        return opt_roots, idmap, decisions


class PlanCache:
    """Process-global, thread-safe LRU of :class:`CachedPlan`.

    Thread-safety invariant: all map access happens under ``_lock``;
    entries are immutable after ``store`` and ``bind`` clones fresh nodes
    per call, so concurrent sessions never share mutable plan state."""

    def __init__(self, max_entries: int = 128):
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, CachedPlan] = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.uncacheable = 0
        self.hit_plan_seconds = 0.0     # total wall spent binding on hits
        self.miss_plan_seconds = 0.0    # total wall spent planning on misses

    def lookup(self, key) -> CachedPlan | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            return entry

    def store(self, entry: CachedPlan | None) -> None:
        if entry is None:
            return
        with self._lock:
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def record_hit(self, seconds: float) -> None:
        with self._lock:
            self.hits += 1
            self.hit_plan_seconds += seconds

    def record_miss(self, seconds: float) -> None:
        with self._lock:
            self.misses += 1
            self.miss_plan_seconds += seconds

    def record_uncacheable(self) -> None:
        with self._lock:
            self.uncacheable += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.uncacheable = 0
            self.hit_plan_seconds = self.miss_plan_seconds = 0.0

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "uncacheable": self.uncacheable,
                "hit_rate": (self.hits / total) if total else 0.0,
                "mean_hit_plan_seconds": (
                    self.hit_plan_seconds / self.hits if self.hits else 0.0),
                "mean_miss_plan_seconds": (
                    self.miss_plan_seconds / self.misses
                    if self.misses else 0.0),
            }


_DEFAULT_CACHE = PlanCache()


def default_plan_cache() -> PlanCache:
    """The process-global plan cache shared by every session (sessions hit
    each other's entries by design — the key carries the full planning
    environment and stats epoch, so sharing is sound)."""
    return _DEFAULT_CACHE
