"""Operator DAG ("task graph", paper §2.5).

Nodes are immutable logical operators; edges point child → parent implicitly
via each node's ``inputs`` tuple (data flows inputs → node; the paper draws
dependency edges the other way, same information).  Structural keys enable
CSE; ``mod_attrs`` / ``used_attrs`` per node drive pushdown safety (§3.2);
``out_cols`` propagation drives projection pushdown / column selection
(§3.1).
"""
from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping, Sequence

from .expr import Expr, conjoin

_ids = itertools.count()

ALL = "<ALL>"  # sentinel: all columns of a frame


class Node:
    """Base logical operator."""
    op: str = "?"

    def __init__(self, inputs: Sequence["Node"]):
        self.id = next(_ids)
        self.inputs: tuple[Node, ...] = tuple(inputs)
        # runtime fields (paper §2.6 executor):
        self.result: Any = None          # materialized value, cleared by refcount
        self.persist: bool = False       # §3.5 common-computation-reuse mark

    # -- attributes for optimizer ------------------------------------------
    def used_attrs(self) -> frozenset[str]:
        """Input columns this operator reads (beyond pass-through)."""
        return frozenset()

    def mod_attrs(self) -> frozenset[str]:
        """Columns this operator modifies or computes."""
        return frozenset()

    def preserves_rows(self) -> bool:
        """True if output rows are exactly input rows (1:1, same order) —
        precondition (2) of paper §3.2 for swapping with a filter."""
        return False

    def has_side_effects(self) -> bool:
        return False

    def out_cols(self, in_cols: Sequence[frozenset[str] | None]) -> frozenset[str] | None:
        """Output column set given input column sets (None = unknown)."""
        return in_cols[0] if in_cols else None

    def required_cols(self, live: frozenset[str] | None) -> list[frozenset[str] | None]:
        """Columns needed from each input so that `live` output columns can
        be produced. None = all columns."""
        return [None for _ in self.inputs]

    # -- identity -----------------------------------------------------------
    def key(self) -> tuple:
        """Structural key for CSE. Nodes with side effects key on id."""
        raise NotImplementedError

    def with_inputs(self, inputs: Sequence["Node"]) -> "Node":
        """Clone with new inputs (rewrites preserve node params)."""
        raise NotImplementedError

    def __repr__(self):
        return f"{self.op}#{self.id}({', '.join(str(i.id) for i in self.inputs)})"


# ---------------------------------------------------------------------------
# Sources


class ScanPushdown:
    """Filter conjuncts sunk into a :class:`Scan` (scan-level predicate
    pushdown, ``repro_torch.io``).  The scan's loader evaluates the ANDed
    conjuncts on each decoded partition and keeps only passing rows, so
    filtered rows never reach the engine — and partitions the conjuncts
    prove all-False are never read at all (``skip_partitions``).

    Immutable; part of the scan's structural identity (``Scan.key`` and the
    plan-cache fingerprint both cover the conjunct keys)."""

    __slots__ = ("conjuncts",)

    def __init__(self, conjuncts: Sequence[Expr]):
        self.conjuncts: tuple[Expr, ...] = tuple(conjuncts)

    @property
    def predicate(self) -> Expr:
        return conjoin(list(self.conjuncts))

    def used_cols(self) -> frozenset[str]:
        out: frozenset[str] = frozenset()
        for c in self.conjuncts:
            out |= c.used_cols()
        return out

    def key(self) -> tuple:
        return ("pushdown",) + tuple(c.key() for c in self.conjuncts)

    def __repr__(self):
        return f"ScanPushdown({len(self.conjuncts)} conjuncts)"


class Scan(Node):
    """Read a partitioned columnar source. ``columns=None`` → all columns.

    Column selection (§3.1) rewrites ``columns``; zone-map pruning (beyond
    paper) fills ``skip_partitions`` at plan time; the scan-pushdown pass
    (``repro_torch.io``) sinks filter conjuncts into ``pushdown`` so rows are
    dropped at decode time and proven-empty partitions are never read."""
    op = "scan"

    def __init__(self, source, columns: tuple[str, ...] | None = None,
                 dtype_overrides: Mapping[str, str] | None = None,
                 pushdown: ScanPushdown | None = None):
        super().__init__([])
        self.source = source
        self.columns = tuple(columns) if columns is not None else None
        self.dtype_overrides = dict(dtype_overrides or {})
        self.skip_partitions: frozenset[int] = frozenset()
        self.pushdown = pushdown

    def used_attrs(self):
        return self.pushdown.used_cols() if self.pushdown is not None \
            else frozenset()

    def out_cols(self, in_cols):
        if self.columns is not None:
            return frozenset(self.columns)
        return frozenset(self.source.schema.names)

    def key(self):
        token = getattr(self.source, "cache_token", None)
        token = token() if callable(token) else id(self.source)
        return ("scan", token, self.columns,
                tuple(sorted(self.dtype_overrides.items())),
                self.skip_partitions,
                self.pushdown.key() if self.pushdown is not None else None)

    def with_inputs(self, inputs):
        assert not inputs
        n = Scan(self.source, self.columns, self.dtype_overrides,
                 pushdown=self.pushdown)
        n.skip_partitions = self.skip_partitions
        return n


# ---------------------------------------------------------------------------
# Row-preserving unary ops


class Project(Node):
    op = "project"

    def __init__(self, child: Node, columns: Sequence[str]):
        super().__init__([child])
        self.columns = tuple(columns)

    def used_attrs(self):
        return frozenset(self.columns)

    def preserves_rows(self):
        return True

    def out_cols(self, in_cols):
        return frozenset(self.columns)

    def required_cols(self, live):
        return [frozenset(self.columns)]

    def key(self):
        return ("project", self.columns, self.inputs[0].key())

    def with_inputs(self, inputs):
        return Project(inputs[0], self.columns)


class Filter(Node):
    op = "filter"

    def __init__(self, child: Node, predicate: Expr):
        super().__init__([child])
        self.predicate = predicate

    def used_attrs(self):
        return self.predicate.used_cols()

    def preserves_rows(self):
        return False  # drops rows (but keeps columns)

    def out_cols(self, in_cols):
        return in_cols[0]

    def required_cols(self, live):
        if live is None:
            return [None]
        return [live | self.predicate.used_cols()]

    def key(self):
        return ("filter", self.predicate.key(), self.inputs[0].key())

    def with_inputs(self, inputs):
        return Filter(inputs[0], self.predicate)


class Assign(Node):
    """df[name] = expr  (adds or replaces a column)."""
    op = "assign"

    def __init__(self, child: Node, name: str, expr: Expr):
        super().__init__([child])
        self.name = name
        self.expr = expr

    def used_attrs(self):
        return self.expr.used_cols()

    def mod_attrs(self):
        return frozenset([self.name])

    def preserves_rows(self):
        return True

    def out_cols(self, in_cols):
        c = in_cols[0]
        return None if c is None else c | {self.name}

    def required_cols(self, live):
        if live is None:
            return [None]
        need = (live - {self.name}) | (self.expr.used_cols() if self.name in live else frozenset())
        return [need]

    def key(self):
        return ("assign", self.name, self.expr.key(), self.inputs[0].key())

    def with_inputs(self, inputs):
        return Assign(inputs[0], self.name, self.expr)


class Rename(Node):
    op = "rename"

    def __init__(self, child: Node, mapping: Mapping[str, str]):
        super().__init__([child])
        self.mapping = dict(mapping)

    def used_attrs(self):
        return frozenset(self.mapping.keys())

    def mod_attrs(self):
        return frozenset(self.mapping.values())

    def preserves_rows(self):
        return True

    def out_cols(self, in_cols):
        c = in_cols[0]
        if c is None:
            return None
        return frozenset(self.mapping.get(n, n) for n in c)

    def required_cols(self, live):
        if live is None:
            return [None]
        inv = {v: k for k, v in self.mapping.items()}
        return [frozenset(inv.get(n, n) for n in live)]

    def key(self):
        return ("rename", tuple(sorted(self.mapping.items())), self.inputs[0].key())

    def with_inputs(self, inputs):
        return Rename(inputs[0], self.mapping)


class AsType(Node):
    op = "astype"

    def __init__(self, child: Node, dtypes: Mapping[str, str]):
        super().__init__([child])
        self.dtypes = dict(dtypes)

    def used_attrs(self):
        return frozenset(self.dtypes.keys())

    def mod_attrs(self):
        return frozenset(self.dtypes.keys())

    def preserves_rows(self):
        return True

    def required_cols(self, live):
        if live is None:
            return [None]
        return [live]

    def key(self):
        return ("astype", tuple(sorted(self.dtypes.items())), self.inputs[0].key())

    def with_inputs(self, inputs):
        return AsType(inputs[0], self.dtypes)


class FillNa(Node):
    op = "fillna"

    def __init__(self, child: Node, value, columns: tuple[str, ...] | None = None):
        super().__init__([child])
        self.value = value
        self.columns = columns

    def used_attrs(self):
        return frozenset(self.columns or ())

    def mod_attrs(self):
        # unknown columns when columns=None → report nothing modified is
        # unsafe; report ALL via used/mod at optimizer level (handled there).
        return frozenset(self.columns) if self.columns else frozenset([ALL])

    def preserves_rows(self):
        return True

    def key(self):
        return ("fillna", repr(self.value), self.columns, self.inputs[0].key())

    def with_inputs(self, inputs):
        return FillNa(inputs[0], self.value, self.columns)


class SortValues(Node):
    """Row-permuting but set-preserving: filters commute with stable sort."""
    op = "sort_values"

    def __init__(self, child: Node, by: Sequence[str], ascending: bool = True):
        super().__init__([child])
        self.by = tuple(by)
        self.ascending = ascending

    def used_attrs(self):
        return frozenset(self.by)

    def preserves_rows(self):
        return True  # for filter-swap purposes: 1:1 rows, values unchanged

    def required_cols(self, live):
        if live is None:
            return [None]
        return [live | frozenset(self.by)]

    def key(self):
        return ("sort", self.by, self.ascending, self.inputs[0].key())

    def with_inputs(self, inputs):
        return SortValues(inputs[0], self.by, self.ascending)


class DropDuplicates(Node):
    op = "drop_duplicates"

    def __init__(self, child: Node, subset: tuple[str, ...] | None = None):
        super().__init__([child])
        self.subset = subset

    def used_attrs(self):
        return frozenset(self.subset or ())

    def preserves_rows(self):
        return False

    def required_cols(self, live):
        if live is None or self.subset is None:
            return [None]
        return [live | frozenset(self.subset)]

    def key(self):
        return ("dropdup", self.subset, self.inputs[0].key())

    def with_inputs(self, inputs):
        return DropDuplicates(inputs[0], self.subset)


class Head(Node):
    op = "head"

    def __init__(self, child: Node, n: int):
        super().__init__([child])
        self.n = n

    def preserves_rows(self):
        return False

    def key(self):
        return ("head", self.n, self.inputs[0].key())

    def with_inputs(self, inputs):
        return Head(inputs[0], self.n)


class TopK(Node):
    """First ``n`` rows of the stable sort by ``by`` — a partial sort that
    never materializes the full permutation.  Produced by the rewrite pass
    (``sort_values(by).head(n)``) and by native ``nlargest``/``nsmallest``
    lowering; the planner prices it ≪ a full sort.

    ``mode`` pins the tie/NaN semantics: ``"sort"`` is exactly
    ``SortValues(by, ascending) → Head(n)`` (NaN keys travel with the sort,
    descending reverses tie order); ``"select"`` is pandas
    ``nlargest``/``nsmallest`` (NaN keys dropped, ties keep first
    occurrence)."""
    op = "top_k"

    def __init__(self, child: Node, by: Sequence[str], n: int,
                 ascending: bool = True, mode: str = "sort"):
        super().__init__([child])
        self.by = tuple(by)
        self.n = int(n)
        self.ascending = ascending
        self.mode = mode

    def used_attrs(self):
        return frozenset(self.by)

    def preserves_rows(self):
        return False

    def required_cols(self, live):
        if live is None:
            return [None]
        return [live | frozenset(self.by)]

    def key(self):
        return ("topk", self.by, self.n, self.ascending, self.mode,
                self.inputs[0].key())

    def with_inputs(self, inputs):
        return TopK(inputs[0], self.by, self.n, self.ascending, self.mode)


class MapRows(Node):
    """Opaque row-wise UDF over the whole frame (pushdown barrier: unknown
    mod/used attrs, paper §3.2 'operators whose semantics are not known')."""
    op = "map_rows"

    def __init__(self, child: Node, fn, name="udf"):
        super().__init__([child])
        self.fn = fn
        self.name = name

    def mod_attrs(self):
        return frozenset([ALL])

    def used_attrs(self):
        return frozenset([ALL])

    def preserves_rows(self):
        return True

    def out_cols(self, in_cols):
        return None

    def key(self):
        return ("maprows", id(self.fn), self.inputs[0].key())

    def with_inputs(self, inputs):
        return MapRows(inputs[0], self.fn, self.name)


class FusedRowwise(Node):
    """Maximal single-consumer chain of rowwise ops collapsed into one
    physical pass (``core.fuse``; Dask's low-level ``fuse`` analogue).

    ``ops`` holds the member nodes innermost-first.  Each member is kept as
    a parameter template: execution rebinds it to the running table, so its
    own ``inputs`` edge is never followed.  The chain is one composed pass
    over the table — no intermediate tables between members."""
    op = "fused_rowwise"

    def __init__(self, child: Node, ops: Sequence[Node]):
        super().__init__([child])
        self.ops = tuple(ops)

    def used_attrs(self):
        used: set[str] = set()
        produced: set[str] = set()
        for m in self.ops:
            used |= set(m.used_attrs()) - produced
            produced |= set(m.mod_attrs())
        return frozenset(used)

    def mod_attrs(self):
        out: set[str] = set()
        for m in self.ops:
            out |= set(m.mod_attrs())
        return frozenset(out)

    def preserves_rows(self):
        return all(m.preserves_rows() for m in self.ops)

    def out_cols(self, in_cols):
        c = in_cols[0] if in_cols else None
        for m in self.ops:
            c = m.out_cols([c])
        return c

    def required_cols(self, live):
        for m in reversed(self.ops):
            live = m.required_cols(live)[0]
        return [live]

    def key(self):
        # member keys minus their child component (every rowwise key ends
        # with the child key), then the real child key once
        return (("fused",) + tuple(m.key()[:-1] for m in self.ops)
                + (self.inputs[0].key(),))

    def with_inputs(self, inputs):
        return FusedRowwise(inputs[0], self.ops)


# ---------------------------------------------------------------------------
# Row-count-changing / multi-input ops


class GroupByAgg(Node):
    """groupby(keys).agg({out_name: (col, fn)}) — fn ∈ sum|mean|count|min|max.

    Aggregates kill all columns except keys and agg outputs (paper §3.1)."""
    op = "groupby_agg"

    def __init__(self, child: Node, keys: Sequence[str],
                 aggs: Mapping[str, tuple[str, str]]):
        super().__init__([child])
        self.keys = tuple(keys)
        self.aggs = dict(aggs)

    def used_attrs(self):
        used = set(self.keys)
        for (col, _fn) in self.aggs.values():
            if col is not None:
                used.add(col)
        return frozenset(used)

    def mod_attrs(self):
        return frozenset(self.aggs.keys())

    def out_cols(self, in_cols):
        return frozenset(self.keys) | frozenset(self.aggs.keys())

    def required_cols(self, live):
        return [self.used_attrs()]

    def key(self):
        return ("gb", self.keys, tuple(sorted(self.aggs.items())), self.inputs[0].key())

    def with_inputs(self, inputs):
        return GroupByAgg(inputs[0], self.keys, self.aggs)


class Join(Node):
    op = "join"

    def __init__(self, left: Node, right: Node, on: Sequence[str],
                 how: str = "inner", suffixes=("_x", "_y")):
        super().__init__([left, right])
        self.on = tuple(on)
        self.how = how
        self.suffixes = suffixes

    def used_attrs(self):
        return frozenset(self.on)

    def out_cols(self, in_cols):
        l, r = in_cols
        if l is None or r is None:
            return None
        out = set(self.on)
        overlap = (l & r) - set(self.on)
        for n in l - set(self.on):
            out.add(n + self.suffixes[0] if n in overlap else n)
        for n in r - set(self.on):
            out.add(n + self.suffixes[1] if n in overlap else n)
        return frozenset(out)

    def required_cols(self, live):
        if live is None:
            return [None, None]
        # strip suffixes conservatively
        base = set(self.on)
        for n in live:
            for s in self.suffixes:
                if n.endswith(s):
                    base.add(n[: -len(s)])
            base.add(n)
        return [frozenset(base), frozenset(base)]

    def key(self):
        return ("join", self.on, self.how, self.suffixes,
                self.inputs[0].key(), self.inputs[1].key())

    def with_inputs(self, inputs):
        return Join(inputs[0], inputs[1], self.on, self.how, self.suffixes)


class Concat(Node):
    op = "concat"

    def __init__(self, children: Sequence[Node]):
        super().__init__(children)

    def out_cols(self, in_cols):
        out = None
        for c in in_cols:
            if c is None:
                return None
            out = c if out is None else (out & c)
        return out

    def required_cols(self, live):
        return [live for _ in self.inputs]

    def key(self):
        return ("concat",) + tuple(i.key() for i in self.inputs)

    def with_inputs(self, inputs):
        return Concat(inputs)


# ---------------------------------------------------------------------------
# Reductions → scalars


class Reduce(Node):
    """Column reduction to a scalar:
    mean/sum/min/max/count/nunique/median."""
    op = "reduce"

    def __init__(self, child: Node, column: str | None, fn: str):
        super().__init__([child])
        self.column = column
        self.fn = fn

    def used_attrs(self):
        return frozenset([self.column]) if self.column else frozenset()

    def out_cols(self, in_cols):
        return frozenset()

    def required_cols(self, live):
        return [frozenset([self.column]) if self.column else frozenset()]

    def key(self):
        return ("reduce", self.column, self.fn, self.inputs[0].key())

    def with_inputs(self, inputs):
        return Reduce(inputs[0], self.column, self.fn)


class Length(Node):
    """Lazy len(df) (paper §3.3: lazyfatpandas.func.len)."""
    op = "length"

    def __init__(self, child: Node):
        super().__init__([child])

    def out_cols(self, in_cols):
        return frozenset()

    def required_cols(self, live):
        return [frozenset()]  # any single column suffices; backend handles

    def key(self):
        return ("length", self.inputs[0].key())

    def with_inputs(self, inputs):
        return Length(inputs[0])


# ---------------------------------------------------------------------------
# Sinks (lazy print, §3.3)


class SinkPrint(Node):
    """Lazy print. ``parts`` is a list of str | Node; an extra ordering input
    edge to the previous sink keeps output order (paper Fig. 9)."""
    op = "sink_print"

    def __init__(self, parts: Sequence[Any], data_inputs: Sequence[Node],
                 prev_sink: "SinkPrint | None"):
        inputs = list(data_inputs) + ([prev_sink] if prev_sink is not None else [])
        super().__init__(inputs)
        self.parts = list(parts)
        self.n_data = len(data_inputs)

    def has_side_effects(self):
        return True

    def key(self):
        return ("sink_print", self.id)  # side effects: never CSE'd

    def with_inputs(self, inputs):
        data = inputs[: self.n_data]
        prev = inputs[self.n_data] if len(inputs) > self.n_data else None
        n = SinkPrint(self.parts, data, prev)
        return n


class Materialized(Node):
    """A cached (persisted) result substituted into the graph before
    optimization (§3.5 reuse).  Keys on the *logical* key of the node it
    replaces, so CSE and pushdown treat it as that subexpression."""
    op = "materialized"

    def __init__(self, table, logical_key: tuple):
        super().__init__([])
        self.table = table
        self._key = logical_key

    def out_cols(self, in_cols):
        return frozenset(self.table.keys())

    def key(self):
        return self._key

    def with_inputs(self, inputs):
        return self


class Handoff(Node):
    """Pipe breaker between planner segments (operator-granular hybrid
    placement).  The producing segment's engine has already materialized
    ``value`` — a host table (dict of numpy columns), a scalar, or, for
    distributed→distributed chains, a device-resident
    ``physical.ShardedTable`` that never round-trips through host memory —
    and the consuming segment's engine treats this node as a pre-computed
    leaf.  Keys on the logical key of the node it replaces so persist/CSE
    machinery sees the original subexpression."""
    op = "handoff"

    def __init__(self, value, logical_key: tuple, producer: str = "?"):
        super().__init__([])
        self.value = value
        self.producer = producer            # backend name that produced it
        self._key = logical_key

    def out_cols(self, in_cols):
        if isinstance(self.value, dict):
            return frozenset(self.value.keys())
        cols = getattr(self.value, "cols", None)   # ShardedTable payload
        if isinstance(cols, dict):
            return frozenset(cols.keys())
        return frozenset()

    def key(self):
        return self._key

    def with_inputs(self, inputs):
        return self


# ---------------------------------------------------------------------------
# Runtime-flag carrying (rewrites must not lose executor state)


def copy_runtime_flags(src: Node, dst: Node) -> Node:
    """Carry runtime fields (persist mark, cached result, cache key) from a
    node to its rewritten clone.  ``with_inputs`` clones get fresh defaults;
    every rewrite path must route through this so marks survive."""
    if dst is src:
        return dst
    dst.persist = src.persist
    dst.result = src.result
    if hasattr(src, "cache_key"):
        dst.cache_key = src.cache_key
    return dst


# ---------------------------------------------------------------------------
# Traversals


def walk(roots: Iterable[Node]) -> list[Node]:
    """Post-order (inputs before node), deduped."""
    seen: dict[int, Node] = {}
    order: list[Node] = []

    def rec(n: Node):
        if n.id in seen:
            return
        seen[n.id] = n
        for i in n.inputs:
            rec(i)
        order.append(n)

    for r in roots:
        rec(r)
    return order


def parents_map(roots: Iterable[Node]) -> dict[int, list[Node]]:
    out: dict[int, list[Node]] = {}
    for n in walk(roots):
        for i in n.inputs:
            out.setdefault(i.id, []).append(n)
        out.setdefault(n.id, out.get(n.id, []))
    return out
