"""The built-in rewrite rules.

Each rule documents *why* its rewrite is exact under this engine's
operator semantics — the conformance suite enforces it differentially
(rewrites on vs ``session(rewrites=False)``).
"""
from __future__ import annotations

import numpy as np

from .. import expr as E
from .. import graph as G
from .engine import consumed_ok


class SortHeadToTopK:
    """``sort_values(by).head(n)`` → ``TopK(by, n, mode="sort")``.

    Exact by construction: TopK's sort mode is *defined* as the first n
    rows of the stable sort (descending = reversed-stable, NaN travels
    with the sort), and ``apply_top_k`` reproduces that ordering while
    only materializing the k survivors."""

    name = "sort_head_to_top_k"
    summary = ("sort_values().head(n) runs as a top-k selection "
               "(no full sort)")

    def match(self, n: G.Node) -> bool:
        return isinstance(n, G.Head) and isinstance(n.inputs[0], G.SortValues)

    def guard(self, n: G.Node, parents) -> bool:
        u = n.inputs[0]
        return consumed_ok(u, parents) and isinstance(u.ascending, bool)

    def apply(self, n: G.Head) -> G.Node:
        u = n.inputs[0]
        return G.TopK(u.inputs[0], u.by, n.n, u.ascending, mode="sort")

    def describe(self, n, repl) -> str:
        u = n.inputs[0]
        return f"by={list(u.by)} n={n.n} ascending={u.ascending}"


class DedupBeforeSort:
    """``sort_values(by, ascending=True).drop_duplicates()`` →
    ``drop_duplicates().sort_values(by)`` — sort only the survivors.

    Exact only for whole-row dedup (``subset=None``) under an *ascending*
    stable sort: duplicates are fully identical rows, so the kept first
    occurrences are value-identical and their relative order (earliest
    input occurrence per class) is preserved by the stable sort on either
    side.  A descending sort breaks the commute — ``apply_sort`` reverses
    equal-key runs, so sort-first keeps the *latest* physical copy and
    shifts its tie position — and ``subset=...`` changes which row of a
    group survives, so both are guarded out."""

    name = "dedup_before_sort"
    summary = ("drop_duplicates() after an ascending sort runs before it "
               "(sort only the unique rows)")

    def match(self, n: G.Node) -> bool:
        return (isinstance(n, G.DropDuplicates)
                and isinstance(n.inputs[0], G.SortValues))

    def guard(self, n: G.DropDuplicates, parents) -> bool:
        u = n.inputs[0]
        return (n.subset is None and u.ascending is True
                and consumed_ok(u, parents))

    def apply(self, n: G.DropDuplicates) -> G.Node:
        u = n.inputs[0]
        dedup = G.DropDuplicates(u.inputs[0], None)
        return G.SortValues(dedup, u.by, u.ascending)

    def describe(self, n, repl) -> str:
        return f"by={list(n.inputs[0].by)}"


class FilterThroughConcat:
    """``Filter(Concat(xs))`` → ``Concat([Filter(x) for x in xs])``.

    Exact: ``apply_concat`` preserves per-input row order and filtering is
    row-local, so filtering each leg before concatenation yields the same
    rows in the same order.  Unblocks the §3.2 pushdown pass — the pushed
    copies keep descending toward each leg's scan (zone-map pruning,
    column selection), which ``push_filters`` alone never does because
    Concat is multi-input."""

    name = "filter_through_concat"
    summary = "filters push through concat into each input branch"

    def match(self, n: G.Node) -> bool:
        return isinstance(n, G.Filter) and isinstance(n.inputs[0], G.Concat)

    def guard(self, n: G.Filter, parents) -> bool:
        return consumed_ok(n.inputs[0], parents)

    def apply(self, n: G.Filter) -> G.Node:
        u = n.inputs[0]
        return G.Concat([G.Filter(c, n.predicate) for c in u.inputs])

    def describe(self, n, repl) -> str:
        return f"{len(n.inputs[0].inputs)} branches"


# ---------------------------------------------------------------------------
# MapRows vectorization: symbolic tracing of the whole-table UDF.


class _NotVectorizable(Exception):
    pass


class _SymCol:
    """Symbolic column: records the expression a UDF builds instead of
    computing it.  Any operation outside the native ``Expr`` algebra
    raises (attribute access, truthiness, unsupported operands), which
    aborts the trace — the UDF then simply stays a ``MapRows`` barrier."""

    __slots__ = ("expr",)

    def __init__(self, expr: E.Expr):
        self.expr = expr

    @staticmethod
    def _lift(other) -> E.Expr:
        if isinstance(other, _SymCol):
            return other.expr
        if isinstance(other, (bool, int, float)):
            return E.Lit(other)
        if isinstance(other, (np.bool_, np.integer, np.floating)):
            return E.Lit(other.item())
        raise _NotVectorizable(f"unsupported operand {type(other).__name__}")

    def __invert__(self):
        return _SymCol(E.Not(self.expr))

    def __neg__(self):
        return _SymCol(E.BinOp("sub", E.Lit(0), self.expr))

    def __bool__(self):
        raise _NotVectorizable("data-dependent control flow")

    def __iter__(self):
        raise _NotVectorizable("iteration over a column")

    __hash__ = object.__hash__

    def clip(self, lower=None, upper=None):
        return _SymCol(E.Clip(self.expr, lower, upper))

    def round(self, decimals=0):
        return _SymCol(E.Round(self.expr, int(decimals)))

    def astype(self, dtype):
        return _SymCol(E.Cast(self.expr, str(np.dtype(dtype))))


def _sym_binop(op: str, reflected: bool = False):
    def method(self, other):
        try:
            rhs = _SymCol._lift(other)
        except _NotVectorizable:
            return NotImplemented
        left, right = (rhs, self.expr) if reflected else (self.expr, rhs)
        return _SymCol(E.BinOp(op, left, right))
    return method


for _op, _magic in (("add", "add"), ("sub", "sub"), ("mul", "mul"),
                    ("truediv", "truediv"), ("floordiv", "floordiv"),
                    ("mod", "mod"), ("and", "and"), ("or", "or")):
    setattr(_SymCol, f"__{_magic}__", _sym_binop(_op))
    setattr(_SymCol, f"__r{_magic}__", _sym_binop(_op, reflected=True))
for _op, _magic in (("eq", "eq"), ("ne", "ne"), ("lt", "lt"), ("le", "le"),
                    ("gt", "gt"), ("ge", "ge")):
    setattr(_SymCol, f"__{_magic}__", _sym_binop(_op))


def _trace_udf(fn, cols: list[str]) -> dict[str, E.Expr] | None:
    """Run ``fn`` once on symbolic columns.  Returns ``{out_col: expr}``
    when every output is expressible in the native algebra, else None.
    Like any tracing JIT, a non-pure UDF observes the trace — acceptable
    because a UDF relying on side effects is not vectorizable anyway and
    almost always aborts the trace at its first non-algebraic operation."""
    sym = {c: _SymCol(E.Col(c)) for c in cols}
    try:
        out = fn(dict(sym))
    except Exception:  # noqa: BLE001 — any failure just declines the rewrite
        return None
    if not isinstance(out, dict) or not out:
        return None
    exprs: dict[str, E.Expr] = {}
    for k, v in out.items():
        if not isinstance(k, str):
            return None
        if isinstance(v, _SymCol):
            exprs[k] = v.expr
        elif isinstance(v, (bool, int, float)):
            exprs[k] = E.Lit(v)
        else:
            return None
    return exprs


class MapRowsVectorize:
    """Vectorizable ``MapRows`` UDFs lift into native ``Assign`` chains.

    The UDF is traced symbolically; when every output column is a native
    expression over the *input* columns, the barrier node becomes
    ``Assign*``/``Project``/``Rename`` — pushdown, column selection and
    zone maps all see through it.  Outputs land in fresh temp columns
    first (trace exprs only reference input columns, so no assign can
    clobber another's operand — e.g. a UDF swapping two columns), then a
    Project fixes the output set/order and a Rename restores the UDF's
    output names."""

    name = "map_rows_vectorize"
    summary = ("vectorizable row-UDFs lift into native column expressions "
               "(unblocks pushdown)")

    def match(self, n: G.Node) -> bool:
        return isinstance(n, G.MapRows)

    def guard(self, n: G.MapRows, parents) -> bool:
        return callable(n.fn)

    def apply(self, n: G.MapRows) -> G.Node | None:
        cols = _ordered_cols(n.inputs[0])
        if cols is None:
            return None
        exprs = _trace_udf(n.fn, cols)
        if exprs is None:
            return None
        node: G.Node = n.inputs[0]
        select: list[str] = []
        mapping: dict[str, str] = {}
        for i, (k, ex) in enumerate(exprs.items()):
            if isinstance(ex, E.Col) and ex.name == k:
                select.append(k)            # untouched passthrough column
                continue
            tmp = f"__vec_{i}_{k}"
            node = G.Assign(node, tmp, ex)
            select.append(tmp)
            mapping[tmp] = k
        node = G.Project(node, select)
        if mapping:
            node = G.Rename(node, mapping)
        return node

    def describe(self, n, repl) -> str:
        return f"udf={n.name!r}"


def _ordered_cols(node: G.Node) -> list[str] | None:
    """Statically-known output column order of a subgraph (None when a
    barrier below makes it unknowable)."""
    from ..lazyframe import _ordered_out
    memo: dict[int, list | None] = {}

    def rec(n: G.Node) -> list | None:
        if n.id not in memo:
            memo[n.id] = _ordered_out(n, [rec(i) for i in n.inputs])
        return memo[n.id]

    return rec(node)


DEFAULT_RULES = (SortHeadToTopK(), DedupBeforeSort(), MapRowsVectorize(),
                 FilterThroughConcat())
