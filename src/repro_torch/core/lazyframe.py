"""LazyFrame / LazyColumn / LazyScalar — the plain-Pandas-shaped lazy API
(paper §2.5).  Every call builds a task-graph node; nothing executes until a
force point (materialize / external call / flush)."""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import expr as E
from . import graph as G
from .context import get_context
from .physical.table import to_host_array
from .source import InMemorySource, Source


def _to_expr(v) -> E.Expr:
    if isinstance(v, LazyColumn):
        return v.expr
    if isinstance(v, E.Expr):
        return v
    return E.Lit(v)


class DtAccessor:
    def __init__(self, col: "LazyColumn"):
        self._col = col

    def __getattr__(self, field):
        if field.startswith("_"):
            raise AttributeError(field)
        if field in E._DT_FIELDS:
            return LazyColumn(self._col.frame, E.DtField(self._col.expr, field))
        # facade fallback protocol: unknown dt fields run through the
        # numpy-level kernel table as a wrapped UDF, recorded per session.
        from repro_torch.pandas.fallback import dt_fallback
        return dt_fallback(self._col, field)


class LazyColumn:
    """A column-valued expression over a frame (no new DAG node until used)."""

    def __init__(self, frame: "LazyFrame", expr_: E.Expr):
        self.frame = frame
        self.expr = expr_

    # arithmetic / comparison build Expr trees
    def _bin(self, op, other, reflect=False):
        l, r = self.expr, _to_expr(other)
        if reflect:
            l, r = r, l
        return LazyColumn(self.frame, E.BinOp(op, l, r))

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("truediv", o)
    def __rtruediv__(self, o): return self._bin("truediv", o, True)
    def __floordiv__(self, o): return self._bin("floordiv", o)
    def __mod__(self, o): return self._bin("mod", o)
    def __eq__(self, o): return self._bin("eq", o)      # type: ignore[override]
    def __ne__(self, o): return self._bin("ne", o)      # type: ignore[override]
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)
    def __invert__(self): return LazyColumn(self.frame, E.Not(self.expr))
    def __hash__(self):
        return id(self)

    def isin(self, values):
        return LazyColumn(self.frame, E.IsIn(self.expr, tuple(values)))

    def clip(self, lower=None, upper=None):
        if lower is None and upper is None:
            return LazyColumn(self.frame, self.expr)
        return LazyColumn(self.frame, E.Clip(self.expr, lower, upper))

    def round(self, decimals=0):
        return LazyColumn(self.frame, E.Round(self.expr, int(decimals)))

    def astype(self, dtype):
        return LazyColumn(self.frame, E.Cast(self.expr, str(np.dtype(dtype))))

    def apply(self, fn):
        return LazyColumn(self.frame, E.UDF(fn, (self.expr,)))

    def fillna(self, value):
        def _fill(a, v=value):
            if isinstance(a, torch.Tensor):
                if not a.dtype.is_floating_point:
                    return a
                return torch.where(torch.isnan(a),
                                   torch.tensor(v, dtype=a.dtype,
                                                device=a.device), a)
            if getattr(a, "dtype", None) is not None and a.dtype.kind == "f":
                return np.where(np.isnan(a), np.asarray(v, dtype=a.dtype), a)
            return a
        return LazyColumn(self.frame, E.UDF(_fill, (self.expr,), name="fillna",
                                            host=False))

    @property
    def dt(self):
        return DtAccessor(self)

    @property
    def str(self):
        return StrAccessor(self)

    def __getattr__(self, name):
        # Only reached when normal lookup fails: pandas Series methods the
        # lazy layer doesn't implement natively go through the fallback
        # kernel table (repro_torch.pandas) instead of raising AttributeError.
        if name.startswith("_") or name in ("frame", "expr"):
            raise AttributeError(name)
        from repro_torch.pandas.fallback import series_fallback
        return series_fallback(self, name)

    def to_numpy(self):
        return to_host_array(self.compute(force_reason="Series.to_numpy"))

    @property
    def values(self):
        return self.to_numpy()

    # reductions → LazyScalar
    def _reduce(self, fn):
        node = self.frame._node_for_expr_column(self.expr)
        name = node._col_name
        return LazyScalar(G.Reduce(node._inner, name, fn))

    def sum(self): return self._reduce("sum")
    def mean(self): return self._reduce("mean")
    def min(self): return self._reduce("min")
    def max(self): return self._reduce("max")
    def count(self): return self._reduce("count")
    def nunique(self): return self._reduce("nunique")
    def median(self): return self._reduce("median")

    def compute(self, live_df=None, force_reason="Series.compute"):
        node = self.frame._node_for_expr_column(self.expr)
        res = _execute([node._inner], live_df, force_reason)[0]
        return res[node._col_name]

    def head(self, n=5):
        node = self.frame._node_for_expr_column(self.expr)
        return LazyFrame(G.Head(node._inner, n), source_vocab=self.frame._vocab)


class StrAccessor:
    """Dict-encoded string ops: equality/isin against vocab (comparisons
    happen on int32 codes on the device).  Predicates over the vocab itself
    (contains / startswith / endswith / match-by-callable) stay lazy: the
    string work happens once on the (small) vocabulary, the per-row work is
    an integer isin on the codes."""

    def __init__(self, col: LazyColumn):
        self._col = col

    def _codes_for(self, values):
        vocab = self._col.frame._vocab_for(self._col.expr)
        idx = {v: i for i, v in enumerate(vocab)}
        return [idx[v] for v in values if v in idx]

    def _vocab_predicate(self, pred):
        vocab = self._col.frame._vocab_for(self._col.expr)
        codes = tuple(i for i, v in enumerate(vocab) if pred(v))
        if not codes:
            return LazyColumn(self._col.frame,
                              E.BinOp("lt", self._col.expr, E.Lit(0)))
        return LazyColumn(self._col.frame, E.IsIn(self._col.expr, codes))

    def contains(self, pat):
        return self._vocab_predicate(lambda v: pat in v)

    def startswith(self, pat):
        return self._vocab_predicate(lambda v: v.startswith(pat))

    def endswith(self, pat):
        return self._vocab_predicate(lambda v: v.endswith(pat))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        from repro_torch.pandas.fallback import str_fallback
        return str_fallback(self._col, name)

    def eq(self, value):
        codes = self._codes_for([value])
        if not codes:
            return LazyColumn(self._col.frame,
                              E.BinOp("lt", self._col.expr, E.Lit(0)))  # all-False
        return LazyColumn(self._col.frame,
                          E.BinOp("eq", self._col.expr, E.Lit(codes[0])))

    def isin(self, values):
        codes = self._codes_for(values)
        if not codes:
            return LazyColumn(self._col.frame,
                              E.BinOp("lt", self._col.expr, E.Lit(0)))
        return LazyColumn(self._col.frame, E.IsIn(self._col.expr, tuple(codes)))


class _BoundNode:
    def __init__(self, inner: G.Node, col_name: str):
        self._inner = inner
        self._col_name = col_name


class LazyScalar:
    """Lazy scalar (len(), .mean(), …).  Supports deferred f-string printing
    via the escape-marker mechanism of paper §3.3."""

    ESC = "\x00LAFP:"

    def __init__(self, node: G.Node):
        self.node = node
        get_context().scalar_registry[node.id] = node

    def compute(self, live_df=None, force_reason="scalar.compute"):
        return _execute([self.node], live_df, force_reason)[0]

    def __format__(self, spec):
        return f"{self.ESC}{self.node.id}\x00"

    def __str__(self):
        return self.__format__("")

    def __float__(self):
        return float(self.compute())

    def __int__(self):
        return int(self.compute())


class GroupBy:
    def __init__(self, frame: "LazyFrame", keys: Sequence[str]):
        self.frame = frame
        self.keys = [keys] if isinstance(keys, str) else list(keys)

    def __getitem__(self, col):
        return GroupByColumn(self, col)

    def agg(self, spec: Mapping[str, tuple[str, str]]):
        node = G.GroupByAgg(self.frame._node, self.keys, dict(spec))
        return LazyFrame(node, source_vocab=self.frame._vocab)

    def size(self):
        return self.agg({"size": (None, "count")})

    def __getattr__(self, name):
        if name.startswith("_") or name in ("frame", "keys"):
            raise AttributeError(name)
        cols = self.frame._known_columns()
        if cols is not None and name in cols:
            return GroupByColumn(self, name)   # gb.col.sum() sugar
        from repro_torch.pandas.fallback import groupby_fallback
        return groupby_fallback(self, None, name)


class GroupByColumn:
    def __init__(self, gb: GroupBy, col: str):
        self.gb = gb
        self.col = col

    def _agg(self, fn):
        return self.gb.agg({self.col: (self.col, fn)})

    def sum(self): return self._agg("sum")
    def mean(self): return self._agg("mean")
    def min(self): return self._agg("min")
    def max(self): return self._agg("max")
    def count(self): return self._agg("count")
    def nunique(self): return self._agg("nunique")

    def __getattr__(self, name):
        if name.startswith("_") or name in ("gb", "col"):
            raise AttributeError(name)
        from repro_torch.pandas.fallback import groupby_fallback
        return groupby_fallback(self.gb, self.col, name)


class LazyFrame:
    """The Fat DataFrame.  Wraps a DAG node; assignment mutates the binding
    (pandas semantics), each op adds a node (lazy semantics)."""

    def __init__(self, node: G.Node, source_vocab: Mapping[str, list] | None = None):
        self.__dict__["_node"] = node
        self.__dict__["_vocab"] = dict(source_vocab or {})

    # -- column access ------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return LazyColumn(self, E.Col(key))
        if isinstance(key, list):
            return LazyFrame(G.Project(self._node, key), source_vocab=self._vocab)
        if isinstance(key, LazyColumn):
            return LazyFrame(G.Filter(self._node, key.expr), source_vocab=self._vocab)
        raise TypeError(f"cannot index LazyFrame with {type(key)}")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        cols = self._known_columns()
        if cols is None or name in cols:
            return LazyColumn(self, E.Col(name))
        # Not a column of this frame: route through the fallback protocol
        # (repro_torch.pandas kernel table) instead of building a doomed Col ref.
        from repro_torch.pandas.fallback import frame_fallback
        return frame_fallback(self, name)

    def __setitem__(self, key: str, value):
        self.__dict__["_node"] = G.Assign(self._node, key, _to_expr(value))

    def __setattr__(self, key, value):
        if key.startswith("_"):
            self.__dict__[key] = value
        else:
            self[key] = value

    # -- pandas-shaped metadata ----------------------------------------------
    def _known_columns(self) -> frozenset[str] | None:
        """Output column set, propagated bottom-up through the DAG via
        ``Node.out_cols`` (None = statically unknown, e.g. past a MapRows).
        Memoized per node (nodes are immutable), so repeated attribute
        access stays O(1) amortized instead of O(graph)."""
        node = self._node
        if "_colset" in node.__dict__:
            return node.__dict__["_colset"]
        for n in G.walk([node]):
            if "_colset" in n.__dict__:
                continue
            n.__dict__["_colset"] = n.out_cols(
                [i.__dict__["_colset"] for i in n.inputs])
        return node.__dict__["_colset"]

    def _ordered_columns(self) -> list[str] | None:
        """Output columns in pandas order (source schema order + append
        order), or None when statically unknown.  Memoized like
        ``_known_columns``."""
        node = self._node
        if "_colorder" in node.__dict__:
            return node.__dict__["_colorder"]
        for n in G.walk([node]):
            if "_colorder" in n.__dict__:
                continue
            n.__dict__["_colorder"] = _ordered_out(
                n, [i.__dict__["_colorder"] for i in n.inputs])
        return node.__dict__["_colorder"]

    @property
    def columns(self) -> list[str]:
        ordered = self._ordered_columns()
        if ordered is not None:
            return list(ordered)
        cols = self._known_columns()
        if cols is not None:
            return sorted(cols)
        res = self.head(0).compute(force_reason="columns-property")
        return list(res.columns)

    @property
    def shape(self) -> tuple[int, int]:
        from repro_torch.pandas.fallback import record_fallback
        ncols = len(self.columns)
        n = int(_execute([G.Length(self._node)], None, "shape-property")[0])
        record_fallback("DataFrame.shape", (n, ncols), "property-force")
        return (n, ncols)

    # -- pandas-shaped ops ----------------------------------------------------
    def copy(self, deep=True):
        # nodes are immutable; a copy is just a new binding on the same DAG
        return LazyFrame(self._node, source_vocab=self._vocab)

    def drop(self, labels=None, columns=None, axis=1):
        dropped = columns if columns is not None else labels
        if dropped is None:
            raise TypeError("drop requires `columns` (or labels with axis=1)")
        dropped = [dropped] if isinstance(dropped, str) else list(dropped)
        cols = self._ordered_columns()
        if cols is None:
            known = self._known_columns()
            if known is None:
                from repro_torch.pandas.fallback import frame_fallback
                return frame_fallback(self, "drop")(columns=dropped)
            cols = sorted(known)
        keep = [c for c in cols if c not in dropped]
        return LazyFrame(G.Project(self._node, keep), source_vocab=self._vocab)

    def assign(self, **kwargs):
        node = self._node
        for k, v in kwargs.items():
            node = G.Assign(node, k, _to_expr(v))
        return LazyFrame(node, source_vocab=self._vocab)

    def rename(self, columns: Mapping[str, str]):
        return LazyFrame(G.Rename(self._node, columns), source_vocab=self._vocab)

    def astype(self, dtypes):
        if isinstance(dtypes, str):
            raise TypeError("astype requires {col: dtype}")
        return LazyFrame(G.AsType(self._node, {k: str(np.dtype(v))
                                               for k, v in dtypes.items()}),
                         source_vocab=self._vocab)

    def fillna(self, value):
        return LazyFrame(G.FillNa(self._node, value), source_vocab=self._vocab)

    def sort_values(self, by, ascending=True):
        by = [by] if isinstance(by, str) else list(by)
        return LazyFrame(G.SortValues(self._node, by, ascending),
                         source_vocab=self._vocab)

    def drop_duplicates(self, subset=None):
        subset = tuple(subset) if subset is not None else None
        return LazyFrame(G.DropDuplicates(self._node, subset),
                         source_vocab=self._vocab)

    def head(self, n=5):
        return LazyFrame(G.Head(self._node, n), source_vocab=self._vocab)

    def nlargest(self, n, columns):
        by = [columns] if isinstance(columns, str) else list(columns)
        return LazyFrame(G.TopK(self._node, by, n, ascending=False,
                                mode="select"), source_vocab=self._vocab)

    def nsmallest(self, n, columns):
        by = [columns] if isinstance(columns, str) else list(columns)
        return LazyFrame(G.TopK(self._node, by, n, ascending=True,
                                mode="select"), source_vocab=self._vocab)

    def groupby(self, keys):
        return GroupBy(self, keys)

    def merge(self, other: "LazyFrame", on, how="inner", suffixes=("_x", "_y")):
        on = [on] if isinstance(on, str) else list(on)
        vocab = {**other._vocab, **self._vocab}
        return LazyFrame(G.Join(self._node, other._node, on, how, suffixes),
                         source_vocab=vocab)

    def apply_rows(self, fn, name="udf"):
        """Whole-frame UDF escape hatch (pushdown barrier)."""
        return LazyFrame(G.MapRows(self._node, fn, name), source_vocab=self._vocab)

    def describe(self):
        # Paper §3.1 heuristic: describe/info/head don't make columns live;
        # handled in the optimizer — here it's a plain reduce-per-column sink.
        return LazyFrame(G.Head(self._node, 0), source_vocab=self._vocab)

    # -- force points ---------------------------------------------------------
    def compute(self, live_df=None, force_reason="compute"):
        """Force materialization (paper compute()).  ``live_df`` is the
        §3.5 live-frame hint — normally injected by analyze()."""
        return _execute([self._node], live_df, force_reason)[0]

    def materialize(self, live_df=None):
        return self.compute(live_df)

    def to_numpy_table(self, live_df=None):
        res = self.compute(live_df)
        return {k: to_host_array(v) for k, v in res.columns.items()}

    def __len__(self):
        return int(_execute([G.Length(self._node)], None, "len")[0])

    # -- helpers ---------------------------------------------------------------
    def _node_for_expr_column(self, expr_: E.Expr) -> _BoundNode:
        """Bind an expression to a concrete (node, column-name) pair, adding
        an Assign for composed expressions."""
        if isinstance(expr_, E.Col):
            return _BoundNode(self._node, expr_.name)
        name = f"__expr_{abs(hash(expr_.key())) % (1 << 30)}"
        return _BoundNode(G.Assign(self._node, name, expr_), name)

    def _vocab_for(self, expr_: E.Expr) -> list:
        if isinstance(expr_, E.Col) and expr_.name in self._vocab:
            return self._vocab[expr_.name]
        raise KeyError("no vocab for expression (str ops need a dict-encoded "
                       f"source column): {expr_}")

    def __repr__(self):
        # repr is a force point (pandas semantics: printing a frame shows
        # data).  Fall back to the structural repr if execution fails so
        # debugging a broken graph never raises from repr itself.
        try:
            return repr(self.compute(force_reason="repr"))
        except Exception:   # noqa: BLE001
            return f"LazyFrame({self._node!r})"


def _ordered_out(n: G.Node, ins: list[list | None]) -> list | None:
    """Ordered-column analogue of ``Node.out_cols``: output column *order*
    (pandas: source schema order, appends at the end), None = unknown."""
    if isinstance(n, G.Scan):
        return list(n.columns) if n.columns is not None \
            else list(n.source.schema.names)
    if isinstance(n, G.Project):
        return list(n.columns)
    if isinstance(n, G.Assign):
        c = ins[0]
        if c is None:
            return None
        return c if n.name in c else c + [n.name]
    if isinstance(n, G.Rename):
        c = ins[0]
        return None if c is None else [n.mapping.get(x, x) for x in c]
    if isinstance(n, G.GroupByAgg):
        return list(n.keys) + [k for k in n.aggs if k not in n.keys]
    if isinstance(n, G.Join):
        l, r = ins
        if l is None or r is None:
            return None
        overlap = (set(l) & set(r)) - set(n.on)
        out = [x + n.suffixes[0] if x in overlap else x for x in l]
        out += [x + n.suffixes[1] if x in overlap else x
                for x in r if x not in n.on]
        return out
    if isinstance(n, G.Concat):
        if any(c is None for c in ins):
            return None
        common = set(ins[0])
        for c in ins[1:]:
            common &= set(c)
        return [x for x in ins[0] if x in common]
    if isinstance(n, G.Materialized):
        return list(n.table.keys())
    if isinstance(n, (G.Reduce, G.Length, G.SinkPrint)):
        return []
    if isinstance(n, G.MapRows):
        return None
    # row-preserving pass-through (Filter, AsType, FillNa, SortValues,
    # DropDuplicates, Head)
    return ins[0] if ins else None


class Result:
    """Materialized frame: dict of arrays + vocab decoding for display."""

    def __init__(self, columns: Mapping[str, Any], vocab=None):
        self.columns = dict(columns)
        self.vocab = dict(vocab or {})

    def rows(self) -> int:
        for v in self.columns.values():
            return int(v.shape[0])
        return 0

    def __getitem__(self, k):
        return self.columns[k]

    def decode(self, col: str):
        codes = to_host_array(self.columns[col])
        vocab = self.vocab[col]
        return np.asarray([vocab[c] for c in codes], dtype=object)

    def __repr__(self):
        n = self.rows()
        cols = ", ".join(f"{k}:{getattr(v, 'dtype', '?')}"
                         for k, v in self.columns.items())
        lines = [f"<Result {n} rows [{cols}]>"]
        show = min(n, 10)
        names = list(self.columns)
        head = {c: to_host_array(v[:show]) for c, v in self.columns.items()}
        lines.append(" | ".join(f"{x:>12}" for x in names))
        for i in range(show):
            vals = []
            for c in names:
                v = head[c][i]
                if c in self.vocab:
                    v = self.vocab[c][int(v)]
                vals.append(f"{v!s:>12.12}")
            lines.append(" | ".join(vals))
        if n > show:
            lines.append(f"... ({n - show} more rows)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Constructors ("pd." namespace functions)


def read_source(source: Source) -> LazyFrame:
    return LazyFrame(G.Scan(source), source_vocab=source.dicts)


def from_arrays(arrays: Mapping[str, np.ndarray], partition_rows: int = 1 << 16,
                dicts=None, datetimes=(), name="mem") -> LazyFrame:
    src = InMemorySource(arrays, partition_rows, dicts, datetimes, name)
    return read_source(src)


def read_npz(path: str) -> LazyFrame:
    from .source import NpzDirectorySource
    return read_source(NpzDirectorySource(path))


# ---------------------------------------------------------------------------
# Execution entry (shared by frames/scalars/sinks)


def _execute(roots: list[G.Node], live_df=None,
             force_reason: str | None = None) -> list[Any]:
    from .runtime import execute  # late import: runtime pulls optimizer+backends
    return execute(roots, live_df, force_reason)
