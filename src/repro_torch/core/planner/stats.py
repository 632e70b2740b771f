"""Statistics layer: per-source and per-node cardinality/width estimation.

Leaf stats are derived from metadata the engine already maintains —
partition metas (rows), zone maps (min/max), dict vocabularies (exact NDV)
— and propagated through the DAG.  Nothing here touches data; estimation
is pure metadata arithmetic, cheap enough to run at every force point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from .. import expr as E
from .. import graph as G

# Fallback selectivities when no metadata applies (classic System R knobs).
DEFAULT_SELECTIVITY = 1.0 / 3.0
DEFAULT_EQ_SELECTIVITY = 0.1
MIN_SELECTIVITY = 1e-4


@dataclasses.dataclass
class TableStats:
    """Estimated shape of one operator's output."""
    rows: float
    col_bytes: dict[str, float]           # per-column bytes per row
    ndv: dict[str, float]                 # per-column distinct-count estimate
    zonemap: dict[str, tuple]             # col -> (min, max) over all rows
    exact: bool = False                   # True when taken from feedback/meta

    @property
    def row_bytes(self) -> float:
        return sum(self.col_bytes.values()) or 8.0

    @property
    def total_bytes(self) -> float:
        return self.rows * self.row_bytes

    def col_ndv(self, name: str) -> float:
        """NDV estimate for a column, capped by the row count."""
        v = self.ndv.get(name)
        if v is None:
            v = math.sqrt(self.rows) if self.rows > 0 else 1.0
        return max(1.0, min(v, self.rows or 1.0))

    def scaled(self, selectivity: float) -> "TableStats":
        sel = max(MIN_SELECTIVITY, min(1.0, selectivity))
        return TableStats(
            rows=self.rows * sel,
            col_bytes=dict(self.col_bytes),
            ndv={c: max(1.0, v * sel) for c, v in self.ndv.items()},
            zonemap=dict(self.zonemap),
        )


def source_stats(source, columns=None, skip_partitions=frozenset()) -> TableStats:
    """Leaf statistics from partition metas + zone maps + dict vocabularies."""
    names = tuple(columns) if columns is not None else source.schema.names
    rows = 0
    zonemap: dict[str, tuple] = {}
    metas_ok = True
    for pi in range(source.n_partitions):
        if pi in skip_partitions:
            continue
        meta = source.partition_meta(pi)
        if "rows" not in meta:
            metas_ok = False
            break
        rows += meta["rows"]
        for c, (lo, hi) in meta.get("zonemap", {}).items():
            if c not in names:
                continue
            if c in zonemap:
                plo, phi = zonemap[c]
                zonemap[c] = (min(plo, lo), max(phi, hi))
            else:
                zonemap[c] = (lo, hi)
    if not metas_ok:
        rows = 1 << 20  # unknown source size: assume big, plan conservatively
    col_bytes = {}
    ndv = {}
    for c in names:
        cs = source.schema.col(c)
        col_bytes[c] = float(cs.itemsize)
        est = source.column_ndv(c) if hasattr(source, "column_ndv") else None
        if est is None and c in zonemap and cs.np_dtype.kind in "iu":
            lo, hi = zonemap[c]
            est = hi - lo + 1
        if est is not None:
            ndv[c] = float(min(est, rows or 1))
    return TableStats(rows=float(rows), col_bytes=col_bytes, ndv=ndv,
                      zonemap=zonemap, exact=metas_ok)


# ---------------------------------------------------------------------------
# Selectivity estimation


def _range_fraction(lo: float, hi: float, cut: float, side: str) -> float:
    """Fraction of a uniform [lo, hi] column passing ``col <side> cut``."""
    if hi <= lo:
        # degenerate zone: all rows equal lo
        passes = {"lt": lo < cut, "le": lo <= cut,
                  "gt": lo > cut, "ge": lo >= cut}[side]
        return 1.0 if passes else MIN_SELECTIVITY
    frac = (cut - lo) / (hi - lo)
    if side in ("gt", "ge"):
        frac = 1.0 - frac
    return max(MIN_SELECTIVITY, min(1.0, frac))


_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def predicate_selectivity(pred: E.Expr, stats: TableStats) -> float:
    """Estimated fraction of rows passing ``pred`` on a table with ``stats``.

    Range predicates interpolate against the merged zone map (uniformity
    assumption); equality uses 1/NDV; boolean combinators compose assuming
    independence.  Falls back to System-R-style constants.
    """
    if isinstance(pred, E.Not):
        return max(MIN_SELECTIVITY, 1.0 - predicate_selectivity(pred.child, stats))
    if isinstance(pred, E.IsIn):
        if isinstance(pred.child, E.Col):
            ndv = stats.col_ndv(pred.child.name)
            return max(MIN_SELECTIVITY, min(1.0, len(pred.values) / ndv))
        return DEFAULT_EQ_SELECTIVITY
    if not isinstance(pred, E.BinOp):
        return DEFAULT_SELECTIVITY
    if pred.op == "and":
        return max(MIN_SELECTIVITY,
                   predicate_selectivity(pred.left, stats)
                   * predicate_selectivity(pred.right, stats))
    if pred.op == "or":
        sl = predicate_selectivity(pred.left, stats)
        sr = predicate_selectivity(pred.right, stats)
        return min(1.0, sl + sr - sl * sr)
    if pred.op in ("lt", "le", "gt", "ge"):
        # normalize to col-vs-constant using interval bounds
        side, left, right = pred.op, pred.left, pred.right
        if isinstance(right, E.Col) and not isinstance(left, E.Col):
            side, left, right = _FLIP[side], right, left
        lb = left.bounds(stats.zonemap)
        rb = right.bounds(stats.zonemap)
        if lb is not None and rb is not None:
            (llo, lhi), (rlo, rhi) = lb, rb
            cut = (rlo + rhi) / 2.0
            return _range_fraction(llo, lhi, cut, side)
        return DEFAULT_SELECTIVITY
    if pred.op == "eq":
        for side in (pred.left, pred.right):
            if isinstance(side, E.Col):
                return max(MIN_SELECTIVITY, min(1.0, 1.0 / stats.col_ndv(side.name)))
        return DEFAULT_EQ_SELECTIVITY
    if pred.op == "ne":
        for side in (pred.left, pred.right):
            if isinstance(side, E.Col):
                return max(MIN_SELECTIVITY,
                           1.0 - min(1.0, 1.0 / stats.col_ndv(side.name)))
        return 1.0 - DEFAULT_EQ_SELECTIVITY
    return DEFAULT_SELECTIVITY


# ---------------------------------------------------------------------------
# Per-node propagation


def _table_stats_of(table: Mapping) -> TableStats:
    import numpy as np
    rows = 0
    col_bytes = {}
    for k, v in table.items():
        arr = v if hasattr(v, "element_size") else np.asarray(v)
        rows = int(arr.shape[0]) if arr.ndim else 0
        col_bytes[k] = float(arr.element_size() if hasattr(arr, "element_size")
                             else arr.dtype.itemsize)
    return TableStats(rows=float(rows), col_bytes=col_bytes, ndv={},
                      zonemap={}, exact=True)


def scan_read_profile(n: "G.Scan") -> tuple[float, float] | None:
    """``(rows, bytes)`` the scan will actually read: rows over *unpruned*
    partitions × the width of the read column set (output projection ∪
    pushed-down predicate columns).  ``None`` when partition metas lack
    row counts — callers fall back to whole-table size."""
    rows = 0
    for pi in range(n.source.n_partitions):
        if pi in n.skip_partitions:
            continue
        meta = n.source.partition_meta(pi)
        if "rows" not in meta:
            return None
        rows += meta["rows"]
    names = n.columns if n.columns is not None else n.source.schema.names
    read = set(names)
    if n.pushdown is not None:
        read |= {c for c in n.pushdown.used_cols()
                 if c in n.source.schema.names}
    width = sum(n.source.schema.col(c).itemsize for c in read)
    return float(rows), float(rows * width)


def scan_read_bytes(n: "G.Scan") -> float | None:
    prof = scan_read_profile(n)
    return prof[1] if prof is not None else None


def estimate_node(n: G.Node, child_stats: list[TableStats]) -> TableStats:
    """One-step propagation of TableStats through an operator."""
    if isinstance(n, G.Scan):
        st = source_stats(n.source, n.columns, n.skip_partitions)
        if n.pushdown is not None:
            # the pushed-down predicate filters rows at load time, so the
            # scan's *output* carries the filter's selectivity
            st = st.scaled(predicate_selectivity(n.pushdown.predicate, st))
        return st
    if isinstance(n, G.Materialized):
        return _table_stats_of(n.table)
    if isinstance(n, G.Handoff):
        if isinstance(n.value, dict):
            return _table_stats_of(n.value)
        return TableStats(rows=0.0, col_bytes={}, ndv={}, zonemap={},
                          exact=True)
    if isinstance(n, (G.Reduce, G.Length)):
        return TableStats(rows=0.0, col_bytes={}, ndv={}, zonemap={})
    if isinstance(n, G.SinkPrint):
        return TableStats(rows=0.0, col_bytes={}, ndv={}, zonemap={})
    c = child_stats[0] if child_stats else TableStats(0.0, {}, {}, {})
    if isinstance(n, G.FusedRowwise):
        st = c
        for m in n.ops:          # fold member estimates innermost-first
            st = estimate_node(m, [st])
        return st
    if isinstance(n, G.Filter):
        return c.scaled(predicate_selectivity(n.predicate, c))
    if isinstance(n, G.Project):
        return TableStats(
            rows=c.rows,
            col_bytes={k: c.col_bytes.get(k, 8.0) for k in n.columns},
            ndv={k: v for k, v in c.ndv.items() if k in n.columns},
            zonemap={k: v for k, v in c.zonemap.items() if k in n.columns})
    if isinstance(n, G.Assign):
        out = TableStats(c.rows, dict(c.col_bytes), dict(c.ndv), dict(c.zonemap))
        out.col_bytes[n.name] = 8.0
        b = n.expr.bounds(c.zonemap)
        if b is not None:
            out.zonemap[n.name] = b
        else:
            out.zonemap.pop(n.name, None)
        out.ndv.pop(n.name, None)
        return out
    if isinstance(n, G.Rename):
        m = n.mapping
        return TableStats(
            rows=c.rows,
            col_bytes={m.get(k, k): v for k, v in c.col_bytes.items()},
            ndv={m.get(k, k): v for k, v in c.ndv.items()},
            zonemap={m.get(k, k): v for k, v in c.zonemap.items()})
    if isinstance(n, G.AsType):
        import numpy as np
        out = TableStats(c.rows, dict(c.col_bytes), dict(c.ndv), dict(c.zonemap))
        for col, dt in n.dtypes.items():
            out.col_bytes[col] = float(np.dtype(dt).itemsize)
        return out
    if isinstance(n, G.FillNa):
        return c
    if isinstance(n, G.SortValues):
        return c
    if isinstance(n, G.DropDuplicates):
        cols = n.subset or tuple(c.col_bytes)
        distinct = 1.0
        for col in cols:
            distinct *= c.col_ndv(col)
            if distinct >= c.rows:
                break
        return TableStats(rows=min(c.rows, distinct),
                          col_bytes=dict(c.col_bytes), ndv=dict(c.ndv),
                          zonemap=dict(c.zonemap))
    if isinstance(n, (G.Head, G.TopK)):
        return TableStats(rows=min(float(n.n), c.rows),
                          col_bytes=dict(c.col_bytes), ndv=dict(c.ndv),
                          zonemap=dict(c.zonemap))
    if isinstance(n, G.MapRows):
        return TableStats(rows=c.rows, col_bytes=dict(c.col_bytes),
                          ndv={}, zonemap={})
    if isinstance(n, G.GroupByAgg):
        groups = 1.0
        for k in n.keys:
            groups *= c.col_ndv(k)
            if groups >= c.rows:
                break
        groups = max(1.0, min(groups, c.rows or 1.0))
        col_bytes = {k: c.col_bytes.get(k, 8.0) for k in n.keys}
        for out_name in n.aggs:
            col_bytes[out_name] = 8.0
        ndv = {k: min(c.col_ndv(k), groups) for k in n.keys}
        zonemap = {k: v for k, v in c.zonemap.items() if k in n.keys}
        return TableStats(rows=groups, col_bytes=col_bytes, ndv=ndv,
                          zonemap=zonemap)
    if isinstance(n, G.Join):
        l, r = child_stats
        key_ndv = 1.0
        for k in n.on:
            key_ndv *= max(l.col_ndv(k), r.col_ndv(k))
        key_ndv = max(1.0, key_ndv)
        rows = l.rows * r.rows / key_ndv
        if n.how == "left":
            rows = max(rows, l.rows)
        col_bytes = dict(l.col_bytes)
        for k, v in r.col_bytes.items():
            if k in col_bytes and k not in n.on:
                col_bytes[k + n.suffixes[0]] = col_bytes.pop(k)
                col_bytes[k + n.suffixes[1]] = v
            elif k not in col_bytes:
                col_bytes[k] = v
        ndv = {**r.ndv, **l.ndv}
        zonemap = {**r.zonemap, **l.zonemap}
        return TableStats(rows=rows, col_bytes=col_bytes, ndv=ndv,
                          zonemap=zonemap)
    if isinstance(n, G.Concat):
        rows = sum(s.rows for s in child_stats)
        cols: dict[str, float] = {}
        for s in child_stats:
            for k, v in s.col_bytes.items():
                cols[k] = max(cols.get(k, 0.0), v)
        ndv: dict[str, float] = {}
        for s in child_stats:
            for k, v in s.ndv.items():
                ndv[k] = ndv.get(k, 0.0) + v
        return TableStats(rows=rows, col_bytes=cols, ndv=ndv, zonemap={})
    # unknown operator: pass through conservatively
    return c


def estimate_plan(roots: list[G.Node], ctx=None) -> dict[int, TableStats]:
    """TableStats per node id for the whole DAG (post-order walk).

    When ``ctx.stats_store`` holds observed cardinalities for a node's
    structural key (feedback loop), the observation overrides the estimate
    — repeated plans converge to actual row counts.
    """
    store = getattr(ctx, "stats_store", None) if ctx is not None else None
    out: dict[int, TableStats] = {}
    for n in G.walk(roots):
        est = estimate_node(n, [out[i.id] for i in n.inputs])
        if store is not None:
            obs = store.lookup(_safe_key(n))
            if obs is not None and est.rows > 0:
                ratio = obs["rows"] / est.rows if est.rows else 1.0
                est = TableStats(rows=float(obs["rows"]),
                                 col_bytes=dict(est.col_bytes),
                                 ndv={c: max(1.0, v * min(1.0, ratio))
                                      for c, v in est.ndv.items()},
                                 zonemap=dict(est.zonemap), exact=True)
            elif obs is not None:
                est = TableStats(rows=float(obs["rows"]),
                                 col_bytes=dict(est.col_bytes),
                                 ndv=dict(est.ndv), zonemap=dict(est.zonemap),
                                 exact=True)
        out[n.id] = est
    return out


def _safe_key(n: G.Node):
    try:
        return n.key()
    except Exception:  # side-effect nodes key fine; belt and braces
        return ("id", n.id)
