"""Graceful fallback protocol for the `repro_torch.pandas` facade.

Any DataFrame / Series / GroupBy method or accessor field the lazy layer
does not implement natively is served from a registered numpy-level kernel
table instead of raising ``AttributeError``:

* **aligned elementwise ops** (clip, abs, round, dt.dayofyear, str.len, …)
  stay lazy — the kernel is wrapped as a UDF expression node and executes
  per partition at force time (safe: value depends only on the row);
* **everything else** (nlargest, value_counts, quantile, groupby.std, …)
  *materializes its inputs*, runs the kernel eagerly on host numpy, and
  re-wraps the result as a new lazy in-memory source;
* ops with **no registered kernel** raise ``AttributeError`` *after*
  recording the gap.

Every event is appended to ``ctx.fallback_trace`` as a :class:`FallbackEvent`
(op name, input shape, force reason, status) — API coverage is measured
(`benchmarks/run.py api_coverage`), not asserted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core.context import get_context
from repro_torch.core.physical.table import to_host_array
from repro_torch.core.source import InMemorySource, encode_strings


@dataclasses.dataclass
class FallbackEvent:
    op: str                      # e.g. "DataFrame.nlargest", "Series.dt.quarter"
    shape: tuple | None          # input shape (rows, cols) when materialized
    reason: str                  # why/how the fallback fired
    status: str = "fallback"     # "fallback" (served) | "failed" (no kernel)

    def __str__(self):
        shape = "x".join(map(str, self.shape)) if self.shape else "?"
        return f"{self.status}: {self.op} [{shape}] {self.reason}"


def record_fallback(op: str, shape: tuple | None, reason: str,
                    status: str = "fallback") -> FallbackEvent:
    ev = FallbackEvent(op, shape, reason, status)
    ctx = get_context()
    ctx.fallback_trace.append(ev)
    # telemetry (repro_torch.obs): count served/failed fallbacks, and — when a
    # profile is attached — record an instant "fallback" event span
    metrics = getattr(ctx, "metrics", None)
    if metrics is not None:
        metrics.inc("fallback.failed" if status == "failed"
                    else "fallback.served")
    tracer = getattr(ctx, "tracer", None)
    if tracer is not None and tracer.enabled:
        tracer.event("fallback", op=op, status=status, reason=reason,
                     **({"shape": shape} if shape else {}))
    return ev


def _unsupported(op: str):
    record_fallback(op, None, "no-registered-kernel", status="failed")
    raise AttributeError(
        f"{op} has no native lazy implementation and no fallback kernel; "
        "the gap was recorded in get_context().fallback_trace")


# ---------------------------------------------------------------------------
# Re-wrapping kernel outputs as lazy values


def _frame_from(arrays: dict, dicts: dict | None, op: str):
    from repro_torch.core.lazyframe import LazyFrame
    from repro_torch.core import graph as G
    src = InMemorySource({k: np.asarray(v) for k, v in arrays.items()},
                         dicts=dicts, name=f"fallback:{op}")
    return LazyFrame(G.Scan(src), source_vocab=src.dicts)


def _series_from(arr: np.ndarray, name: str, op: str, vocab: list | None = None):
    dicts = {name: vocab} if vocab is not None else None
    return _frame_from({name: arr}, dicts, op)[name]


def _rewrap(value, vocab: dict, op: str, series_name: str = "value"):
    """Kernel output → lazy value: dict → LazyFrame backed by a fresh
    in-memory source, ndarray → single-column Series, numpy scalar →
    python scalar; anything else passes through raw."""
    if isinstance(value, dict):
        dicts = {k: vocab[k] for k in value if k in (vocab or {})}
        return _frame_from(value, dicts, op)
    if isinstance(value, np.ndarray):
        return _series_from(value, series_name, op)
    if isinstance(value, np.generic):
        return value.item()
    return value


def _materialize_frame(frame, op: str):
    res = frame.compute(force_reason=f"fallback:{op}")
    cols = {k: to_host_array(v) for k, v in res.columns.items()}
    rows = res.rows()
    return cols, res.vocab, (rows, len(cols))


# ---------------------------------------------------------------------------
# DataFrame-level kernels: (cols, vocab, *args, **kwargs) -> dict | scalar |
# raw python object.  ``cols`` is a dict of host numpy arrays.


def _float_cols(cols, subset=None):
    names = subset if subset is not None else list(cols)
    return [n for n in names if cols[n].dtype.kind == "f"]


def _take(cols, idx):
    return {k: v[idx] for k, v in cols.items()}


def _k_dropna(cols, vocab, subset=None):
    mask = None
    for n in _float_cols(cols, subset):
        m = ~np.isnan(cols[n])
        mask = m if mask is None else (mask & m)
    if mask is None:
        return dict(cols)
    return _take(cols, np.flatnonzero(mask))


def _k_tail(cols, vocab, n=5):
    return {k: v[-n:] if n else v[:0] for k, v in cols.items()}


def _drop_nan_idx(arr):
    """Index of non-NaN entries (pandas nlargest/nsmallest drop NaN)."""
    if arr.dtype.kind == "f":
        return np.flatnonzero(~np.isnan(arr))
    return np.arange(len(arr))


def _k_nlargest(cols, vocab, n, columns):
    key = columns if isinstance(columns, str) else columns[0]
    valid = _drop_nan_idx(cols[key])
    idx = valid[np.argsort(cols[key][valid], kind="stable")[::-1][:n]]
    return _take(cols, idx)


def _k_nsmallest(cols, vocab, n, columns):
    key = columns if isinstance(columns, str) else columns[0]
    valid = _drop_nan_idx(cols[key])
    idx = valid[np.argsort(cols[key][valid], kind="stable")[:n]]
    return _take(cols, idx)


def _k_sample(cols, vocab, n=None, frac=None, random_state=0):
    rows = len(next(iter(cols.values()))) if cols else 0
    if n is None:
        n = int(round(rows * (frac if frac is not None else 1.0)))
    rng = np.random.default_rng(random_state)
    idx = rng.choice(rows, size=min(n, rows), replace=False)
    return _take(cols, idx)


def _k_identity(cols, vocab, *args, **kwargs):
    return dict(cols)


def _frame_stat(fn):
    def kern(cols, vocab, **kwargs):
        out = {}
        for name, arr in cols.items():
            if arr.dtype.kind in "if" and name not in (vocab or {}):
                out[name] = np.asarray([fn(arr, **kwargs)])
        return out
    return kern


def _k_query(cols, vocab, expr: str):
    # pandas.query fallback: textual predicate evaluated against the
    # materialized columns.  Word operators become bitwise ones with each
    # clause parenthesized — '&' binds tighter than comparisons, so
    # 'a == 1 and b == 2' must become '(a == 1) & (b == 2)'.
    txt = "(" + expr.replace(" and ", ") & (").replace(" or ", ") | (") + ")"
    txt = txt.replace("not ", "~")
    mask = eval(txt, {"__builtins__": {}}, dict(cols))  # noqa: S307
    return _take(cols, np.flatnonzero(np.asarray(mask)))


def _k_iterrows(cols, vocab):
    names = list(cols)
    rows = len(cols[names[0]]) if names else 0
    def gen():
        for i in range(rows):
            yield i, {n: cols[n][i] for n in names}
    return gen()


def _q(arr, q=0.5, **kw):
    return np.nanquantile(arr, q)


# skipna=True statistics (pandas default): NaN-aware for float inputs
def _nanmedian(a):
    return np.nanmedian(a)


def _nanstd(a, ddof=1):
    return np.nanstd(a, ddof=ddof)


def _nanvar(a, ddof=1):
    return np.nanvar(a, ddof=ddof)


def _k_drop(cols, vocab, columns):
    columns = [columns] if isinstance(columns, str) else list(columns)
    return {k: v for k, v in cols.items() if k not in columns}


FRAME_KERNELS = {
    "drop": _k_drop,
    "dropna": _k_dropna,
    "tail": _k_tail,
    "nlargest": _k_nlargest,
    "nsmallest": _k_nsmallest,
    "sample": _k_sample,
    "reset_index": _k_identity,
    "sort_index": _k_identity,
    "query": _k_query,
    "iterrows": _k_iterrows,
    "median": _frame_stat(_nanmedian),
    "std": _frame_stat(_nanstd),
    "var": _frame_stat(_nanvar),
    "quantile": _frame_stat(_q),
}


def frame_fallback(frame, name: str):
    kern = FRAME_KERNELS.get(name)
    if kern is None:
        _unsupported(f"DataFrame.{name}")

    def bound(*args, **kwargs):
        cols, vocab, shape = _materialize_frame(frame, name)
        record_fallback(f"DataFrame.{name}", shape, "materialize-input")
        return _rewrap(kern(cols, vocab, *args, **kwargs), vocab, name)

    bound.__name__ = name
    bound.__qualname__ = f"LazyFrame.{name} (fallback)"
    return bound


# ---------------------------------------------------------------------------
# Series-level kernels.
#
# SERIES_ELEMENTWISE: aligned, row-local — wrapped as a lazy UDF node
# (correct under any partitioning).  SERIES_KERNELS: order/whole-column
# semantics — materialize the column eagerly.


SERIES_ELEMENTWISE = {
    "clip": lambda a, lower=None, upper=None: np.clip(a, lower, upper),
    "abs": lambda a: np.abs(a),
    "round": lambda a, decimals=0: np.round(a, decimals),
    "isna": lambda a: np.isnan(a) if a.dtype.kind == "f" else np.zeros(len(a), bool),
    "isnull": lambda a: np.isnan(a) if a.dtype.kind == "f" else np.zeros(len(a), bool),
    "notna": lambda a: ~np.isnan(a) if a.dtype.kind == "f" else np.ones(len(a), bool),
    "between": lambda a, left, right: (a >= left) & (a <= right),
    "floor": lambda a: np.floor(a),
    "sqrt": lambda a: np.sqrt(a),
}


def _s_unique(arr):
    _, first = np.unique(arr, return_index=True)
    return arr[np.sort(first)]          # first-occurrence order (pandas)


def _s_value_counts(arr):
    uniq, counts = np.unique(arr, return_counts=True)
    order = np.argsort(counts, kind="stable")[::-1]
    return {"value": uniq[order], "count": counts[order]}


SERIES_KERNELS = {
    # median graduated to a native Reduce node (repro_torch.core.physical.reduce)
    "std": lambda arr, ddof=1: np.nanstd(arr, ddof=ddof),
    "var": lambda arr, ddof=1: np.nanvar(arr, ddof=ddof),
    "quantile": lambda arr, q=0.5: np.nanquantile(arr, q),
    "unique": _s_unique,
    "value_counts": _s_value_counts,
    "nlargest": lambda arr, n=5: arr[np.argsort(arr, kind="stable")[::-1][:n]],
    "nsmallest": lambda arr, n=5: arr[np.argsort(arr, kind="stable")[:n]],
    # order-dependent length-preserving ops: correct only on the whole
    # column, so they materialize rather than wrap as a per-partition UDF
    "cumsum": lambda arr: np.cumsum(arr),
    "cummax": lambda arr: np.maximum.accumulate(arr),
    "cummin": lambda arr: np.minimum.accumulate(arr),
    "diff": lambda arr: np.concatenate([[np.nan], np.diff(arr.astype(np.float64))]),
    "shift": lambda arr, periods=1: _s_shift(arr, periods),
    "rank": lambda arr: _s_rank(arr),
    "mode": lambda arr: _s_value_counts(arr)["value"][:1],
}


def _s_shift(arr, periods=1):
    arr = arr.astype(np.float64)
    if periods == 0:
        return arr
    if periods > 0:
        return np.concatenate([np.full(periods, np.nan), arr[:-periods]])
    return np.concatenate([arr[-periods:], np.full(-periods, np.nan)])


def _s_rank(arr):
    """pandas default rank: method='average', NaN stays NaN."""
    arr = np.asarray(arr)
    out = np.full(len(arr), np.nan)
    valid = ~np.isnan(arr) if arr.dtype.kind == "f" else np.ones(len(arr), bool)
    vals = arr[valid]
    if not len(vals):
        return out
    order = np.argsort(vals, kind="stable")
    ordinal = np.empty(len(vals))
    ordinal[order] = np.arange(1, len(vals) + 1)
    uniq, inv = np.unique(vals, return_inverse=True)
    avg = np.bincount(inv, weights=ordinal) / np.bincount(inv)
    out[valid] = avg[inv]
    return out


def _series_name(col) -> str:
    return col.expr.name if isinstance(col.expr, E.Col) else "value"


def _materialize_series(col, op: str) -> np.ndarray:
    return to_host_array(col.compute(force_reason=f"fallback:{op}"))


def series_fallback(col, name: str):
    from repro_torch.core.lazyframe import LazyColumn

    if name in SERIES_ELEMENTWISE:
        kern = SERIES_ELEMENTWISE[name]

        def wrapped(*args, **kwargs):
            record_fallback(f"Series.{name}", None, "wrapped-udf")
            fn = lambda a: kern(np.asarray(a), *args, **kwargs)  # noqa: E731
            return LazyColumn(col.frame,
                              E.UDF(fn, (col.expr,), name=f"fallback.{name}"))

        wrapped.__name__ = name
        return wrapped

    kern = SERIES_KERNELS.get(name)
    if kern is None:
        _unsupported(f"Series.{name}")

    def bound(*args, **kwargs):
        arr = _materialize_series(col, name)
        record_fallback(f"Series.{name}", (len(arr),), "materialize-input")
        out = kern(arr, *args, **kwargs)
        try:
            svocab = col.frame._vocab_for(col.expr)
        except KeyError:
            svocab = None
        if svocab is not None:
            # dict-encoded column: results carrying codes keep their vocab
            if isinstance(out, dict) and "value" in out:
                return _frame_from(out, {"value": svocab}, name)
            if isinstance(out, np.ndarray) and out.dtype.kind in "iu":
                return _series_from(out, _series_name(col), name, vocab=svocab)
        return _rewrap(out, {}, name, series_name=_series_name(col))

    bound.__name__ = name
    return bound


# ---------------------------------------------------------------------------
# GroupBy fallback: aggregations the GroupByAgg node doesn't know
# (median/std/var/first/last/quantile) via a host numpy group-apply.


GROUPBY_REDUCERS = {
    "median": lambda g: np.nanmedian(g),
    "std": lambda g: np.nanstd(g, ddof=1),
    "var": lambda g: np.nanvar(g, ddof=1),
    "first": lambda g: g[0],
    "last": lambda g: g[-1],
    "quantile": lambda g, q=0.5: np.nanquantile(g, q),
}


def _groupby_apply(cols, keys, targets, reducer, *args, **kwargs):
    keyarrs = [np.asarray(cols[k]) for k in keys]
    rows = len(keyarrs[0])
    if rows == 0:
        out = {k: ka[:0] for k, ka in zip(keys, keyarrs)}
        for t in targets:
            out[t] = np.asarray(cols[t])[:0].astype(np.float64)
        return out
    combined = np.zeros(rows, np.int64)
    for ka in keyarrs:
        uniq, inv = np.unique(ka, return_inverse=True)
        combined = combined * max(len(uniq), 1) + inv
    _, ginv = np.unique(combined, return_inverse=True)
    order = np.argsort(ginv, kind="stable")
    bounds = np.flatnonzero(np.diff(ginv[order])) + 1
    first_idx = order[np.concatenate([[0], bounds])] if rows else order[:0]
    out = {k: np.asarray(cols[k])[first_idx] for k in keys}
    for t in targets:
        groups = np.split(np.asarray(cols[t])[order], bounds)
        out[t] = np.asarray([reducer(g, *args, **kwargs) for g in groups])
    return out


def groupby_fallback(gb, col: str | None, name: str):
    reducer = GROUPBY_REDUCERS.get(name)
    if reducer is None:
        _unsupported(f"GroupBy.{name}")

    def bound(*args, **kwargs):
        cols, vocab, shape = _materialize_frame(gb.frame, f"groupby.{name}")
        record_fallback(f"GroupBy.{name}", shape, "materialize-input")
        if col is not None:
            targets = [col]
        else:
            targets = [n for n in cols
                       if n not in gb.keys and cols[n].dtype.kind in "if"
                       and n not in (vocab or {})]
        out = _groupby_apply(cols, gb.keys, targets, reducer, *args, **kwargs)
        return _rewrap(out, vocab, f"groupby.{name}")

    bound.__name__ = name
    return bound


# ---------------------------------------------------------------------------
# .dt accessor fallback fields (aligned elementwise → lazy UDF wrap).


def _dt_civil(ts):
    return E._civil_from_days(np.asarray(ts) // 86400)


def _dt_dayofyear(ts):
    d64 = np.asarray(ts).astype("int64").astype("datetime64[s]")
    day = d64.astype("datetime64[D]")
    jan1 = d64.astype("datetime64[Y]").astype("datetime64[D]")
    return (day - jan1).astype(np.int64) + 1


def _dt_days_in_month(ts):
    m = np.asarray(ts).astype("int64").astype("datetime64[s]").astype("datetime64[M]")
    return ((m + 1).astype("datetime64[D]") - m.astype("datetime64[D]")).astype(np.int64)


DT_KERNELS = {
    "weekday": lambda ts: ((np.asarray(ts) // 86400) + 3) % 7,
    "dayofyear": _dt_dayofyear,
    # quarter graduated to a native DtField expr (repro_torch.core.expr._DT_FIELDS)
    "days_in_month": _dt_days_in_month,
    "is_month_start": lambda ts: _dt_civil(ts)[2] == 1,
    "is_month_end": lambda ts: _dt_civil(ts)[2] == _dt_days_in_month(ts),
}


def dt_fallback(col, field: str):
    from repro_torch.core.lazyframe import LazyColumn
    kern = DT_KERNELS.get(field)
    if kern is None:
        _unsupported(f"Series.dt.{field}")
    record_fallback(f"Series.dt.{field}", None, "wrapped-udf")
    fn = lambda a: kern(np.asarray(a))  # noqa: E731
    return LazyColumn(col.frame, E.UDF(fn, (col.expr,), name=f"fallback.dt.{field}"))


# ---------------------------------------------------------------------------
# .str accessor fallback: vocab transforms.  ``len`` is elementwise over a
# per-code lookup table (lazy); casing/strip transforms rebuild the vocab
# eagerly and re-encode.


_STR_TRANSFORMS = {
    "upper": str.upper,
    "lower": str.lower,
    "title": str.title,
    "strip": str.strip,
    "capitalize": str.capitalize,
}


def str_fallback(col, name: str):
    from repro_torch.core.lazyframe import LazyColumn
    try:
        vocab = col.frame._vocab_for(col.expr)
    except KeyError:
        _unsupported(f"Series.str.{name}")

    if name == "len":
        lut = np.asarray([len(v) for v in vocab], np.int64)
        def bound():
            record_fallback("Series.str.len", None, "wrapped-udf")
            fn = lambda a: lut[np.asarray(a)]  # noqa: E731
            return LazyColumn(col.frame, E.UDF(fn, (col.expr,), name="fallback.str.len"))
        return bound

    xform = _STR_TRANSFORMS.get(name)
    if xform is None:
        _unsupported(f"Series.str.{name}")

    def bound():
        codes = _materialize_series(col, f"str.{name}")
        record_fallback(f"Series.str.{name}", (len(codes),), "materialize-input")
        new_codes, new_vocab = encode_strings([xform(vocab[c]) for c in codes])
        return _series_from(new_codes, _series_name(col), f"str.{name}",
                            vocab=new_vocab)

    bound.__name__ = name
    return bound
