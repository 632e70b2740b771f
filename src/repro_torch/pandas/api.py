"""Pandas-shaped top-level entry points for the `repro_torch.pandas` facade:
``DataFrame`` / ``Series`` constructors and the module functions ``concat``,
``merge``, ``to_datetime``, ``isna``.

Everything returns lazy values (LazyFrame / LazyColumn) over in-memory
partitioned sources; string data is dictionary-encoded on ingest (paper
§3.6), datetime64 data becomes int64 epoch seconds (the engine's device
representation)."""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core import graph as G
from repro_torch.core.lazyframe import LazyColumn, LazyFrame
from repro_torch.core.physical.table import to_host_array
from repro_torch.core.source import InMemorySource, encode_strings

from .fallback import record_fallback
from .io import _parse_datetimes


def _ingest_column(values) -> tuple[np.ndarray, list | None, bool]:
    """array-like → (array, vocab | None, is_datetime)."""
    arr = np.asarray(values)
    if arr.dtype.kind == "M":                         # datetime64
        return arr.astype("datetime64[s]").astype(np.int64), None, True
    if arr.dtype.kind in "OUS":
        vals = [str(v) for v in arr.ravel()]
        if vals and all(len(v) >= 10 and v[4:5] == "-" and v[7:8] == "-"
                        for v in vals):
            try:
                return _parse_datetimes(vals), None, True
            except ValueError:
                pass          # ISO-*looking* strings, not actual datetimes
        codes, vocab = encode_strings(vals)
        return codes, vocab, False
    return arr, None, False


def _ingest(data: Mapping[str, Any], name: str = "dataframe",
            partition_rows: int = 1 << 16) -> LazyFrame:
    arrays, dicts, datetimes = {}, {}, []
    for col, values in data.items():
        arr, vocab, is_dt = _ingest_column(values)
        arrays[col] = arr
        if vocab is not None:
            dicts[col] = vocab
        if is_dt:
            datetimes.append(col)
    src = InMemorySource(arrays, partition_rows, dicts, datetimes, name)
    return LazyFrame(G.Scan(src), source_vocab=src.dicts)


def DataFrame(data=None, columns: Sequence[str] | None = None,
              index=None) -> LazyFrame:  # noqa: N802 — pandas name
    """``pd.DataFrame(...)`` — accepts a dict of columns, a list of row
    dicts, a 2-D array (+ ``columns``), or an existing LazyFrame (copy).
    ``index`` is accepted for signature compatibility and ignored (the
    engine is positional, like the paper's)."""
    if isinstance(data, LazyFrame):
        return data.copy()
    if isinstance(data, Mapping):
        if not data:
            raise ValueError("repro_torch.pandas.DataFrame needs at least one column")
        return _ingest(data)
    if isinstance(data, np.ndarray) and data.ndim == 2:
        names = list(columns) if columns is not None else \
            [f"c{i}" for i in range(data.shape[1])]
        return _ingest({n: data[:, i] for i, n in enumerate(names)})
    if isinstance(data, (list, tuple)) and data and isinstance(data[0], Mapping):
        names = list(columns) if columns is not None else list(data[0])
        return _ingest({n: [row.get(n) for row in data] for n in names})
    raise TypeError(f"cannot construct DataFrame from {type(data)}")


def Series(data, name: str | None = None) -> LazyColumn:  # noqa: N802
    """``pd.Series(...)`` — a single named lazy column (backed by a
    one-column in-memory frame)."""
    if isinstance(data, LazyColumn):
        return data
    name = name if name is not None else "value"
    return _ingest({name: data}, name=f"series:{name}")[name]


def concat(objs: Sequence[LazyFrame], axis: int = 0,
           ignore_index: bool = True) -> LazyFrame:
    """Row-wise concat.  Stays lazy (a Concat node) when the frames'
    dictionary vocabularies agree; mismatched vocabs force the measured
    fallback path: materialize, decode, re-encode, re-wrap."""
    objs = list(objs)
    if axis != 0:
        raise NotImplementedError("concat(axis=1) is not supported")
    if not objs:
        raise ValueError("No objects to concatenate")
    if len(objs) == 1:
        return objs[0].copy()
    vocab: dict[str, list] = {}
    compatible = True
    for f in objs:
        for k, v in f._vocab.items():
            if k in vocab and vocab[k] != v:
                compatible = False
            vocab.setdefault(k, v)
    if compatible:
        return LazyFrame(G.Concat([f._node for f in objs]), source_vocab=vocab)
    # fallback: re-encode against a merged vocabulary.  Column set is the
    # union (pandas outer concat): numeric gaps NaN-fill; string gaps get ""
    # (dict-encoded columns can't carry NaN).
    mats = [f.compute(force_reason="fallback:concat") for f in objs]
    rows = sum(m.rows() for m in mats)
    record_fallback("concat", (rows, len(mats[0].columns)),
                    "vocab-mismatch-reencode")
    names: list[str] = []
    for m in mats:
        for n in m.columns:
            if n not in names:
                names.append(n)
    merged: dict[str, Any] = {}
    for n in names:
        is_str = any(n in m.vocab for m in mats)
        missing = any(n not in m.columns for m in mats)
        parts = []
        for m in mats:
            if n not in m.columns:
                parts.append([""] * m.rows() if is_str
                             else np.full(m.rows(), np.nan))
            elif n in m.vocab:
                parts.append([m.vocab[n][c] for c in to_host_array(m.columns[n])])
            else:
                arr = to_host_array(m.columns[n])
                parts.append(arr.astype(np.float64) if missing else arr)
        if is_str:
            merged[n] = np.concatenate([np.asarray(p, dtype=object)
                                        for p in parts])
        else:
            merged[n] = np.concatenate(parts)
    return _ingest(merged, name="concat")


def merge(left: LazyFrame, right: LazyFrame, on, how: str = "inner",
          suffixes=("_x", "_y")) -> LazyFrame:
    return left.merge(right, on=on, how=how, suffixes=suffixes)


def to_datetime(arg, format: str | None = None):  # noqa: A002
    """Convert to the engine's datetime representation (int64 epoch
    seconds).  Lazy columns: int columns pass through; dict-encoded string
    columns are parsed once on the vocabulary and mapped per row via a
    lazy lookup-table UDF."""
    if isinstance(arg, LazyColumn):
        try:
            vocab = arg.frame._vocab_for(arg.expr)
        except KeyError:
            return arg                     # already numeric epoch seconds
        lut = _parse_datetimes(vocab)
        record_fallback("to_datetime", (len(vocab),), "vocab-parse-lut")
        fn = lambda codes: lut[np.asarray(codes)]  # noqa: E731
        return LazyColumn(arg.frame,
                          E.UDF(fn, (arg.expr,), name="to_datetime"))
    if isinstance(arg, str):
        return int(_parse_datetimes([arg])[0])
    return Series(_parse_datetimes([str(v) for v in np.asarray(arg).ravel()]),
                  name="datetime")


def isna(obj):
    """``pd.isna`` — lazy elementwise NaN test for columns, eager for
    arrays/scalars."""
    if isinstance(obj, LazyColumn):
        return obj.isna()
    arr = np.asarray(obj)
    if arr.ndim == 0:
        return bool(np.isnan(arr)) if arr.dtype.kind == "f" else obj is None
    if arr.dtype.kind == "f":
        return np.isnan(arr)
    return np.zeros(arr.shape, bool)


def notna(obj):
    res = isna(obj)
    if isinstance(res, LazyColumn):
        return ~res
    return ~np.asarray(res) if isinstance(res, np.ndarray) else not res
