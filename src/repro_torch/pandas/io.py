"""Facade I/O: ``pd.read_csv`` / ``read_npz`` / ``read_source`` /
``from_arrays``.

``read_csv`` is a minimal-but-robust CSV reader: numeric columns inferred
(int64, falling back to float64-with-NaN when cells are blank), strings
dictionary-encoded, ISO datetimes → int64 epoch seconds.  ``usecols`` comes
from the user or from JIT static analysis (paper Fig. 4)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.context import get_context
from repro_torch.core.lazyframe import LazyFrame, read_source as _read_source
from repro_torch.core.source import InMemorySource, encode_strings
from repro_torch.core.jit_analyze import usecols_hint

# Tokens treated as missing values during inference (case-insensitive).
_NA_TOKENS = frozenset({"", "na", "n/a", "nan", "null", "none"})

# Sentinel epoch for unparseable/blank datetime cells (NaT analogue — int
# columns can't carry NaN).  int32-min, the value the JAX package uses, so
# both packages read the same files into the same columns.
NAT_SENTINEL = int(np.iinfo(np.int32).min)


def _is_na(v: str) -> bool:
    return v.strip().lower() in _NA_TOKENS


def _apply_usecols(source, cols):
    """Record static usecols for this source (column selection, §3.1)."""
    ctx = get_context()
    if cols is not None and ctx.analysis:
        ctx.analysis.setdefault("scan_extra_cols", {})[id(source)] = list(cols)
    return source


def _frame_over(source, cols):
    """Lazy frame over ``source``, projected to ``cols`` when given."""
    frame = _read_source(_apply_usecols(source, cols))
    if cols is not None:
        valid = [c for c in cols if c in source.schema]
        if valid:
            frame = LazyFrame(G.Scan(source, tuple(valid)),
                              source_vocab=source.dicts)
    return frame


def read_source(source):
    return _frame_over(source, usecols_hint())


def read_npz(path: str):
    from repro_torch.core.source import NpzDirectorySource
    return read_source(NpzDirectorySource(path))


def read_parquet(path: str, columns=None):
    """Lazy frame over a parquet file or ``part-*.parquet`` directory
    (``repro_torch.io.ParquetSource``): scans are column-pruned and
    predicate-pushed, partitions pruned via the sidecar zone maps.
    Requires pyarrow."""
    from repro_torch.io import ParquetSource
    src = ParquetSource(path)
    cols = columns if columns is not None else usecols_hint()
    return _frame_over(src, cols)


def from_arrays(arrays, partition_rows: int = 1 << 16, dicts=None,
                datetimes=(), name="mem"):
    src = InMemorySource(arrays, partition_rows, dicts, datetimes, name)
    return read_source(src)


def _coerce_numeric(vals) -> np.ndarray | None:
    """int64 when every cell parses as int; float64-with-NaN when cells are
    blank/NA or fractional; None when the column isn't numeric at all."""
    clean = [v for v in vals if not _is_na(v)]
    if not clean:
        return None                        # all-blank: not numeric evidence
    if len(clean) == len(vals):
        try:
            return np.asarray(vals, dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.asarray([np.nan if _is_na(v) else float(v) for v in vals],
                          dtype=np.float64)
    except (ValueError, OverflowError):
        return None


def _looks_datetime(vals) -> bool:
    """Probe the first *non-blank* value for an ISO date shape."""
    probe = next((v for v in vals if not _is_na(v)), "")
    return len(probe) >= 10 and probe[4:5] == "-" and probe[7:8] == "-"


def _parse_datetimes(vals) -> np.ndarray:
    import datetime as _dt
    out = np.empty(len(vals), np.int64)
    for i, v in enumerate(vals):
        if _is_na(v):
            out[i] = NAT_SENTINEL
            continue
        v = v.strip().replace("T", " ")
        fmt = "%Y-%m-%d %H:%M:%S" if len(v) > 10 else "%Y-%m-%d"
        out[i] = int(_dt.datetime.strptime(v, fmt)
                     .replace(tzinfo=_dt.timezone.utc).timestamp())
    return out


def _parse_csv(path: str, hint, dtype, parse_dates):
    """CSV → (arrays, dicts, datetimes) under the inference rules above."""
    import csv as _csv

    with open(path, newline="") as f:
        reader = _csv.reader(f)
        header = next(reader)
        keep = [i for i, h in enumerate(header)
                if hint is None or h in hint]
        names = [header[i] for i in keep]
        cols: dict[str, list] = {n: [] for n in names}
        for row in reader:
            if not row:
                continue                    # skip blank lines (pandas default)
            for i, n in zip(keep, names):
                cols[n].append(row[i] if i < len(row) else "")
    arrays: dict[str, np.ndarray] = {}
    dicts: dict[str, list] = {}
    datetimes: list[str] = list(parse_dates)
    for n, vals in cols.items():
        if n in datetimes:
            arrays[n] = _parse_datetimes(vals)
            continue
        arr = _coerce_numeric(vals)
        if arr is None:
            if _looks_datetime(vals):
                arrays[n] = _parse_datetimes(vals)
                datetimes.append(n)
                continue
            codes, vocab = encode_strings(vals)
            arrays[n] = codes
            dicts[n] = vocab
            continue
        if dtype and n in dtype:
            arr = arr.astype(dtype[n])
        arrays[n] = arr
    return arrays, dicts, datetimes


def _csv_cache_params(dtype, parse_dates) -> dict:
    """Normalized parse options, part of the parquet cache's identity: the
    cache pins the schema produced by ``(dtype, parse_dates)``, so a later
    call with different options must read as stale, not silently serve the
    first call's schema."""
    return {"dtype": {str(k): np.dtype(v).str
                      for k, v in sorted((dtype or {}).items())},
            "parse_dates": sorted(str(c) for c in parse_dates)}


def _fresh_parquet_cache(cache_path: str, csv_path: str, params: dict):
    """Reopen a ``to_parquet_cache`` directory when its sidecar records the
    CSV's current ``(size, mtime_ns)`` AND the same parse params — else
    ``None`` (rebuild)."""
    import os

    from repro_torch.io import HAS_PYARROW
    if not HAS_PYARROW or not os.path.isdir(cache_path):
        return None
    from repro_torch.io import ParquetSource, parquet_files
    from repro_torch.io import sidecar as SC
    files = parquet_files(cache_path)
    if not files:
        return None
    payload = SC.read_sidecar(cache_path, data_files=files)
    if not payload:
        return None
    ingest = payload.get("ingest") or {}
    try:
        state = SC.file_state(csv_path)
    except OSError:
        return None
    if list(ingest.get(os.path.abspath(csv_path), ())) != state:
        return None
    if ingest.get("__params__") != params:
        return None
    return ParquetSource(cache_path)


def read_csv(path: str, usecols=None, dtype=None, parse_dates=(),
             to_parquet_cache: str | None = None):
    hint = usecols if usecols is not None else usecols_hint()
    if to_parquet_cache is not None:
        # opt-in columnar cache: parse once (ALL columns, so later reads
        # with different projections reuse the same cache), serve every
        # fresh re-open from parquet + sidecar without touching the CSV
        import os

        params = _csv_cache_params(dtype, parse_dates)
        src = _fresh_parquet_cache(to_parquet_cache, path, params)
        if src is None:
            from repro_torch.io import sidecar as SC
            from repro_torch.io.parquet import write_parquet_source
            arrays, dicts, datetimes = _parse_csv(path, None, dtype,
                                                  parse_dates)
            src = write_parquet_source(
                to_parquet_cache, arrays, dicts=dicts, datetimes=datetimes,
                ingest={os.path.abspath(path): SC.file_state(path),
                        "__params__": params})
        return _frame_over(src, hint)
    arrays, dicts, datetimes = _parse_csv(path, hint, dtype, parse_dates)
    src = InMemorySource(arrays, dicts=dicts, datetimes=datetimes,
                         name=path)
    return _read_source(_apply_usecols(src, hint))
