"""Chunked columnar Parquet source (pyarrow-backed).

``ParquetSource`` serves a single ``.parquet`` file or a directory of
``part-*.parquet`` files as engine partitions — one partition per row
group — with the engine's column conventions applied at decode time:
string columns dictionary-encoded to int32 codes against a global vocab,
timestamp columns lowered to int64 epoch seconds.  Projection happens at
the pyarrow layer (only requested columns are read), so bytes-read scales
with the pushed-down column set.

Statistics never require a second scan: the first open builds per-row-group
zone maps from the parquet footer (numeric columns) plus one vocab pass for
string columns, then persists everything in the JSON sidecar
(``repro_torch.io.sidecar``); subsequent opens are metadata-only.

``write_parquet_source`` is the ingest path: engine arrays (codes + vocab,
epoch-second datetimes) become plain interoperable parquet (real strings,
real timestamps) plus a sidecar, one file per partition.

pyarrow is optional: ``HAS_PYARROW`` gates the source, and the NPZ
directory layout (``repro_torch.core.source.NpzDirectorySource``) is the
no-pyarrow fallback with the same sidecar/pushdown contract.

Null policy: parquet nulls are unsupported — the engine's host arrays are
dense (float NaN round-trips as a real NaN value, not a parquet null), so
externally-written files containing nulls are rejected with a clear
``ValueError`` at stats build and again at partition decode, never a
``KeyError`` deep in code mapping.
"""
from __future__ import annotations

import datetime
import glob
import os
from typing import Mapping, Sequence

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.parquet as pq
    HAS_PYARROW = True
except Exception:  # noqa: BLE001 — pyarrow genuinely optional
    pa = pq = None
    HAS_PYARROW = False

from repro_torch.core.schema import ColumnSchema, TableSchema
from repro_torch.core.source import Source, _zonemap

from . import sidecar as SC


def _require_pyarrow():
    if not HAS_PYARROW:
        raise ImportError(
            "pyarrow is required for Parquet sources; install it or use "
            "the NPZ directory layout (write_npz_source/read_npz)")


def _stats_epoch(v) -> int:
    """Epoch seconds of a row-group min/max timestamp statistic.  pyarrow
    decodes footer stats to *naive* ``datetime`` objects that represent
    UTC instants; a naive ``.timestamp()`` would re-interpret them in the
    machine's local zone and shift the zone map by the UTC offset —
    silently wrong pruning on any non-UTC host."""
    if isinstance(v, (int, float)):
        return int(v)
    if v.tzinfo is None:
        v = v.replace(tzinfo=datetime.timezone.utc)
    return int(v.timestamp())


def _null_error(column: str, where: str) -> ValueError:
    return ValueError(
        f"ParquetSource does not support null values (column {column!r} "
        f"in {where}); drop or fill nulls before ingest")


def parquet_files(path: str) -> list[str]:
    """Data files for a parquet source path (single file or directory)."""
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "*.parquet")))
    return [path]


class ParquetSource(Source):
    """Partitioned parquet reader with sidecar-backed metadata.

    Partitions are row groups in file order.  ``load_partition`` reads only
    the requested columns of one row group and decodes them to the engine's
    host-array conventions."""

    supports_pushdown = True
    prefetchable = True

    def __init__(self, path: str):
        _require_pyarrow()
        self.path = path
        files = parquet_files(path)
        if not files:
            raise FileNotFoundError(f"no .parquet files under {path!r}")
        self._files = files
        self._handles: dict[int, "pq.ParquetFile"] = {}
        self.name = os.path.basename(path.rstrip("/"))
        payload = SC.read_sidecar(path, data_files=files)
        if payload is None:
            payload = self._build_stats(files)
            SC.write_sidecar(path, payload["partitions"],
                             columns=payload["columns"],
                             dicts=payload["dicts"],
                             datetimes=payload["datetimes"],
                             data_files=files)
        self._parts = payload["partitions"]   # {"file","row_group","rows","zonemap"}
        self.dicts = {k: list(v) for k, v in payload["dicts"].items()}
        self._datetimes = tuple(payload["datetimes"])
        self.schema = TableSchema(tuple(
            ColumnSchema(n, c["dtype"], is_dict=c.get("is_dict", False),
                         dict_size=len(self.dicts.get(n, [])) or None,
                         is_datetime=c.get("is_datetime", False))
            for n, c in payload["columns"].items()))
        self._code_maps: dict[str, dict] = {}
        self._fingerprint = SC.fingerprint(payload)

    # -- identity -----------------------------------------------------------
    def cache_token(self):
        """Path-stable token covering source file identity: the sidecar's
        content digest (which records every data file's size+mtime) plus
        the sidecar file's own mtime — a rewritten directory or sidecar
        yields a fresh token, so plan-key consumers never reuse
        data-derived state across file changes."""
        return ("parquet", os.path.abspath(self.path), self._fingerprint,
                SC.sidecar_mtime_ns(self.path))

    # -- stats build (first open only) --------------------------------------
    def _build_stats(self, files: list[str]) -> dict:
        """One metadata pass over footers + one data pass over string
        columns (vocab build).  Numeric zone maps come from row-group
        statistics; string-column zone maps are code ranges against the
        global vocab; timestamp zone maps are epoch-second ranges."""
        columns: dict[str, dict] = {}
        dicts: dict[str, list[str]] = {}
        datetimes: list[str] = []
        first = pq.ParquetFile(files[0])
        str_cols: list[str] = []
        for field in first.schema_arrow:
            name = field.name
            t = field.type
            if pa.types.is_string(t) or pa.types.is_large_string(t) \
                    or pa.types.is_dictionary(t):
                columns[name] = {"dtype": "dict", "is_dict": True,
                                 "is_datetime": False}
                str_cols.append(name)
            elif pa.types.is_timestamp(t):
                columns[name] = {"dtype": "datetime64[s]", "is_dict": False,
                                 "is_datetime": True}
                datetimes.append(name)
            elif pa.types.is_boolean(t):
                columns[name] = {"dtype": "bool", "is_dict": False,
                                 "is_datetime": False}
            else:
                columns[name] = {"dtype": str(t.to_pandas_dtype().__name__
                                              if hasattr(t, "to_pandas_dtype")
                                              else t),
                                 "is_dict": False, "is_datetime": False}
        # global vocab per string column: one pass over just those columns
        if str_cols:
            vocab_sets: dict[str, set] = {c: set() for c in str_cols}
            for f in files:
                t = pq.ParquetFile(f).read(columns=str_cols)
                for c in str_cols:
                    col = t.column(c)
                    if col.null_count:
                        raise _null_error(c, f)
                    if pa.types.is_dictionary(col.type):
                        col = col.cast(pa.string())
                    vocab_sets[c].update(
                        v for v in col.to_pylist() if v is not None)
            for c in str_cols:
                dicts[c] = sorted(str(v) for v in vocab_sets[c])
        code_maps = {c: {v: i for i, v in enumerate(dicts[c])}
                     for c in str_cols}
        partitions: list[dict] = []
        for fi, f in enumerate(files):
            pf = pq.ParquetFile(f)
            md = pf.metadata
            names = [md.schema.column(ci).name
                     for ci in range(len(md.schema))]
            for rg in range(md.num_row_groups):
                rgm = md.row_group(rg)
                zm: dict[str, tuple] = {}
                for ci, name in enumerate(names):
                    if name not in columns:
                        continue
                    spec = columns[name]
                    stats = rgm.column(ci).statistics
                    if stats is not None and stats.has_null_count \
                            and stats.null_count:
                        raise _null_error(name, f)
                    if spec["is_dict"]:
                        if stats is not None and stats.has_min_max:
                            cmap = code_maps.get(name, {})
                            lo = cmap.get(str(stats.min))
                            hi = cmap.get(str(stats.max))
                            if lo is not None and hi is not None:
                                zm[name] = (lo, hi)
                        continue
                    if stats is None or not stats.has_min_max:
                        continue
                    lo, hi = stats.min, stats.max
                    if spec["is_datetime"]:
                        try:
                            lo = _stats_epoch(lo)
                            hi = _stats_epoch(hi)
                        except (AttributeError, OSError, OverflowError):
                            continue
                    if isinstance(lo, (int, float)) \
                            and isinstance(hi, (int, float)) \
                            and not isinstance(lo, bool):
                        zm[name] = (lo, hi)
                partitions.append({"file": os.path.basename(f),
                                   "row_group": rg,
                                   "rows": rgm.num_rows,
                                   "zonemap": zm})
        return {"version": SC.SIDECAR_VERSION, "partitions": partitions,
                "columns": columns, "dicts": dicts, "datetimes": datetimes}

    # -- Source protocol ----------------------------------------------------
    @property
    def n_partitions(self) -> int:
        return len(self._parts)

    def partition_meta(self, i: int) -> dict:
        p = self._parts[i]
        return {"rows": p["rows"],
                "zonemap": {k: tuple(v) for k, v in
                            p.get("zonemap", {}).items()}}

    def _handle(self, fname: str) -> "pq.ParquetFile":
        fi = next((i for i, f in enumerate(self._files)
                   if os.path.basename(f) == fname), None)
        if fi is None:
            raise FileNotFoundError(
                f"data file {fname!r} referenced by partition metadata is "
                f"missing from {self.path!r} (directory changed after open?)")
        h = self._handles.get(fi)
        if h is None:
            h = self._handles[fi] = pq.ParquetFile(self._files[fi])
        return h

    def _codes(self, name: str, col: "pa.ChunkedArray") -> np.ndarray:
        if pa.types.is_dictionary(col.type):
            col = col.cast(pa.string())
        cmap = self._code_maps.get(name)
        if cmap is None:
            cmap = self._code_maps[name] = {
                v: i for i, v in enumerate(self.dicts[name])}
        values = col.to_pylist()
        return np.fromiter((cmap[v] for v in values), dtype=np.int32,
                           count=len(values))

    def load_partition(self, i: int, columns: Sequence[str] | None = None
                       ) -> dict[str, np.ndarray]:
        p = self._parts[i]
        pf = self._handle(p["file"])
        names = list(columns) if columns is not None else None
        table = pf.read_row_group(p["row_group"], columns=names)
        out: dict[str, np.ndarray] = {}
        for name in (names if names is not None else table.column_names):
            col = table.column(name).combine_chunks()
            if col.null_count:
                raise _null_error(name, p["file"])
            cs = self.schema.col(name)
            if cs.is_dict:
                out[name] = self._codes(name, col)
            elif cs.is_datetime:
                out[name] = np.asarray(
                    col.cast(pa.timestamp("s")).cast(pa.int64()),
                    dtype=np.int64)
            else:
                out[name] = col.to_numpy(zero_copy_only=False)
        return out


def write_parquet_source(path: str, arrays: Mapping[str, np.ndarray],
                         partition_rows: int = 1 << 18,
                         dicts: Mapping[str, Sequence[str]] | None = None,
                         datetimes: Sequence[str] = (),
                         ingest: Mapping[str, object] | None = None
                         ) -> ParquetSource:
    """Ingest engine arrays as a parquet directory source + sidecar.

    Dict-encoded columns (``dicts``) are written as real strings,
    epoch-second datetime columns as ``timestamp[s]`` — the files are plain
    parquet any reader understands.  The sidecar is written from the
    in-memory arrays, so the resulting source never rescans its own data.
    ``ingest`` records upstream file states (e.g. a CSV cache's origin)."""
    _require_pyarrow()
    os.makedirs(path, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    dicts = {k: list(v) for k, v in (dicts or {}).items()}
    rows = len(next(iter(arrays.values())))
    columns: dict[str, dict] = {}
    for name, arr in arrays.items():
        columns[name] = {"dtype": ("dict" if name in dicts else
                                   "datetime64[s]" if name in datetimes else
                                   str(arr.dtype)),
                         "is_dict": name in dicts,
                         "is_datetime": name in datetimes}
    parts: list[dict] = []
    files: list[str] = []
    for pi, lo in enumerate(range(0, max(rows, 1), partition_rows)):
        hi = min(lo + partition_rows, rows)
        part = {k: a[lo:hi] for k, a in arrays.items()}
        cols = {}
        for name, arr in part.items():
            if name in dicts:
                vocab = np.asarray(dicts[name], dtype=object)
                cols[name] = pa.array(vocab[arr], type=pa.string())
            elif name in datetimes:
                cols[name] = pa.array(arr.astype(np.int64)).cast(
                    pa.timestamp("s"))
            else:
                cols[name] = pa.array(arr)
        fname = f"part-{pi:05d}.parquet"
        fpath = os.path.join(path, fname)
        pq.write_table(pa.table(cols), fpath)
        files.append(fpath)
        parts.append({"file": fname, "row_group": 0, "rows": hi - lo,
                      "zonemap": _zonemap(part)})
    SC.write_sidecar(path, parts, columns=columns, dicts=dicts,
                     datetimes=datetimes, data_files=files, ingest=ingest)
    return ParquetSource(path)
