"""Metadata store (paper §3.6): per-source types + statistics.

Stats are computed once (a "background task" in the paper; here an explicit
``compute_metadata`` call or on first use), keyed by source identity and
modification time, and feed three optimizations: dtype narrowing, category
(dictionary) candidates, and backend choice by estimated in-memory size.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping

import numpy as np

from .source import Source


@dataclasses.dataclass
class ColumnStats:
    dtype: str
    min: float | None = None
    max: float | None = None
    distinct_est: int | None = None
    null_frac: float = 0.0

    def narrowable(self) -> str | None:
        from .schema import narrow_int_dtype
        if self.min is None or not np.dtype(self.dtype).kind == "i":
            return None
        t = narrow_int_dtype(int(self.min), int(self.max))
        return str(t) if t.itemsize < np.dtype(self.dtype).itemsize else None

    def category_candidate(self, rows: int, threshold: float = 0.01) -> bool:
        """Few distinct values → dictionary/category encode (paper §3.6)."""
        return (self.distinct_est is not None and rows > 0
                and self.distinct_est <= max(64, threshold * rows))


@dataclasses.dataclass
class SourceMetadata:
    rows: int
    row_bytes: int
    columns: dict[str, ColumnStats]
    computed_at: float = dataclasses.field(default_factory=time.time)
    mtime: float | None = None

    def estimated_bytes(self) -> int:
        return self.rows * self.row_bytes

    def fits_in(self, budget_bytes: int) -> bool:
        return self.estimated_bytes() <= budget_bytes


_STORE: dict[int, SourceMetadata] = {}


def compute_metadata(source: Source, sample_partitions: int | None = None
                     ) -> SourceMetadata:
    """Scan (a sample of) partitions for stats.  Types come from the schema;
    min/max/distinct come from data (paper: 'statistics can be computed from
    a sample')."""
    n = source.n_partitions
    take = range(n) if sample_partitions is None else range(
        min(n, sample_partitions))
    stats: dict[str, ColumnStats] = {}
    rows = 0
    sampled_rows = 0
    for pi in take:
        part = source.load_partition(pi)
        pr = len(next(iter(part.values()))) if part else 0
        sampled_rows += pr
        for cname, arr in part.items():
            cs = stats.get(cname)
            if cs is None:
                cs = stats[cname] = ColumnStats(dtype=str(arr.dtype))
            if arr.dtype.kind in "ifu" and arr.size:
                amin, amax = float(arr.min()), float(arr.max())
                cs.min = amin if cs.min is None else min(cs.min, amin)
                cs.max = amax if cs.max is None else max(cs.max, amax)
                if arr.dtype.kind == "f":
                    cs.null_frac = float(np.isnan(arr).mean())
            uniq = np.unique(arr[: 65536])
            cs.distinct_est = max(cs.distinct_est or 0, int(uniq.shape[0]))
    # total rows from partition meta when sampled
    total = source.total_rows()
    rows = total if total is not None else sampled_rows
    row_bytes = source.schema.row_bytes()
    mtime = None
    path = getattr(source, "path", None)
    if path and os.path.exists(path):
        mtime = os.path.getmtime(path)
    md = SourceMetadata(rows=rows, row_bytes=row_bytes, columns=stats,
                        mtime=mtime)
    _STORE[id(source)] = md
    return md


def get_metadata(source: Source) -> SourceMetadata | None:
    md = _STORE.get(id(source))
    if md is None:
        return None
    path = getattr(source, "path", None)
    if path and md.mtime is not None and os.path.exists(path):
        if os.path.getmtime(path) > md.mtime:   # stale (paper's mtime check)
            del _STORE[id(source)]
            return None
    return md


def choose_backend(source: Source, available_bytes: int) -> str:
    """Cost-based backend choice sketch (paper future work, implemented):
    a whole-table ("resident"/"sharded" peak model) engine when the table
    fits comfortably, the first out-of-core ("chunked") engine otherwise.
    Candidates come from the engine registry — an out-of-tree engine with a
    chunked peak model is eligible without edits here.  Returns the engine
    *name*."""
    from .engines import default_registry
    md = get_metadata(source) or compute_metadata(source, sample_partitions=1)
    reg = default_registry()
    names = reg.names()
    resident = [n for n in names
                if reg.capability_of(n).peak_model != "chunked"]
    chunked = [n for n in names
               if reg.capability_of(n).peak_model == "chunked"]
    if md.estimated_bytes() * 2 <= available_bytes and resident:
        # the paper's sketch wants the local in-memory engine, not a
        # cluster dispatch: startup cost is the registry-generic proxy
        return min(resident,
                   key=lambda n: reg.capability_of(n).startup_cost)
    return chunked[0] if chunked else names[0]


def dtype_overrides_for(source: Source,
                        readonly_cols: set[str] | None) -> Mapping[str, str]:
    md = get_metadata(source)
    if md is None:
        return {}
    out = {}
    for cname, cs in md.columns.items():
        if readonly_cols is not None and cname not in readonly_cols:
            continue
        t = cs.narrowable()
        if t:
            out[cname] = t
    return out
