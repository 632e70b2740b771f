"""Shared pushdown-aware Scan execution for every backend.

One loader implements the ``Scan.pushdown`` contract — read only the
columns the plan needs (output projection ∪ predicate columns), apply the
pushed-down predicate per partition right after decode, then project away
predicate-only columns — so eager, streaming, and distributed stay
bit-identical by construction.  ``iter_scan_partitions`` adds the async
prefetch pipeline on top for sources that advertise ``prefetchable``.

Accounting (``io.*`` counters on the session metrics registry, ``io``
spans on the session tracer) happens here, at the single point where
bytes actually leave the source:

* ``io.partitions_loaded`` / ``io.bytes_read`` — partitions decoded and
  their decoded column bytes (pruned partitions never count — they are
  never requested).
* ``io.partitions_pruned`` — partitions skipped via ``skip_partitions``.
* ``io.partitions_prefetched`` — partitions decoded ahead of the consumer
  by the background prefetch thread.
* ``io.pushdown_rows_in`` / ``io.pushdown_rows_out`` — row counts around
  the pushed-down predicate.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core import graph as G
from repro_torch.obs.spans import io_span

from .prefetch import prefetch_iter


def pushdown_read_cols(n: "G.Scan") -> list[str] | None:
    """Columns to request from the source: the scan's output projection
    plus any predicate-only columns the pushed-down conjuncts need
    (``None`` = all columns, mirroring ``Scan.columns``)."""
    if n.columns is None:
        return None
    cols = list(n.columns)
    if n.pushdown is not None:
        names = set(n.source.schema.names)
        have = set(cols)
        cols += [c for c in sorted(n.pushdown.used_cols())
                 if c in names and c not in have]
    return cols


def scan_partition_indices(n: "G.Scan") -> list[int]:
    """Partition indices the scan will actually read (prune set removed)."""
    return [i for i in range(n.source.n_partitions)
            if i not in n.skip_partitions]


def empty_scan_table(n: "G.Scan") -> dict[str, np.ndarray]:
    """0-row table with the scan's output schema (all partitions pruned,
    or every row filtered by the pushed-down predicate)."""
    cols = n.columns if n.columns is not None else n.source.schema.names
    out = {}
    for c in cols:
        dt = n.dtype_overrides.get(c, n.source.schema.col(c).np_dtype)
        out[c] = np.zeros(0, dt)
    return out


def load_scan_partition(n: "G.Scan", pi: int, metrics=None, tracer=None,
                        apply_pushdown: bool = True) -> dict[str, np.ndarray]:
    """Load one partition of a scan: read the pushed-down column set,
    apply dtype overrides, evaluate the pushed-down predicate (host
    numpy — same arrays and semantics the Filter operator would see, so
    pushdown on/off is bit-identical), and project to the output columns.

    ``apply_pushdown=False`` stops after the dtype overrides: the caller
    gets the whole read column set and evaluates ``n.pushdown`` itself
    (the eager engine does so on the device, see ``device_pushdown``)."""
    read_cols = pushdown_read_cols(n)
    with io_span("load_partition", tracer=tracer, source=n.source.name,
                 partition=pi) as sp:
        part = n.source.load_partition(pi, read_cols)
        part = {k: np.asarray(v) for k, v in part.items()}
        nbytes = sum(int(a.nbytes) for a in part.values())
        for c, dt in n.dtype_overrides.items():
            if c in part:
                part[c] = part[c].astype(dt)
        if metrics is not None:
            metrics.inc("io.partitions_loaded")
            metrics.inc("io.bytes_read", nbytes)
        rows_in = len(next(iter(part.values()))) if part else 0
        if not apply_pushdown:
            sp.set(bytes=nbytes, rows_in=rows_in, rows_out=rows_in)
            return part
        if n.pushdown is not None:
            mask = np.asarray(n.pushdown.predicate.evaluate(part))
            if mask.ndim == 0:            # constant predicate (e.g. Lit)
                part = part if bool(mask) else {k: v[:0]
                                                for k, v in part.items()}
            else:
                part = {k: v[mask] for k, v in part.items()}
            rows_out = len(next(iter(part.values()))) if part else 0
            if metrics is not None:
                metrics.inc("io.pushdown_rows_in", rows_in)
                metrics.inc("io.pushdown_rows_out", rows_out)
        else:
            rows_out = rows_in
        if n.columns is not None:
            part = {c: part[c] for c in n.columns}
        sp.set(bytes=nbytes, rows_in=rows_in, rows_out=rows_out)
    return part


def device_pushdown(n: "G.Scan", table: dict, metrics=None,
                    impl: str | None = None) -> dict:
    """Finish a scan whose partitions were loaded with
    ``apply_pushdown=False`` and moved onto the device: evaluate the
    pushed-down predicate on the whole table and compact the output
    columns under it in one ``filter_compact`` launch, then project."""
    out_cols = list(n.columns) if n.columns is not None else list(table)
    if n.pushdown is None:
        return {c: table[c] for c in out_cols}
    from repro_torch.core.physical.rowwise import compact_rows
    rows_in = len(next(iter(table.values()))) if table else 0
    mask = n.pushdown.predicate.evaluate(table)
    out = compact_rows({c: table[c] for c in out_cols}, mask, impl)
    if metrics is not None:
        metrics.inc("io.pushdown_rows_in", rows_in)
        metrics.inc("io.pushdown_rows_out",
                    len(next(iter(out.values()))) if out else 0)
    return out


def iter_scan_partitions(n: "G.Scan", ctx=None
                         ) -> Iterator[dict[str, np.ndarray]]:
    """Stream a scan's unpruned partitions in order, prefetching ahead on
    a background thread when the source supports it.

    Always yields at least one (possibly 0-row) table so downstream
    operators keep the schema.  The prefetch depth comes from the session
    knob ``io_prefetch`` (default 2; 0 disables); metrics/spans go to the
    given context's registry/tracer so background-thread loads attribute
    to the right session."""
    if ctx is None:
        from repro_torch.core.context import get_context
        ctx = get_context()
    metrics = getattr(ctx, "metrics", None)
    tracer = getattr(ctx, "tracer", None)
    indices = scan_partition_indices(n)
    if metrics is not None and n.skip_partitions:
        metrics.inc("io.partitions_pruned", len(n.skip_partitions))
    if not indices:
        yield empty_scan_table(n)
        return
    depth = 0
    if getattr(n.source, "prefetchable", False):
        opts = getattr(ctx, "backend_options", {}) or {}
        depth = int(opts.get("io_prefetch", 2))

    def load(pi: int) -> dict[str, np.ndarray]:
        return load_scan_partition(n, pi, metrics=metrics, tracer=tracer)

    def on_prefetch(pi: int) -> None:
        if metrics is not None:
            metrics.inc("io.partitions_prefetched")

    yield from prefetch_iter(indices, load, depth=depth,
                             on_prefetch=on_prefetch)
