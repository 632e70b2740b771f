"""Columnar on-disk IO subsystem.

The engine's scan boundary: chunked columnar sources (Parquet via
pyarrow, the NPZ directory layout as the no-pyarrow fallback) that serve
column-pruned, predicate-filtered partitions; JSON zone-map/row-count
sidecars so reopening a source never rescans data; a bounded async
prefetcher overlapping partition decode with compute; and the shared
pushdown-aware scan loader all three backends execute through.
"""
from __future__ import annotations

import os

from .parquet import (HAS_PYARROW, ParquetSource, parquet_files,
                      write_parquet_source)
from .prefetch import prefetch_iter
from .scan import (empty_scan_table, iter_scan_partitions,
                   load_scan_partition, pushdown_read_cols,
                   scan_partition_indices)
from .sidecar import (read_sidecar, sidecar_mtime_ns, sidecar_path,
                      write_sidecar)

__all__ = [
    "HAS_PYARROW", "ParquetSource", "parquet_files", "write_parquet_source",
    "prefetch_iter", "empty_scan_table", "iter_scan_partitions",
    "load_scan_partition", "pushdown_read_cols", "scan_partition_indices",
    "read_sidecar", "sidecar_mtime_ns", "sidecar_path", "write_sidecar",
    "open_source",
]


def open_source(path: str):
    """Open an on-disk source by layout: ``.parquet`` file or directory of
    parquet files → :class:`ParquetSource`; directory with ``_meta.json``
    → :class:`~repro_torch.core.source.NpzDirectorySource`."""
    from repro_torch.core.source import NpzDirectorySource
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "_meta.json")):
            return NpzDirectorySource(path)
        return ParquetSource(path)
    return ParquetSource(path)
