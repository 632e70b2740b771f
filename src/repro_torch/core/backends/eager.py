"""Eager backend: whole-table execution on the default torch device
(``REPRO_TORCH_DEVICE``, default ``"cuda"``).

Faithful to paper §2.6: topological execution with in-degree refcounting so a
node's result is freed as soon as its last consumer has run; persist-marked
nodes go to the context cache instead of being freed.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from .. import physical as X
from .. import graph as G
from ..context import LaFPContext


class EagerBackend:
    name = "eager"

    def __init__(self, device_arrays: bool = True):
        self.device_arrays = device_arrays

    # -- node evaluation ------------------------------------------------------
    def _load_scan(self, n: G.Scan, ctx: LaFPContext | None = None):
        # shared pushdown-aware loader (repro_torch.io): per-partition
        # column projection and io.* accounting.  With device columns the
        # pushed-down predicate runs on the device after one upload (one
        # filter_compact launch over the whole table) instead of a host
        # gather per partition.
        from ...io.scan import (device_pushdown, empty_scan_table,
                                load_scan_partition, scan_partition_indices)
        metrics = getattr(ctx, "metrics", None)
        tracer = getattr(ctx, "tracer", None)
        if metrics is not None and n.skip_partitions:
            metrics.inc("io.partitions_pruned", len(n.skip_partitions))
        on_device = self.device_arrays
        parts = [load_scan_partition(n, pi, metrics=metrics, tracer=tracer,
                                     apply_pushdown=not on_device)
                 for pi in scan_partition_indices(n)]
        if not parts:
            table = empty_scan_table(n)
            return X.to_torch(table) if on_device else table
        table = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
        if not on_device:
            return table
        impl = ctx.backend_options.get("kernel_impl") if ctx else None
        return device_pushdown(n, X.to_torch(table), metrics, impl)

    def eval_node(self, n: G.Node, vals: list[Any], ctx: LaFPContext):
        if isinstance(n, G.Handoff):
            return X.handoff_value(n, self.device_arrays)
        if isinstance(n, G.Materialized):
            return (X.to_torch(n.table) if self.device_arrays else n.table)
        if isinstance(n, G.Scan):
            return self._load_scan(n, ctx)
        if isinstance(n, G.Filter):
            return X.apply_filter(vals[0], n.predicate,
                                  ctx.backend_options.get("kernel_impl"))
        if isinstance(n, G.Project):
            return X.apply_project(vals[0], n.columns)
        if isinstance(n, G.Assign):
            return X.apply_assign(vals[0], n.name, n.expr)
        if isinstance(n, G.Rename):
            return X.apply_rename(vals[0], n.mapping)
        if isinstance(n, G.AsType):
            return X.apply_astype(vals[0], n.dtypes)
        if isinstance(n, G.FillNa):
            return X.apply_fillna(vals[0], n.value, n.columns)
        if isinstance(n, G.FusedRowwise):
            return X.apply_fused_rowwise(
                vals[0], n.ops, ctx.backend_options.get("kernel_impl"))
        if isinstance(n, G.SortValues):
            return X.apply_sort(vals[0], n.by, n.ascending)
        if isinstance(n, G.DropDuplicates):
            return X.apply_drop_duplicates(vals[0], n.subset)
        if isinstance(n, G.Head):
            return X.apply_head(vals[0], n.n)
        if isinstance(n, G.TopK):
            return X.apply_top_k(vals[0], n.by, n.n, n.ascending, n.mode)
        if isinstance(n, G.MapRows):
            return X.apply_map_rows(vals[0], n.fn)
        if isinstance(n, G.GroupByAgg):
            return X.apply_groupby_agg(vals[0], n.keys, n.aggs)
        if isinstance(n, G.Join):
            return X.apply_join(vals[0], vals[1], n.on, n.how, n.suffixes)
        if isinstance(n, G.Concat):
            return X.apply_concat(vals)
        if isinstance(n, G.Reduce):
            return X.apply_reduce(vals[0], n.column, n.fn)
        if isinstance(n, G.Length):
            return X.table_rows(vals[0])
        if isinstance(n, G.SinkPrint):
            return self._run_sink(n, vals, ctx)
        raise NotImplementedError(f"eager: {n.op}")

    def _run_sink(self, n: G.SinkPrint, vals, ctx: LaFPContext):
        from ..sinks import render_sink
        render_sink(n, vals[: n.n_data], ctx)
        return None

    # -- driver ----------------------------------------------------------------
    @staticmethod
    def _value_nbytes(val) -> int:
        """Device-tensor bytes of one node result (tables only — scalars and
        sinks are negligible)."""
        if isinstance(val, dict):
            return int(X.table_nbytes(val))
        nb = getattr(val, "nbytes", None)
        return int(nb) if isinstance(nb, (int, float)) else 0

    def execute(self, roots: list[G.Node], ctx: LaFPContext) -> dict[int, Any]:
        order = G.walk(roots)
        refcount: dict[int, int] = {}
        for n in order:
            for i in n.inputs:
                refcount[i.id] = refcount.get(i.id, 0) + 1
        root_ids = {r.id for r in roots}
        results: dict[int, Any] = {}
        # deterministic peak metering: resident device-buffer bytes through
        # the refcounted walk — feeds the planner's peak-estimate
        # calibration (StatsStore.record_peak), which before only got
        # samples from the streaming MemoryMeter
        current = peak = 0
        for n in order:
            vals = [results[i.id] for i in n.inputs]
            results[n.id] = self.eval_node(n, vals, ctx)
            current += self._value_nbytes(results[n.id])
            peak = max(peak, current)
            if n.persist and not isinstance(n, (G.SinkPrint, G.Materialized)):
                ctx.persist_stats["misses"] += 1
                key = getattr(n, "cache_key", None) or n.key()
                val = results[n.id]
                if isinstance(val, dict):
                    val = X.to_numpy(val)      # cache host-side
                ctx.persist_cache[key] = val
            # paper §2.6: free inputs whose consumers are all done
            for i in n.inputs:
                refcount[i.id] -= 1
                if refcount[i.id] == 0 and i.id not in root_ids:
                    if not i.persist:
                        current -= self._value_nbytes(results[i.id])
                        results[i.id] = None  # allow GC; keep slot for roots
        ctx.last_run_peak_bytes = peak
        ctx.last_run_peak_engine = self.name
        ctx.last_peak_bytes = max(ctx.last_peak_bytes, peak)
        return {rid: results.get(rid) for rid in root_ids}
