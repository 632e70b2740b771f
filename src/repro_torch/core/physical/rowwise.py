"""Row-preserving pipeline operators over tensor (or numpy) tables.

Filters compact every column of a tensor table under one mask through
``repro_torch.kernels.ops.filter_compact_table``: the hand-written kernel
for CUDA tensors, its plain version for CPU tensors."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .table import (Table, astype, dtype_kind, full_rows, table_rows,
                    to_numpy, to_torch, xp_of)
from ...obs.spans import traced_op


def _kernel_cfg(impl: str | None):
    from ...kernels import ops as K
    if impl is None or impl == "auto":
        return K.get_kernel_config()
    return K.KernelConfig(impl=impl)


def compact_rows(table: Table, mask, impl: str | None = None) -> Table:
    """The rows of every column where ``mask`` holds; a tensor table takes
    one ``filter_compact`` launch for all its columns."""
    if xp_of(table) is np:
        mask = np.asarray(mask)
        return {k: v[mask] for k, v in table.items()}
    from ...kernels import ops as K
    mask = _scalar_column(mask, table).to(torch.bool).contiguous()
    table = {k: v.contiguous() for k, v in table.items()}
    return K.filter_compact_table(table, mask, _kernel_cfg(impl))


def _scalar_column(val, table: Table):
    """Broadcast a scalar expression value to a full column."""
    if np.isscalar(val) or getattr(val, "ndim", 1) == 0:
        rows = table_rows(table)
        if xp_of(table) is np:
            return np.full((rows,), val)
        like = next(iter(table.values()))
        if isinstance(val, torch.Tensor):
            return val.to(like.device).expand(rows).clone()
        return full_rows(val, rows, like)
    return val


def _fill_nan(arr, value):
    if dtype_kind(arr) != "f":
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.where(torch.isnan(arr),
                           torch.tensor(value, dtype=arr.dtype,
                                        device=arr.device), arr)
    return np.where(np.isnan(arr), np.asarray(value, dtype=arr.dtype), arr)


@traced_op("filter")
def apply_filter(table: Table, predicate, impl: str | None = None) -> Table:
    return compact_rows(table, predicate.evaluate(table), impl)


@traced_op("project")
def apply_project(table: Table, columns: Sequence[str]) -> Table:
    return {c: table[c] for c in columns}


@traced_op("assign")
def apply_assign(table: Table, name: str, expr) -> Table:
    out = dict(table)
    out[name] = _scalar_column(expr.evaluate(table), table)
    return out


@traced_op("rename")
def apply_rename(table: Table, mapping: Mapping[str, str]) -> Table:
    return {mapping.get(k, k): v for k, v in table.items()}


@traced_op("astype")
def apply_astype(table: Table, dtypes: Mapping[str, str]) -> Table:
    out = dict(table)
    for c, dt in dtypes.items():
        out[c] = astype(out[c], dt)
    return out


@traced_op("fillna")
def apply_fillna(table: Table, value, columns=None) -> Table:
    out = dict(table)
    for c in (columns or table.keys()):
        out[c] = _fill_nan(out[c], value)
    return out


@traced_op("head")
def apply_head(table: Table, n: int) -> Table:
    return {k: v[:n] for k, v in table.items()}


# ---------------------------------------------------------------------------
# Fused rowwise chains (graph.FusedRowwise, built by core.fuse)


@traced_op("fused_rowwise")
def apply_fused_rowwise(table: Table, ops, impl: str | None = None) -> Table:
    """Execute a FusedRowwise chain as one composed pass.  Compute members
    run on full columns while Filter members AND into one deferred mask
    (every fusable op is elementwise, so values at surviving rows are
    unchanged); the chain ends in one compaction of the whole table, whose
    survivor count syncs to the host once."""
    cols, mask = dict(table), None
    for m in ops:
        if m.op == "filter":
            pred = m.predicate.evaluate(cols)
            mask = pred if mask is None else (mask & pred)
        elif m.op == "project":
            cols = {c: cols[c] for c in m.columns}
        elif m.op == "assign":
            cols = dict(cols)
            cols[m.name] = _scalar_column(m.expr.evaluate(cols), cols)
        elif m.op == "rename":
            cols = {m.mapping.get(c, c): v for c, v in cols.items()}
        elif m.op == "astype":
            cols = dict(cols)
            for c, dt in m.dtypes.items():
                cols[c] = astype(cols[c], dt)
        elif m.op == "fillna":
            cols = dict(cols)
            for c in (m.columns or tuple(cols)):
                cols[c] = _fill_nan(cols[c], m.value)
        else:
            raise NotImplementedError(f"fused member {m.op}")
    if mask is None:
        return cols
    return compact_rows(cols, mask, impl)


@traced_op("map_rows")
def apply_map_rows(table: Table, fn) -> Table:
    """Whole-frame UDF: user functions are written against numpy, so a
    tensor table goes to the host and the result comes back to its device."""
    if xp_of(table) is np or not table:
        return fn(dict(table))
    device = next(iter(table.values())).device
    return to_torch(fn(to_numpy(table)), device)
