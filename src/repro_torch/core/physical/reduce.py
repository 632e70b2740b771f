"""Whole-column reductions to scalars.  Mean and median run in float64, as
pandas does."""
from __future__ import annotations

import numpy as np
import torch

from .table import Table, dtype_kind, is_torch, table_rows
from ...obs.spans import traced_op


def _median_torch(vals: torch.Tensor):
    """pandas median: NaN skipped, the two middle values averaged."""
    v = vals.to(torch.float64)
    v = torch.sort(v[~torch.isnan(v)]).values
    n = int(v.shape[0])
    if n == 0:
        return torch.tensor(float("nan"), dtype=torch.float64, device=v.device)
    if n % 2:
        return v[n // 2]
    return (v[n // 2 - 1] + v[n // 2]) / 2


@traced_op("reduce")
def apply_reduce(table: Table, column: str | None, fn: str):
    if fn == "count":
        return table_rows(table) if column is None else int(table[column].shape[0])
    vals = table[column]
    if not is_torch(vals):
        return _reduce_np(vals, fn)
    if fn == "sum":
        return vals.sum()          # torch sums integers and bools in int64
    if fn == "mean":
        return vals.to(torch.float64).mean()
    if fn == "min":
        return vals.min()
    if fn == "max":
        return vals.max()
    if fn == "nunique":
        return int(torch.unique(vals).shape[0])
    if fn == "median":
        return _median_torch(vals)
    raise ValueError(fn)


def _reduce_np(vals: np.ndarray, fn: str):
    if fn == "sum":
        return np.sum(vals)
    if fn == "mean":
        return np.mean(vals.astype(np.float64))
    if fn == "min":
        return np.min(vals)
    if fn == "max":
        return np.max(vals)
    if fn == "nunique":
        return int(np.unique(vals).shape[0])
    if fn == "median":
        if vals.shape[0] == 0:
            return float("nan")
        return float(np.nanmedian(vals.astype(np.float64)))
    raise ValueError(fn)
