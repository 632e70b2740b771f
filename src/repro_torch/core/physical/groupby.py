"""Group-by aggregation: factorize keys → dense segment reductions.

On tensor tables count, sum and mean go through
``repro_torch.kernels.ops.groupby_sum_count`` (the hand-written kernel for
CUDA tensors, its plain version for CPU tensors): one launch gives the sums
and the exact int64 row counts, so mean is one launch.  Integer sums
accumulate in int64, float sums in the column's own type.  min and max use
``scatter_reduce``.  numpy tables keep the host path."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .table import Table, dtype_kind, is_torch
from ...obs.spans import traced_op


def _factorize(arr):
    """codes, uniques — order of uniques is sorted-value order."""
    if is_torch(arr):
        uniques, codes = torch.unique(arr, sorted=True, return_inverse=True)
    else:
        uniques, codes = np.unique(arr, return_inverse=True)
    return codes, uniques


def _factorize_multi(table: Table, cols: Sequence[str]):
    """Multi-column factorize via mixed-radix combination (int64 codes).

    Returns (codes, key_arrays_fn) where key_arrays_fn(group_codes) maps the
    final group code array back to per-column key values.
    """
    per = []
    radices = []
    for c in cols:
        codes, uniques = _factorize(table[c])
        per.append((codes, uniques))
        radices.append(int(uniques.shape[0]))
    first = per[0][0]
    combined = first.to(torch.int64) if is_torch(first) else first.astype(np.int64)
    for (codes, _), r in zip(per[1:], radices[1:]):
        combined = combined * r + codes

    def decode(group_codes):
        out = {}
        rem = group_codes
        for (c, (_, uniques)), r in zip(
                reversed(list(zip(cols, per))), reversed(radices)):
            out[c] = uniques[rem % r]
            rem = rem // r
        return out

    return combined, decode


@traced_op("groupby_agg")
def apply_groupby_agg(table: Table, keys: Sequence[str],
                      aggs: Mapping[str, tuple[str, str]]) -> Table:
    """Dense aggregation: factorize keys → segment reductions."""
    combined, decode = _factorize_multi(table, list(keys))
    if is_torch(combined):
        groups, inv = torch.unique(combined, sorted=True, return_inverse=True)
        num = int(groups.shape[0])
        inv = inv.contiguous()
        out = decode(groups)
        for out_name, (col, fn) in aggs.items():
            out[out_name] = _segment_agg_torch(table, col, fn, inv, num)
    else:
        groups, inv = np.unique(combined, return_inverse=True)
        num = int(groups.shape[0])
        out = decode(groups)
        for out_name, (col, fn) in aggs.items():
            out[out_name] = _segment_agg_np(table, col, fn, inv, num)
    return out


def _sum_values(vals: torch.Tensor) -> torch.Tensor:
    """Values as the kernel takes them: integers and bools widen to int64."""
    if dtype_kind(vals) in "iub":
        vals = vals.to(torch.int64)
    elif vals.dtype not in (torch.float32, torch.float64):
        vals = vals.to(torch.float32)
    return vals.contiguous()


def _segment_agg_torch(table, col, fn, seg_ids, num):
    from ...kernels import ops as K
    if fn == "count":
        return K.groupby_sum_count(seg_ids, None, num)[1]
    vals = table[col]
    if fn == "sum":
        return K.groupby_sum(seg_ids, _sum_values(vals), num)
    if fn == "mean":
        s, c = K.groupby_sum_count(seg_ids, _sum_values(vals), num)
        return (s if s.dtype.is_floating_point else s.to(torch.float64)) / c
    if fn in ("min", "max"):
        # every group has rows, so include_self=False overwrites each slot
        return vals.new_zeros((num,)).scatter_reduce(
            0, seg_ids, vals, "amin" if fn == "min" else "amax",
            include_self=False)
    if fn == "nunique":
        sub_codes, _ = _factorize(vals)
        width = int(sub_codes.max()) + 1 if sub_codes.numel() else 1
        pairs = torch.unique(seg_ids * width + sub_codes)
        return K.groupby_sum_count(pairs // width, None, num)[1]
    raise ValueError(f"unknown agg fn {fn}")


def _segment_agg_np(table, col, fn, seg_ids, num):
    if fn == "count":
        return np.bincount(seg_ids, minlength=num).astype(np.int64)
    vals = table[col]
    if fn == "sum":
        return np.bincount(seg_ids, weights=vals, minlength=num).astype(
            vals.dtype if vals.dtype.kind == "f" else np.float64)
    if fn == "mean":
        s = np.bincount(seg_ids, weights=vals.astype(np.float64), minlength=num)
        c = np.bincount(seg_ids, minlength=num)
        return s / np.maximum(c, 1)
    if fn in ("min", "max"):
        out = np.full(num, np.inf if fn == "min" else -np.inf, dtype=np.float64)
        ufn = np.minimum if fn == "min" else np.maximum
        ufn.at(out, seg_ids, vals.astype(np.float64))
        return out.astype(vals.dtype) if vals.dtype.kind == "f" else out
    if fn == "nunique":
        sub_codes, _ = _factorize(vals)
        pair = seg_ids.astype(np.int64) * (int(sub_codes.max()) + 1) + sub_codes
        uniq = np.unique(pair)
        seg = (uniq // (int(sub_codes.max()) + 1)).astype(np.int64)
        return np.bincount(seg, minlength=num).astype(np.int64)
    raise ValueError(f"unknown agg fn {fn}")
