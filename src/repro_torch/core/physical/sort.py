"""Sort and distinct over tensor (or numpy) tables.

Stable lexsort keeps pandas row-order semantics (descending = reversed
ascending, ties included); distinct keeps first occurrences in input order.
torch has no ``lexsort`` and no ``unique(return_index=True)``: both come
from ``table``."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .groupby import _factorize_multi
from .table import (Table, argsort_stable, is_torch, lexsort, reverse,
                    to_host_array, xp_of)
from ...obs.spans import traced_op


def _take(table: Table, idx) -> Table:
    if xp_of(table) is torch:
        like = next(iter(table.values()))
        idx = torch.as_tensor(idx, device=like.device)
    return {k: v[idx] for k, v in table.items()}


@traced_op("sort")
def apply_sort(table: Table, by: Sequence[str], ascending: bool = True) -> Table:
    keys = [table[b] for b in reversed(by)]
    idx = lexsort(keys) if len(keys) > 1 else argsort_stable(keys[0])
    if not ascending:
        idx = reverse(idx)
    return _take(table, idx)


def _order_indices(cols, ascending: bool, ties_first: bool):
    """Stable row ordering by ``cols`` (first column primary).

    ``ties_first=True`` keeps the first occurrence of equal keys first in
    the output (pandas ``keep='first'``); ``ties_first=False`` with
    descending reproduces the reversed-stable-ascending order of
    ``apply_sort(ascending=False)`` exactly."""
    def asc(cs):
        if len(cs) > 1:
            return lexsort(list(reversed(cs)))
        return argsort_stable(cs[0])

    if ascending:
        return asc(cols)                   # stable ascending ⇒ ties first
    if not ties_first:
        return reverse(asc(cols))          # reversed stable ⇒ ties last
    # descending with first-occurrence ties: argsort the reversed arrays so
    # stability prefers the original first occurrence, then map back.
    n_rows = int(cols[0].shape[0])
    rev = asc(tuple(reverse(c) for c in cols))
    return reverse((n_rows - 1) - rev)


@traced_op("top_k")
def apply_top_k(table: Table, by: Sequence[str], n: int,
                ascending: bool = True, mode: str = "sort") -> Table:
    """First ``n`` rows of the stable sort by ``by`` without materializing
    the full sorted table (only ``n`` rows of every column are gathered).

    ``mode="sort"`` equals ``apply_sort(table, by, ascending)[:n]`` row for
    row (ties, NaN placement included); ``mode="select"`` is pandas
    ``nlargest``/``nsmallest``: rows with NaN sort keys are dropped and
    ties keep the first occurrence.  The k selection indices are computed
    on host numpy (keys copied to the host), with an O(rows)
    ``np.partition`` threshold pass for single numeric keys so only ~n
    candidate rows are argsorted; device columns are gathered once at the
    final k-row index."""
    keys = [to_host_array(table[b]) for b in by]
    sel = None
    if mode == "select":
        mask = None
        for kk in keys:
            if kk.dtype.kind == "f":
                m = np.isnan(kk)
                mask = m if mask is None else (mask | m)
        if mask is not None and mask.any():
            sel = np.nonzero(~mask)[0]
            keys = [kk[sel] for kk in keys]
    total = int(keys[0].shape[0]) if keys else 0
    k = max(0, min(int(n), total))
    if k == 0:
        return {c: v[:0] for c, v in table.items()}
    ties_first = ascending or mode == "select"
    cand = None
    first = keys[0]
    if (len(keys) == 1 and k < total
            and first.dtype.kind in "biuf"
            and not (first.dtype.kind == "f" and np.isnan(first).any())):
        pos = k - 1 if ascending else total - k
        thr = np.partition(first, pos)[pos]
        cand = np.nonzero(first <= thr if ascending else first >= thr)[0]
        keys = [first[cand]]
    order = _order_indices(tuple(keys), ascending, ties_first)[:k]
    idx = cand[order] if cand is not None else order
    if sel is not None:
        idx = sel[idx]
    return _take(table, np.ascontiguousarray(idx))


@traced_op("drop_duplicates")
def apply_drop_duplicates(table: Table, subset=None) -> Table:
    from .table import unique_first_index
    cols = list(subset) if subset else list(table.keys())
    codes, _ = _factorize_multi(table, cols)
    first_idx = unique_first_index(codes)
    idx = torch.sort(first_idx).values if is_torch(first_idx) else np.sort(first_idx)
    return _take(table, idx)
