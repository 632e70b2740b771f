"""Host hash/sort join (build side = right); a tensor table's result goes
back to its device.

Keys are factorized over the union of both sides so codes align; the probe
side binary-searches the sorted build codes.  Pandas semantics: inner/left,
probe-row order preserved, overlap columns suffixed, unmatched left-join
float columns filled with NaN."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .table import Table, to_numpy, to_torch, xp_of
from ...obs.spans import traced_op


@traced_op("join")
def apply_join(left: Table, right: Table, on: Sequence[str], how="inner",
               suffixes=("_x", "_y")) -> Table:
    lj, rj = to_numpy(left), to_numpy(right)
    device = (next(iter(left.values())).device if xp_of(left) is torch
              else None)
    lkeys, _ = _factorize_multi_np_pair(lj, rj, on)
    lcode, rcode = lkeys
    order = np.argsort(rcode, kind="stable")
    rsorted = rcode[order]
    lo = np.searchsorted(rsorted, lcode, side="left")
    hi = np.searchsorted(rsorted, lcode, side="right")
    counts = hi - lo
    if how == "inner":
        l_idx = np.repeat(np.arange(lcode.shape[0]), counts)
        starts = np.repeat(lo, counts)
        within = np.arange(l_idx.shape[0]) - np.repeat(
            np.cumsum(counts) - counts, counts)
        r_idx = order[starts + within]
    elif how == "left":
        counts2 = np.maximum(counts, 1)
        l_idx = np.repeat(np.arange(lcode.shape[0]), counts2)
        starts = np.repeat(lo, counts2)
        within = np.arange(l_idx.shape[0]) - np.repeat(
            np.cumsum(counts2) - counts2, counts2)
        matched = np.repeat(counts > 0, counts2)
        if len(order):
            r_idx = np.where(matched, order[np.minimum(starts + within,
                                                       len(order) - 1)], -1)
        else:
            # empty build side: every probe row is unmatched (reachable per
            # shard in the distributed shuffle join's key buckets)
            r_idx = np.full(l_idx.shape[0], -1)
    else:
        raise ValueError(f"join how={how!r} not supported")
    out = {}
    overlap = (set(lj) & set(rj)) - set(on)
    for k in on:
        out[k] = lj[k][l_idx]
    for k, v in lj.items():
        if k in on:
            continue
        out[k + suffixes[0] if k in overlap else k] = v[l_idx]
    for k, v in rj.items():
        if k in on:
            continue
        name = k + suffixes[1] if k in overlap else k
        col = (v[np.maximum(r_idx, 0)] if v.shape[0]
               else np.zeros(r_idx.shape[0], v.dtype))
        if how == "left" and col.dtype.kind == "f":
            col = np.where(r_idx >= 0, col, np.nan)
        out[name] = col
    if device is not None:
        out = to_torch(out, device)
    return out


def _factorize_multi_np_pair(lt: Table, rt: Table, on: Sequence[str]):
    """Factorize join keys over the union of both sides so codes align."""
    lcode = np.zeros(len(next(iter(lt.values()))), np.int64)
    rcode = np.zeros(len(next(iter(rt.values()))), np.int64)
    for c in on:
        both = np.concatenate([np.asarray(lt[c]), np.asarray(rt[c])])
        uniques, codes = np.unique(both, return_inverse=True)
        lc = codes[: len(lt[c])]
        rc = codes[len(lt[c]):]
        lcode = lcode * len(uniques) + lc
        rcode = rcode * len(uniques) + rc
    return (lcode, rcode), None
