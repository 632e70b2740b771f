"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, in the same dtypes.  The
dispatcher (``ops``) uses them for tensors that lie on the CPU; the card
tests and ``chip_smoke.py`` hold each kernel against them.
"""
from __future__ import annotations

import torch


def groupby_sum_count_ref(codes: torch.Tensor, values: torch.Tensor | None,
                          num_groups: int, with_count: bool = True):
    """Segment sums of ``values`` (N,) or (N, V) and int64 row counts by
    ``codes``; codes outside [0, num_groups) add nothing.  Sums keep the
    values' dtype (the caller widens integers to int64)."""
    valid = (codes >= 0) & (codes < num_groups)
    safe = torch.where(valid, codes, torch.full_like(codes, num_groups))
    sums = counts = None
    if values is not None:
        shape = (num_groups + 1,) + tuple(values.shape[1:])
        acc = torch.zeros(shape, dtype=values.dtype, device=values.device)
        sums = acc.index_add_(0, safe, values)[:num_groups]
    if with_count:
        ones = torch.ones_like(codes, dtype=torch.int64)
        acc = torch.zeros((num_groups + 1,), dtype=torch.int64,
                          device=codes.device)
        counts = acc.index_add_(0, safe, ones)[:num_groups]
    return sums, counts


def filter_count_ref(mask: torch.Tensor) -> torch.Tensor:
    """Number of surviving rows."""
    return mask.sum(dtype=torch.int64)


def filter_compact_ref(values: torch.Tensor, mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction: survivors packed to the front, zeros after them;
    returns (packed (N,), count ())."""
    kept = values[mask]
    out = torch.zeros_like(values)
    out[: kept.shape[0]] = kept
    return out, filter_count_ref(mask)


def filter_compact_table_ref(cols: dict, mask: torch.Tensor) -> dict:
    """Every column compacted under one mask."""
    return {k: v[mask] for k, v in cols.items()}


def _identities(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def zonemap_ref(values: torch.Tensor, block: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (min, max) of a 1-D tensor in its own dtype; the tail is
    padded with the dtype's identities, and NaN propagates."""
    n = values.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    lo_id, hi_id = _identities(values.dtype)
    v_lo = torch.cat([values, values.new_full((pad,), lo_id)])
    v_hi = torch.cat([values, values.new_full((pad,), hi_id)])
    mins = v_lo.reshape(nb, block).amin(dim=1)
    maxs = v_hi.reshape(nb, block).amax(dim=1)
    return mins, maxs
