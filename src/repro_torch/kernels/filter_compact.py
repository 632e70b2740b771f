"""Stable stream compaction on the card (``csrc/filter_compact.cu``).

Port of ``repro.kernels.filter_compact`` (the Pallas TPU kernel).  The
survivor positions are computed once per mask (tile counts, a scan over
the tiles, in-tile ballot ranks) and every column of a table is scattered
under them, byte for byte in its own dtype.

``launches`` counts the wrapper calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def _check_inputs(mask: torch.Tensor, cols) -> None:
    if not mask.is_cuda or mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("filter_compact: mask must be a contiguous 1-D "
                         "bool CUDA tensor")
    n = mask.shape[0]
    for name, v in cols:
        if v.device != mask.device or v.dim() != 1 or v.shape[0] != n \
                or not v.is_contiguous():
            raise ValueError(f"filter_compact: column {name!r} must be a "
                             f"contiguous 1-D tensor of {n} rows on "
                             f"{mask.device}")
        if v.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"filter_compact: column {name!r} has "
                             f"unsupported dtype {v.dtype}")


def _offsets(lib, mask: torch.Tensor, stream: int) -> tuple[torch.Tensor, int]:
    n = mask.shape[0]
    tiles = -(-n // lib.fc_tile_rows())
    counts = torch.empty((max(tiles, 1),), dtype=torch.int64, device=mask.device)
    offsets = torch.empty((tiles + 1,), dtype=torch.int64, device=mask.device)
    _build.check(lib.fc_count(mask.data_ptr(), n, counts.data_ptr(),
                              offsets.data_ptr(), stream), "fc_count")
    return offsets, tiles


def _scatter(lib, mask, offsets, pairs, zero_tail: int, stream: int) -> None:
    n = mask.shape[0]
    step = lib.fc_max_cols()
    for lo in range(0, len(pairs), step):
        group = pairs[lo:lo + step]
        k = len(group)
        srcs = (ctypes.c_void_p * k)(*[s.data_ptr() for s, _ in group])
        dsts = (ctypes.c_void_p * k)(*[d.data_ptr() for _, d in group])
        sizes = (ctypes.c_int * k)(*[s.element_size() for s, _ in group])
        _build.check(lib.fc_scatter_cols(
            mask.data_ptr(), n, offsets.data_ptr(),
            ctypes.cast(srcs, ctypes.c_void_p), ctypes.cast(dsts, ctypes.c_void_p),
            ctypes.cast(sizes, ctypes.c_void_p), k, zero_tail, stream),
            "fc_scatter_cols")


def filter_compact(values: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``values[mask]`` to the front (stable).  Returns ``(packed (N,),
    count)``; slots at or after ``count`` are zero.  No host sync."""
    global launches
    _check_inputs(mask, [("values", values)])
    lib = _build.lib()
    with torch.cuda.device(mask.device):
        stream = _build.stream_of(mask)
        offsets, tiles = _offsets(lib, mask, stream)
        out = torch.empty_like(values)
        _scatter(lib, mask, offsets, [(values, out)], 1, stream)
    launches += 1
    return out, offsets[tiles]


def filter_compact_table(cols: dict, mask: torch.Tensor) -> dict:
    """Every column of ``cols`` compacted under one mask.  The survivor
    count crosses to the host once, to size the outputs."""
    global launches
    items = list(cols.items())
    _check_inputs(mask, items)
    lib = _build.lib()
    with torch.cuda.device(mask.device):
        stream = _build.stream_of(mask)
        offsets, tiles = _offsets(lib, mask, stream)
        count = int(offsets[tiles].item())
        out = {k: torch.empty((count,), dtype=v.dtype, device=v.device)
               for k, v in items}
        _scatter(lib, mask, offsets, [(v, out[k]) for k, v in items], 0,
                 stream)
    launches += 1
    return out
