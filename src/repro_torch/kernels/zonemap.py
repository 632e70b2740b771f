"""Per-block (min, max) zone maps on the card (``csrc/zonemap.cu``).

Port of ``repro.kernels.zonemap`` (the Pallas TPU kernel).  Bounds stay in
the column's own dtype, and a block holding a NaN reports NaN.  With
``block_rows`` set to a source's partition size, one call gives the zone
map of every partition of a column.  Each block is cut into pieces
(``plan_split``) so that few large blocks still spread over every SM.

``launches`` counts the wrapper calls that launched the kernel.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.int8: 2,
               torch.uint8: 3, torch.int16: 4, torch.int32: 5, torch.int64: 6}

# Pieces planned per SM: at most ZM_MIN_BLOCKS in csrc/zonemap.cu, so that
# all are resident at once.  Two measured best on an H100 (PERF.md): one
# thread block per SM already reads near the card's rate, so blocks are
# only cut when there are fewer than two per SM.
CTAS_PER_SM = 2
MIN_PIECE_BYTES = 256 * 4 * 16  # ZM_THREADS threads x ZM_UNROLL 16-byte loads
_SMS: dict[int, int] = {}


def plan_split(n: int, block_rows: int, elem_size: int, sms: int
               ) -> tuple[int, int]:
    """``(split, piece_rows)``: each of the ``ceil(n / block_rows)`` blocks
    is cut into ``split`` pieces of ``piece_rows`` rows, one thread block
    each.  The pieces fit on ``sms`` SMs ``CTAS_PER_SM`` deep in one wave,
    each holds at least ``MIN_PIECE_BYTES``, and ``piece_rows`` is a
    multiple of a 16-byte vector so that pieces of an aligned block stay
    aligned."""
    nb = -(-n // block_rows)
    rows = min(block_rows, n)
    split = min(sms * CTAS_PER_SM // nb, rows * elem_size // MIN_PIECE_BYTES)
    if split <= 1:
        return 1, block_rows
    vec = 16 // elem_size
    piece = -(-rows // split)
    piece = -(-piece // vec) * vec
    return -(-rows // piece), piece


def zonemap(values: torch.Tensor, block_rows: int = 4096
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (min, max) of a non-empty 1-D CUDA tensor; blocks of
    ``block_rows`` rows, the last one ragged."""
    global launches
    if not values.is_cuda or values.dim() != 1 or not values.is_contiguous():
        raise ValueError("zonemap: values must be a contiguous 1-D CUDA tensor")
    if values.dtype not in _DTYPE_CODE:
        raise ValueError(f"zonemap: unsupported dtype {values.dtype}")
    if block_rows <= 0:
        raise ValueError("zonemap: block_rows must be positive")
    n = values.shape[0]
    nb = -(-n // block_rows)
    dev = values.device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    split, piece_rows = plan_split(n, int(block_rows), values.element_size(),
                                   _SMS[dev.index])
    mins = torch.empty((nb,), dtype=values.dtype, device=dev)
    maxs = torch.empty((nb,), dtype=values.dtype, device=dev)
    partials = (torch.empty((2 * nb * split,), dtype=values.dtype, device=dev)
                if split > 1 else None)
    lib = _build.lib()
    with torch.cuda.device(dev):
        err = lib.zm_minmax(_DTYPE_CODE[values.dtype], values.data_ptr(), n,
                            int(block_rows), split, piece_rows,
                            partials.data_ptr() if partials is not None else None,
                            mins.data_ptr(), maxs.data_ptr(),
                            _build.stream_of(values))
    _build.check(err, "zm_minmax")
    launches += 1
    return mins, maxs
