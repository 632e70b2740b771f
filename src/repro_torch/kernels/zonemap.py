"""Per-block (min, max) zone maps on the card (``csrc/zonemap.cu``).

Port of ``repro.kernels.zonemap`` (the Pallas TPU kernel).  Bounds stay in
the column's own dtype, and a block holding a NaN reports NaN.  With
``block_rows`` set to a source's partition size, one launch gives the zone
map of every partition of a column.

``launches`` counts the wrapper calls that launched the kernel.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.int8: 2,
               torch.uint8: 3, torch.int16: 4, torch.int32: 5, torch.int64: 6}


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
    mins = torch.empty((nb,), dtype=values.dtype, device=values.device)
    maxs = torch.empty((nb,), dtype=values.dtype, device=values.device)
    lib = _build.lib()
    with torch.cuda.device(values.device):
        err = lib.zm_minmax(_DTYPE_CODE[values.dtype], values.data_ptr(), n,
                            int(block_rows), mins.data_ptr(), maxs.data_ptr(),
                            _build.stream_of(values))
    _build.check(err, "zm_minmax")
    launches += 1
    return mins, maxs
