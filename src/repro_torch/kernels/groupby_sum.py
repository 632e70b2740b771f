"""Deterministic segment sum and count on the card (``csrc/groupby_sum.cu``).

Port of ``repro.kernels.groupby_sum`` (the Pallas TPU kernel).  Integer
values accumulate in int64 and float values in their own type; row counts
come out of the same launch as exact int64.  Small ``G*V`` takes per-block
partials merged in block order; larger ``G*V`` sorts rows by code, cuts
each group's run into fixed-size pieces and sums pieces, then groups, one
warp each.  No float atomics: results are bit-identical run to run.

``launches`` counts the wrapper calls that launched the kernel.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.int64: 2}


def groupby_sum_count(codes: torch.Tensor, values: torch.Tensor | None,
                      num_groups: int, with_count: bool = True):
    """Segment sums of ``values`` (N,) or (N, V) and row counts by int64
    ``codes`` (N,).  Returns ``(sums (G,) | (G, V) | None, counts (G,) int64
    | None)``.  Codes outside [0, num_groups) add nothing.  ``values`` must
    be float32, float64 or int64 (the caller widens other integer types)."""
    global launches
    if not codes.is_cuda or codes.dtype != torch.int64 or codes.dim() != 1 \
            or not codes.is_contiguous():
        raise ValueError("groupby_sum: codes must be a contiguous 1-D int64 "
                         "CUDA tensor")
    n = codes.shape[0]
    squeeze = False
    if values is not None:
        if values.device != codes.device or values.shape[0] != n \
                or values.dim() not in (1, 2) or not values.is_contiguous():
            raise ValueError("groupby_sum: values must be a contiguous (N,) or "
                             f"(N, V) tensor on {codes.device} with N={n}")
        if values.dtype not in _DTYPE_CODE:
            raise ValueError(f"groupby_sum: unsupported dtype {values.dtype}")
        squeeze = values.dim() == 1
    if values is None and not with_count:
        raise ValueError("groupby_sum: nothing to compute")
    G = int(num_groups)
    V = 1 if squeeze else (0 if values is None else int(values.shape[1]))
    dt = values.dtype if values is not None else torch.int64
    dev = codes.device
    sums = (torch.empty((G, max(V, 1)), dtype=dt, device=dev)
            if values is not None else None)
    counts = torch.empty((G,), dtype=torch.int64, device=dev) \
        if with_count else None
    if G == 0:
        return (sums[:, 0] if squeeze else sums), counts
    lib = _build.lib()
    vptr = values.data_ptr() if values is not None else None
    sptr = sums.data_ptr() if sums is not None else None
    cptr = counts.data_ptr() if counts is not None else None
    slots = G * V + (G if with_count else 0)
    with torch.cuda.device(dev):
        stream = _build.stream_of(codes)
        if slots <= lib.gb_max_slots() and G <= lib.gb_max_slots():
            threads = lib.gb_threads()
            nb = max(1, min(lib.gb_max_blocks(), -(-n // threads)))
            part = torch.empty((max(nb * G * V, 1),), dtype=dt, device=dev)
            cpart = torch.empty((nb * G,), dtype=torch.int64, device=dev)
            err = lib.gb_sum_small(_DTYPE_CODE[dt], codes.data_ptr(), vptr, n,
                                   V, G, part.data_ptr(), cpart.data_ptr(), nb,
                                   sptr, cptr, stream)
            _build.check(err, "gb_sum_small")
        else:
            sorted_codes, perm = torch.sort(codes, stable=True)
            start = torch.empty((G,), dtype=torch.int64, device=dev)
            end = torch.empty((G,), dtype=torch.int64, device=dev)
            poff = torch.empty((G + 1,), dtype=torch.int64, device=dev)
            max_pieces = -(-n // lib.gb_piece_rows()) + G
            part = torch.empty((max_pieces * max(V, 1),), dtype=dt, device=dev)
            err = lib.gb_sum_sorted(_DTYPE_CODE[dt], sorted_codes.data_ptr(),
                                    perm.data_ptr(), vptr, n, V, G,
                                    start.data_ptr(), end.data_ptr(),
                                    poff.data_ptr(), part.data_ptr(),
                                    max_pieces, sptr, cptr, stream)
            _build.check(err, "gb_sum_sorted")
    launches += 1
    if sums is not None and squeeze:
        sums = sums[:, 0]
    return sums, counts
