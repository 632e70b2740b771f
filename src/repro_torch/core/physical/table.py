"""Table protocol on tensors.

A *table* is ``dict[str, array]`` of equal-length 1-D columns; arrays are
either numpy (host data: sources, fallback results) or ``torch.Tensor``
(the eager engine's device-resident whole table).  Physical operators
dispatch on the array type (``xp_of``).

The device comes from ``REPRO_TORCH_DEVICE`` (default ``"cuda"``).  Tables
move onto it only through ``to_torch``; a CUDA device with no card raises
there, naming the variable.  Nothing moves to the CPU on its own.

Also here: the numpy/torch gaps the operators need (dtype kind, dtype
names, stable lexsort, first-occurrence index of unique codes) and segment
handoff normalization (tables cross engine boundaries as numpy column
dicts, device scalars as python numbers).
"""
from __future__ import annotations

import os

import numpy as np
import torch

Table = dict

DEVICE_ENV = "REPRO_TORCH_DEVICE"

_KIND = {torch.bool: "b", torch.uint8: "u", torch.uint16: "u",
         torch.uint32: "u", torch.uint64: "u", torch.int8: "i",
         torch.int16: "i", torch.int32: "i", torch.int64: "i",
         torch.float16: "f", torch.bfloat16: "f", torch.float32: "f",
         torch.float64: "f", torch.complex64: "c", torch.complex128: "c"}


def default_device() -> torch.device:
    """The device tables are moved onto: ``REPRO_TORCH_DEVICE``, default
    ``"cuda"``.  Raises when it names CUDA and no card is present."""
    name = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{DEVICE_ENV}={name!r} but torch finds no CUDA device; set "
            f"{DEVICE_ENV}=cpu to run the port on the CPU")
    return dev


def is_torch(arr) -> bool:
    return isinstance(arr, torch.Tensor)


def xp_of(table: Table):
    """``torch`` for a tensor table, ``np`` for a host table."""
    for v in table.values():
        return torch if is_torch(v) else np
    return np


def dtype_kind(arr) -> str:
    """numpy's one-letter dtype kind for a tensor or an array."""
    if is_torch(arr):
        return _KIND[arr.dtype]
    return arr.dtype.kind


def torch_dtype(spec) -> torch.dtype:
    """numpy dtype name (or dtype) → torch dtype."""
    return getattr(torch, np.dtype(spec).name)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


def astype(arr, spec):
    """``arr.astype(spec)`` for arrays and tensors alike."""
    if is_torch(arr):
        return arr.to(torch_dtype(spec))
    return arr.astype(spec)


def to_host_array(v) -> np.ndarray:
    """Host numpy copy of a tensor (or ``np.asarray`` of anything else)."""
    if is_torch(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def to_device_array(v, device=None) -> torch.Tensor:
    """One column onto ``device`` (default: ``default_device()``); a
    read-only numpy array is copied first, as torch cannot wrap it."""
    device = device or default_device()
    if is_torch(v):
        return v.to(device)
    arr = np.ascontiguousarray(v)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def table_rows(table: Table) -> int:
    for v in table.values():
        return int(v.shape[0])
    return 0


def table_nbytes(table: Table) -> int:
    return sum(int(v.nbytes) for v in table.values())


def to_numpy(table: Table) -> Table:
    return {k: to_host_array(v) for k, v in table.items()}


def to_torch(table: Table, device=None) -> Table:
    """Move every column onto ``device`` (default: ``default_device()``)."""
    dev = device if device is not None else default_device()
    return {k: to_device_array(v, dev) for k, v in table.items()}


def apply_concat(tables: list[Table]) -> Table:
    cols = set(tables[0])
    for t in tables[1:]:
        cols &= set(t)
    if xp_of(tables[0]) is torch:
        return {c: torch.cat([t[c] for t in tables]) for c in sorted(cols)}
    return {c: np.concatenate([t[c] for t in tables]) for c in sorted(cols)}


def full_rows(value, rows: int, like: torch.Tensor) -> torch.Tensor:
    """A column of ``rows`` copies of a python scalar, in numpy's dtype for
    it (float64, int64, bool), on ``like``'s device."""
    dt = torch_dtype(np.asarray(value).dtype)
    return torch.full((rows,), value, dtype=dt, device=like.device)


def argsort_stable(arr):
    if is_torch(arr):
        return torch.argsort(arr, stable=True)
    return np.argsort(arr, kind="stable")


def lexsort(keys):
    """``np.lexsort`` for tensors too: the last key is the primary one."""
    if not is_torch(keys[0]):
        return np.lexsort(tuple(keys))
    idx = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        idx = idx[torch.argsort(k[idx], stable=True)]
    return idx


def reverse(arr):
    """``arr[::-1]`` for arrays and tensors."""
    return arr.flip(0) if is_torch(arr) else arr[::-1]


def unique_first_index(codes):
    """Index of the first occurrence of each distinct value, in the order
    of the sorted distinct values (``np.unique(..., return_index=True)``)."""
    if not is_torch(codes):
        return np.unique(codes, return_index=True)[1]
    uniq, inv = torch.unique(codes, sorted=True, return_inverse=True)
    pos = torch.arange(codes.shape[0], device=codes.device)
    first = torch.full((uniq.shape[0],), codes.shape[0], dtype=torch.int64,
                       device=codes.device)
    return first.scatter_reduce(0, inv, pos, "amin", include_self=True)


# ---------------------------------------------------------------------------
# Segment handoff
#
# Values crossing an engine-segment boundary are normalized to host
# representation: tables become numpy column dicts, device scalars become
# python numbers.


def to_host_value(value):
    """Normalize a segment output for transfer to another engine."""
    if isinstance(value, dict):
        return to_numpy(value)
    if is_torch(value) or isinstance(value, np.generic):
        arr = to_host_array(value)
        return arr.item() if arr.ndim == 0 else arr
    return value


def handoff_value(node, device_arrays: bool = False):
    """Evaluate a ``graph.Handoff`` leaf inside a backend: its payload, moved
    onto the device when the consuming engine keeps device columns."""
    v = node.value
    if isinstance(v, dict):
        return to_torch(v) if device_arrays else v
    return v
