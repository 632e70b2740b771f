"""Column/table schemas and dtype lattice for the LaFP engine.

Device note: strings never reach the device — a string column is
dictionary-encoded at the source (int32 codes + host-side vocab), which is
the paper's `category` optimization (§3.6) made mandatory.  Datetimes are
int64 epoch seconds; `.dt` accessors are integer arithmetic on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# DTypes

_NARROW_ORDER_INT = [np.int8, np.int16, np.int32, np.int64]
_NARROW_ORDER_FLOAT = [np.float32, np.float64]

DATETIME = "datetime64[s]"  # stored as int64 epoch seconds on device


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: str                      # numpy dtype string, or 'dict' for encoded strings
    is_dict: bool = False           # dictionary-encoded string column
    dict_size: int | None = None    # vocab size when is_dict
    is_datetime: bool = False       # int64 epoch seconds

    @property
    def np_dtype(self) -> np.dtype:
        if self.is_dict:
            return np.dtype(np.int32)
        if self.is_datetime:
            return np.dtype(np.int64)
        return np.dtype(self.dtype)

    @property
    def itemsize(self) -> int:
        return self.np_dtype.itemsize


@dataclasses.dataclass(frozen=True)
class TableSchema:
    columns: tuple[ColumnSchema, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def col(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def select(self, names: Sequence[str]) -> "TableSchema":
        return TableSchema(tuple(self.col(n) for n in names))

    def with_column(self, col: ColumnSchema) -> "TableSchema":
        cols = tuple(c for c in self.columns if c.name != col.name)
        return TableSchema(cols + (col,))

    def drop(self, names: Sequence[str]) -> "TableSchema":
        drop = set(names)
        return TableSchema(tuple(c for c in self.columns if c.name not in drop))

    def row_bytes(self) -> int:
        return sum(c.itemsize for c in self.columns)


def narrow_int_dtype(lo: int, hi: int) -> np.dtype:
    """Smallest signed integer dtype that holds [lo, hi] (paper §3.6 dtype
    narrowing from metadata)."""
    for dt in _NARROW_ORDER_INT:
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int64)


def infer_schema(arrays: Mapping[str, np.ndarray],
                 dicts: Mapping[str, Sequence[str]] | None = None,
                 datetimes: Sequence[str] = ()) -> TableSchema:
    dicts = dicts or {}
    cols = []
    for name, arr in arrays.items():
        if name in dicts:
            cols.append(ColumnSchema(name, "dict", is_dict=True,
                                     dict_size=len(dicts[name])))
        elif name in datetimes:
            cols.append(ColumnSchema(name, DATETIME, is_datetime=True))
        else:
            cols.append(ColumnSchema(name, str(arr.dtype)))
    return TableSchema(tuple(cols))
