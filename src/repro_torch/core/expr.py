"""Scalar / predicate expression trees.

Expressions are built by operator overloading on ``LazyColumn`` and evaluated
column-at-a-time on tensors (device) or numpy (host metadata path).  On
tensors, arithmetic takes numpy's result dtype (torch would turn an int
column divided by an int, or times a python float, into float32).  They carry
``used_cols()`` so the optimizer can compute ``used_attrs`` for pushdown
safety (paper §3.2) and liveness Gen sets (paper §3.1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from .physical.table import numpy_dtype, to_device_array, torch_dtype

# Binary ops usable on device arrays.
_BINOPS: dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b,
    "floordiv": lambda a, b: a // b,
    "mod": lambda a, b: a % b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
}

_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge"}
_ARITH = {"add", "sub", "mul", "truediv", "floordiv", "mod"}


def _np_operand(x):
    """What numpy's type promotion sees for one operand: the dtype of a
    tensor or array, or the python scalar itself (a weak type)."""
    if isinstance(x, torch.Tensor):
        return numpy_dtype(x.dtype)
    if isinstance(x, (np.ndarray, np.generic)):
        return x.dtype
    return x


def _binop(op: str, a, b):
    """Apply ``op``; tensor operands of arithmetic are first cast to the
    dtype numpy would give (int/int true division → float64)."""
    if op in _ARITH and (isinstance(a, torch.Tensor)
                         or isinstance(b, torch.Tensor)):
        target = np.result_type(_np_operand(a), _np_operand(b))
        if op == "truediv" and target.kind in "iub":
            target = np.dtype(np.float64)
        tdt = torch_dtype(target)
        if isinstance(a, torch.Tensor):
            a = a.to(tdt)
        if isinstance(b, torch.Tensor):
            b = b.to(tdt)
    return _BINOPS[op](a, b)

# int64-epoch-seconds datetime accessors (pandas .dt as integer arithmetic
# on the device; floor division and modulo keep pre-1970 times right).
_DT_FIELDS: dict[str, Callable] = {
    # 1970-01-01 was a Thursday; pandas dayofweek: Monday=0.
    "dayofweek": lambda ts: ((ts // 86400) + 3) % 7,
    "hour": lambda ts: (ts // 3600) % 24,
    "minute": lambda ts: (ts // 60) % 60,
    "second": lambda ts: ts % 60,
    "day": None,    # filled below (calendar math)
    "month": None,
    "year": None,
}


def _where(cond, a, b):
    """np.where or torch.where, by the condition's array type."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _civil_from_days(days):
    """Days-since-epoch -> (year, month, day), vectorized (Howard Hinnant's
    algorithm, integer-only so it runs on device)."""
    z = days + 719468
    era = _where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + _where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


_DT_FIELDS["year"] = lambda ts: _civil_from_days(ts // 86400)[0]
_DT_FIELDS["month"] = lambda ts: _civil_from_days(ts // 86400)[1]
_DT_FIELDS["day"] = lambda ts: _civil_from_days(ts // 86400)[2]
# pandas .dt.quarter: 1-4 from the calendar month
_DT_FIELDS["quarter"] = \
    lambda ts: (_civil_from_days(ts // 86400)[1] - 1) // 3 + 1


class Expr:
    """Base class. Immutable, hashable by structure."""

    def used_cols(self) -> frozenset[str]:
        raise NotImplementedError

    def evaluate(self, cols: Mapping[str, Any]):
        raise NotImplementedError

    def key(self) -> tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Expr) and self.key() == other.key()

    # -- interval arithmetic over zone maps (beyond-paper: partition pruning).
    def bounds(self, zonemaps: Mapping[str, tuple]) -> tuple | None:
        """(lo, hi) bounds of this expr given per-column (min,max); None if
        unbounded/unsupported."""
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Expr):
    name: str

    def used_cols(self):
        return frozenset([self.name])

    def evaluate(self, cols):
        return cols[self.name]

    def key(self):
        return ("col", self.name)

    def bounds(self, zonemaps):
        return zonemaps.get(self.name)


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any

    def used_cols(self):
        return frozenset()

    def evaluate(self, cols):
        return self.value

    def key(self):
        return ("lit", repr(self.value))

    def bounds(self, zonemaps):
        if isinstance(self.value, (int, float)):
            return (self.value, self.value)
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def used_cols(self):
        return self.left.used_cols() | self.right.used_cols()

    def evaluate(self, cols):
        return _binop(self.op, self.left.evaluate(cols), self.right.evaluate(cols))

    def key(self):
        return ("bin", self.op, self.left.key(), self.right.key())

    def bounds(self, zonemaps):
        lb = self.left.bounds(zonemaps)
        rb = self.right.bounds(zonemaps)
        if lb is None or rb is None:
            return None
        (llo, lhi), (rlo, rhi) = lb, rb
        if self.op == "add":
            return (llo + rlo, lhi + rhi)
        if self.op == "sub":
            return (llo - rhi, lhi - rlo)
        if self.op == "mul":
            prods = [llo * rlo, llo * rhi, lhi * rlo, lhi * rhi]
            return (min(prods), max(prods))
        return None

    def prune_partition(self, zonemaps: Mapping[str, tuple]) -> bool:
        """True if this predicate is provably all-False on a partition with
        the given per-column (min, max) zone maps → the partition can be
        skipped (beyond-paper zone-map pruning)."""
        if self.op == "and":
            for side in (self.left, self.right):
                if isinstance(side, BinOp) and side.prune_partition(zonemaps):
                    return True
            return False
        if self.op == "or":
            return (isinstance(self.left, BinOp) and isinstance(self.right, BinOp)
                    and self.left.prune_partition(zonemaps)
                    and self.right.prune_partition(zonemaps))
        if self.op not in _COMPARISONS:
            return False
        lb = self.left.bounds(zonemaps)
        rb = self.right.bounds(zonemaps)
        if lb is None or rb is None:
            return False
        (llo, lhi), (rlo, rhi) = lb, rb
        if self.op == "lt":
            return llo >= rhi          # no l < r possible
        if self.op == "le":
            return llo > rhi
        if self.op == "gt":
            return lhi <= rlo
        if self.op == "ge":
            return lhi < rlo
        if self.op == "eq":
            return lhi < rlo or llo > rhi
        return False                    # ne: rarely prunable


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Expr):
    child: Expr

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        return ~self.child.evaluate(cols)

    def key(self):
        return ("not", self.child.key())


@dataclasses.dataclass(frozen=True, eq=False)
class DtField(Expr):
    child: Expr
    field: str

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        return _DT_FIELDS[self.field](self.child.evaluate(cols))

    def key(self):
        return ("dt", self.field, self.child.key())


@dataclasses.dataclass(frozen=True, eq=False)
class Cast(Expr):
    child: Expr
    dtype: str

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        v = self.child.evaluate(cols)
        if isinstance(v, torch.Tensor):
            return v.to(torch_dtype(self.dtype))
        return v.astype(self.dtype)

    def key(self):
        return ("cast", self.dtype, self.child.key())

    def bounds(self, zonemaps):
        return self.child.bounds(zonemaps)


@dataclasses.dataclass(frozen=True, eq=False)
class Clip(Expr):
    """``Series.clip(lower, upper)`` — array-method based, so it runs on
    numpy arrays and tensors alike."""
    child: Expr
    lower: Any = None
    upper: Any = None

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        return self.child.evaluate(cols).clip(self.lower, self.upper)

    def key(self):
        return ("clip", repr(self.lower), repr(self.upper), self.child.key())

    def bounds(self, zonemaps):
        b = self.child.bounds(zonemaps)
        if b is None:
            return None
        lo, hi = b
        if self.lower is not None:
            lo, hi = max(lo, self.lower), max(hi, self.lower)
        if self.upper is not None:
            lo, hi = min(lo, self.upper), min(hi, self.upper)
        return (lo, hi)


@dataclasses.dataclass(frozen=True, eq=False)
class Round(Expr):
    """``Series.round(decimals)`` — banker's rounding, matching numpy and
    pandas ``round`` semantics."""
    child: Expr
    decimals: int = 0

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        v = self.child.evaluate(cols)
        if isinstance(v, torch.Tensor):
            if not v.dtype.is_floating_point:
                return v if self.decimals >= 0 else \
                    torch.from_numpy(v.cpu().numpy().round(self.decimals)).to(v.device)
            return torch.round(v, decimals=self.decimals)
        return v.round(self.decimals)

    def key(self):
        return ("round", self.decimals, self.child.key())

    def bounds(self, zonemaps):
        b = self.child.bounds(zonemaps)
        if b is None:
            return None
        pad = 0.5 * 10.0 ** (-self.decimals)
        return (b[0] - pad, b[1] + pad)


@dataclasses.dataclass(frozen=True, eq=False)
class IsIn(Expr):
    child: Expr
    values: tuple

    def used_cols(self):
        return self.child.used_cols()

    def evaluate(self, cols):
        arr = self.child.evaluate(cols)
        out = arr == self.values[0]
        for v in self.values[1:]:
            out = out | (arr == v)
        return out

    def key(self):
        return ("isin", self.values, self.child.key())


@dataclasses.dataclass(frozen=True, eq=False)
class UDF(Expr):
    """Opaque elementwise UDF — blocks pushdown (used_attrs unknowable ⇒ we
    conservatively report its declared inputs; mod semantics opaque)."""
    fn: Callable
    args: tuple[Expr, ...]
    name: str = "udf"
    host: bool = True       # False: fn takes tensors as they are

    def used_cols(self):
        out = frozenset()
        for a in self.args:
            out |= a.used_cols()
        return out

    def evaluate(self, cols):
        """User functions are written against numpy: tensor arguments go to
        the host, and the result comes back to their device."""
        args = [a.evaluate(cols) for a in self.args]
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      None)
        if device is None or not self.host:
            return self.fn(*args)
        host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
                for a in args]
        out = self.fn(*host)
        if np.isscalar(out) or getattr(out, "ndim", 1) == 0:
            return out
        return to_device_array(np.asarray(out), device)

    def key(self):
        return ("udf", id(self.fn)) + tuple(a.key() for a in self.args)


def conjoin(preds):
    """AND-fold a list of predicates (filter fusion, paper §3.2)."""
    out = preds[0]
    for p in preds[1:]:
        out = BinOp("and", out, p)
    return out
