"""lazyfatpandas.func analogue (paper §3.3): lazy print / lazy len / flush.

``from repro_torch.core.func import print`` shadows the builtin with the lazy
version; non-lazy arguments pass straight through to the real print at flush
time, in program order.
"""
from __future__ import annotations

import builtins

from .context import get_context
from .runtime import flush as _flush
from .sinks import make_print

_builtin_print = builtins.print
_builtin_len = builtins.len


def print(*args, **kwargs):  # noqa: A001 — deliberate shadow
    """Lazy print: adds a sink node to the task graph (ordering edge keeps
    output order); computation is deferred until a force point or flush()."""
    make_print(args, get_context())
    return None


def len(obj):  # noqa: A001
    from . import graph as G
    from .lazyframe import LazyFrame, LazyScalar
    if isinstance(obj, LazyFrame):
        return LazyScalar(G.Length(obj._node))
    return _builtin_len(obj)


def flush():
    """Force all pending lazy sinks (pd.flush(), inserted automatically at
    program end by the paper's rewriter; we expose it and also flush at
    interpreter exit)."""
    _flush()


# auto-flush at interpreter exit so user programs don't lose output
import atexit  # noqa: E402

atexit.register(_flush)
