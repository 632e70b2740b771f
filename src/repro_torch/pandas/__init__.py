"""`repro_torch.pandas` — the canonical drop-in facade (paper Fig. 2).

A plain-pandas program needs exactly two changed lines:

    import repro_torch.pandas as pd     # ① the import swap
    pd.analyze()                  # ② JIT static analysis

Everything else is pandas-shaped: ``pd.DataFrame`` / ``pd.Series`` /
``pd.read_csv`` / ``pd.concat`` / ``pd.merge`` / ``pd.to_datetime`` /
``pd.isna``, DataFrame methods, ``.dt`` / ``.str`` accessors, groupby.
``analyze()`` additionally rebinds ``print``/``len`` in a ``__main__``
script to their lazy sink-building versions (the paper's program rewrite),
so deferred output needs no third import.

Ops the lazy layer lacks are served by the **measured fallback protocol**
(see `repro_torch.pandas.fallback`): inputs materialize, a numpy-level kernel
runs eagerly, the result re-wraps as a lazy source, and the event lands in
``get_context().fallback_trace``.

Engines are **string-named** and pluggable (``repro_torch.core.engines``):

    pd.BACKEND_ENGINE = "streaming"                   # round-trips
    with pd.session(engine="auto", memory_budget=2**28,
                    engines=("eager", "streaming")):  # AUTO allow-list
        ...isolated planner/persist/sink/stats state...
    pd.register_engine("pool", PoolEngine, capability)  # out-of-tree engine
    print(pd.explain())           # typed report: segments, candidates,
                                  # handoffs, fallbacks, calibration

``BackendEngines`` remains as a deprecated ``str``-mixin enum alias layer
(members compare equal to the plain names).
"""
from __future__ import annotations

import sys
import types

from repro_torch.core.context import (BackendEngines, LaFPContext, default_context,
                                get_context, pop_session, push_session,
                                session)
from repro_torch.core.engines import (BackendCapability, create_engine,
                                engine_names, get_capability,
                                normalize_engine, register_engine,
                                unregister_engine)
from repro_torch.core.explain import ExplainReport, explain
from repro_torch.core.lazyframe import LazyColumn, LazyFrame, Result
from repro_torch.core.jit_analyze import analyze
from repro_torch.core.runtime import flush
from repro_torch.obs import Profile, profile

from .api import DataFrame, Series, concat, isna, merge, notna, to_datetime
from .fallback import FallbackEvent, record_fallback
from .io import from_arrays, read_csv, read_npz, read_parquet, read_source

__all__ = [
    "analyze", "flush", "session", "get_context", "default_context",
    "push_session", "pop_session", "LaFPContext",
    "DataFrame", "Series", "LazyFrame", "LazyColumn", "Result",
    "read_csv", "read_npz", "read_parquet", "read_source", "from_arrays",
    "concat", "merge", "to_datetime", "isna", "notna",
    "BackendEngines", "BACKEND_ENGINE", "set_backend",
    "register_engine", "unregister_engine", "engine_names",
    "get_capability", "create_engine", "BackendCapability",
    "explain", "ExplainReport",
    "FallbackEvent", "record_fallback",
    "profile", "Profile",
]


def set_backend(engine, **options):
    """Switch the current session's engine by name (``"eager"``,
    ``"streaming"``, ``"distributed"``, ``"auto"``, or any registered
    plug-in engine); extra options flow into ``ctx.backend_options``."""
    ctx = get_context()
    ctx.backend = normalize_engine(engine, warn_enum=True)
    ctx.backend_options.update(options)


class _FacadeModule(types.ModuleType):
    """Module subclass making ``pd.BACKEND_ENGINE`` a *live* property: reads
    and writes go to the current session's context, so plain attribute
    assignment (the paper's §2.6 one-liner) actually switches the engine —
    fixing the seed bug where assignment shadowed the module ``__getattr__``
    and silently did nothing.  Accepts string engine names (the redesigned
    API) and, as a deprecated alias, ``BackendEngines`` members; unknown
    names raise with the list of registered engines."""

    @property
    def BACKEND_ENGINE(self) -> str:
        return get_context().backend

    @BACKEND_ENGINE.setter
    def BACKEND_ENGINE(self, value):
        # TypeError on non-str junk; DeprecationWarning on enum members
        name = normalize_engine(value, warn_enum=True)
        if name != "auto":
            get_capability(name)                # ValueError on unknown names
        get_context().backend = name


sys.modules[__name__].__class__ = _FacadeModule
