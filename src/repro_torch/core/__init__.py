# The paper's primary contribution: the Lazy Fat Pandas engine on PyTorch —
# lazy task-graph construction (graph, lazyframe), JIT static analysis
# (jit_analyze, source_analysis), DAG optimization (optimizer, liveness), lazy
# sinks (sinks, func), metadata (metadata), and pluggable string-named
# engines (engines registry + backends.eager, extensible via repro_torch.register_engine / the repro_torch.engines entry-point
# group).
from .context import (BackendEngines, default_context, get_context,
                      pop_session, push_session, session)
from .engines import (BackendCapability, create_engine, engine_names,
                      get_capability, register_engine, unregister_engine)
from .explain import ExplainReport, explain
from .lazyframe import LazyFrame, Result, from_arrays, read_npz, read_source
from .runtime import execute, flush
from .source import InMemorySource, NpzDirectorySource, encode_strings, write_npz_source
from .jit_analyze import analyze

__all__ = [
    "BackendEngines", "get_context", "default_context", "session",
    "push_session", "pop_session", "LazyFrame", "Result", "from_arrays",
    "read_npz", "read_source", "execute", "flush", "InMemorySource",
    "NpzDirectorySource", "encode_strings", "write_npz_source", "analyze",
    "register_engine", "unregister_engine", "engine_names",
    "get_capability", "create_engine", "BackendCapability",
    "explain", "ExplainReport",
]
