"""repro_torch — Lazy Fat Pandas reproduction.

Top-level convenience surface for the open engine registry: out-of-tree
execution engines register here and become first-class planner citizens
(AUTO candidates, calibrated, explainable) without any core edits:

    import repro_torch
    repro_torch.register_engine("pool", PoolEngine, capability)

Installed distributions can instead expose a ``repro_torch.engines`` entry point
(a zero-argument callable performing the registration) and are discovered
automatically on first engine lookup.
"""
from repro_torch.core.engines import (AUTO, BackendCapability, Engine, EngineSpec,
                                create_engine, default_registry,
                                engine_names, get_capability,
                                register_engine, unregister_engine)

__all__ = [
    "AUTO", "BackendCapability", "Engine", "EngineSpec",
    "register_engine", "unregister_engine", "engine_names",
    "get_capability", "create_engine", "default_registry",
]
