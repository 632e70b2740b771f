"""In-tree execution engines, registered with the open engine registry
(``repro_torch.core.engines``):

* eager — whole-table, device-resident tensors (the Pandas analogue)

Importing this package registers it under its string name; the planner
derives its candidate set, capabilities, cost constants, and calibration
namespaces from the registry, so out-of-tree engines added via
``repro_torch.register_engine`` (or the ``repro_torch.engines`` entry-point
group) are planned exactly like it.
"""
from __future__ import annotations

from ..engines import (ALL_OPS as _ALL_OPS, BackendCapability,
                       default_registry, normalize_engine)


class MemoryBudgetExceeded(RuntimeError):
    def __init__(self, needed: int, budget: int, where: str):
        super().__init__(
            f"memory budget exceeded at {where}: needs {needed/1e6:.1f} MB, "
            f"budget {budget/1e6:.1f} MB")
        self.needed = needed
        self.budget = budget


class MemoryMeter:
    """Deterministic memory accounting against a byte budget — reproduces
    the paper's OOM behaviour (Fig. 12) without exhausting memory."""

    def __init__(self, budget: int | None):
        self.budget = budget
        self.current = 0
        self.peak = 0

    def alloc(self, nbytes: int, where: str = "?"):
        self.current += int(nbytes)
        self.peak = max(self.peak, self.current)
        if self.budget is not None and self.current > self.budget:
            raise MemoryBudgetExceeded(self.current, self.budget, where)

    def free(self, nbytes: int):
        self.current -= int(nbytes)


# ---------------------------------------------------------------------------
# Registration.  The engine classes themselves are the factories — the
# registry filters construction options against their signatures.

from .eager import EagerBackend          # noqa: E402

_REG = default_registry()

_REG.register("eager", EagerBackend, BackendCapability(
    name="eager", native_ops=_ALL_OPS,
    startup_cost=1e3, scan_cost_per_byte=1.0, row_cost=1.0,
    parallelism=4.0, transfer_cost_per_byte=0.5, fallback_penalty=1.0,
    peak_model="resident", scan_pushdown=True),
    source="builtin", replace=True)


# ---------------------------------------------------------------------------
# Back-compat surface.  ``CAPABILITIES`` is the registry's live capability
# dict (string-keyed; ``BackendEngines`` members hash/compare equal to the
# names, so legacy enum-keyed lookups — and test monkeypatching — work
# unchanged).

CAPABILITIES = _REG.capabilities


def capabilities(kind) -> BackendCapability:
    return _REG.capability_of(kind)


def backend_class(kind):
    """Deprecated: engine factory lookup by name (kept for callers that
    expect a constructor)."""
    kind = normalize_engine(kind)
    if kind == "auto":
        _REG.create(kind)           # raises the explanatory ValueError
    return _REG.spec(kind).factory


def get_backend(kind, **options):
    return _REG.create(kind, options)
