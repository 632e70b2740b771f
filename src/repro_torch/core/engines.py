"""Open engine registry: the pluggable-backend core of the facade.

The paper's pitch is that the two-line facade lets the programmer *choose
the backend* per workload; PolyFrame argues dataframe scaling should be
retargetable to new engines rather than baked into one.  This module makes
that concrete: engines are **string-named** entries in a process-wide
registry, each described by a :class:`BackendCapability` the planner prices
against — so adding a fourth engine means registering it, not editing the
planner.

Three ways an engine enters the registry:

* **built-in** — ``repro_torch.core.backends`` registers the in-tree engines on
  import (the registry bootstraps that import lazily);
* **runtime** — ``repro_torch.register_engine(name, factory, capability)`` from
  any code, e.g. a notebook or a test;
* **entry points** — installed distributions exposing the
  ``repro_torch.engines`` entry-point group are loaded on first registry use;
  each entry point must resolve to a zero-argument callable that performs
  its own ``register_engine`` call.

The ``Engine`` runtime protocol is intentionally small:

* ``name`` — the registry key, also the stats-store / calibration
  namespace (``StatsStore.record_runtime(name, ...)``);
* ``execute(roots, ctx)`` — evaluate a list of ``graph.Node`` roots to
  ``{node_id: value}`` host values (tables are ``dict[str, ndarray]``);
* ``execute(roots, ctx, keep_sharded=...)`` — only for engines that set
  ``supports_device_handoff = True`` (capability flag
  ``keeps_device_payloads``): roots named in ``keep_sharded`` may stay
  device-resident and flow to the next same-engine segment through
  ``graph.Handoff`` without a host round-trip.

``"auto"`` is a reserved name: it is resolved by the cost-based planner,
never constructed.
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import warnings
from typing import Any, Callable, Protocol, runtime_checkable

AUTO = "auto"

# every operator the task graph can contain; engines declare the subset
# they run natively (the rest is priced via the fallback penalty)
ALL_OPS = frozenset({
    "scan", "materialized", "filter", "project", "assign", "rename",
    "astype", "fillna", "fused_rowwise", "sort_values", "drop_duplicates",
    "head", "top_k", "map_rows", "groupby_agg", "join", "concat", "reduce",
    "length", "sink_print",
})


@dataclasses.dataclass(frozen=True)
class BackendCapability:
    """Planner-facing self-description of one engine.

    ``peak_model`` names the peak-memory model the cost layer applies:

    * ``"resident"`` — whole-table execution; peak follows a refcounted
      topological walk of estimated output sizes.
    * ``"chunked"``  — partition-at-a-time execution; peak is chunk-sized
      flow plus pipeline-breaker state.
    * ``"sharded"``  — resident peak divided across ``shard_count()``
      shards while every operator is native and no host-materialized
      boundary forces a single-host gather.
    """
    name: str
    native_ops: frozenset               # ops with a first-class implementation
    startup_cost: float                 # fixed per-force-point dispatch cost
    scan_cost_per_byte: float           # reading source bytes
    row_cost: float                     # per-row per-operator compute
    parallelism: float                  # effective divisor on row work
    transfer_cost_per_byte: float       # host<->device / gather movement
    fallback_penalty: float             # multiplier for non-native ops
    peak_model: str = "resident"        # "resident" | "chunked" | "sharded"
    # joins are costed by *build side*: builds at or below this many bytes
    # replicate cheaply (broadcast-hash); larger builds pay an all-to-all
    # shuffle of both sides.  0.0 → the engine has no exchange-based join.
    broadcast_join_bytes: float = 0.0
    # True → the engine can hand ``Handoff`` payloads to a same-engine
    # consumer segment device-resident (no host gather at the boundary)
    keeps_device_payloads: bool = False
    # True → the engine executes ``Scan.pushdown`` (pushed-down filter
    # conjuncts evaluated at load time — e.g. via the shared
    # ``repro_torch.io.scan`` loader).  The optimizer only sinks predicates into
    # scans when every engine the plan could land on declares this;
    # engines that ignore the attribute would silently drop the filter.
    scan_pushdown: bool = False
    # shard count used by the "sharded" peak model (None → 1)
    shard_count: Callable[[], int] | None = None

    @property
    def streams_partitions(self) -> bool:
        """Deprecated alias for ``peak_model == "chunked"``."""
        return self.peak_model == "chunked"


@runtime_checkable
class Engine(Protocol):
    """Runtime protocol every registered engine factory must produce."""

    name: str

    def execute(self, roots: list, ctx) -> dict[int, Any]:
        ...


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    factory: Callable[..., Any]         # class or callable returning an Engine
    capability: BackendCapability
    source: str = "registered"          # "builtin" | "registered" | "entry-point"


class UnknownEngineError(ValueError):
    pass


def normalize_engine(value, *, warn_enum: bool = False) -> str | None:
    """Engine argument → canonical string name.

    Accepts plain strings (the redesigned API) and, as a deprecated alias
    layer, ``BackendEngines`` members (a ``str``-mixin enum whose ``value``
    is the engine name)."""
    if value is None:
        return None
    import enum
    if isinstance(value, enum.Enum):
        if warn_enum:
            warnings.warn(
                "BackendEngines members are deprecated; pass engine name "
                f"strings instead (engine={value.value!r})",
                DeprecationWarning, stacklevel=3)
        value = value.value
    if not isinstance(value, str):
        raise TypeError(
            "engine must be a string name (or a deprecated BackendEngines "
            f"member), got {value!r}")
    return value.lower()


class EngineRegistry:
    """Process-wide registry of named engines.

    ``capabilities`` is a live, string-keyed dict — the planner reads it on
    every pricing call, so tests may patch entries in place."""

    def __init__(self):
        self._specs: dict[str, EngineSpec] = {}
        self.capabilities: dict[str, BackendCapability] = {}
        self._lock = threading.RLock()
        self._bootstrapped = False
        self._bootstrapping = False
        self._entry_points_loaded = False
        self._loading_entry_points = False

    # -- population ---------------------------------------------------------

    def register(self, name: str, factory: Callable[..., Any],
                 capability: BackendCapability, *,
                 source: str = "registered", replace: bool = False) -> EngineSpec:
        name = normalize_engine(name)
        if name == AUTO:
            raise ValueError(
                f"{AUTO!r} is reserved for the cost-based planner")
        if capability.name != name:
            capability = dataclasses.replace(capability, name=name)
        if self._loading_entry_points and source == "registered":
            source = "entry-point"
        with self._lock:
            if name in self._specs and not replace:
                raise ValueError(
                    f"engine {name!r} is already registered "
                    "(pass replace=True to override)")
            spec = EngineSpec(name, factory, capability, source)
            self._specs[name] = spec
            self.capabilities[name] = capability
            return spec

    def unregister(self, name: str) -> None:
        name = normalize_engine(name)
        with self._lock:
            self._specs.pop(name, None)
            self.capabilities.pop(name, None)

    def _bootstrap(self) -> None:
        if self._bootstrapped:
            return
        with self._lock:
            # flag flips only AFTER the import completes: a second thread
            # must block on the lock until the built-ins exist, not sail
            # through the fast path into an empty registry.  The separate
            # in-progress flag breaks same-thread re-entrancy (the backends
            # import can call back into the registry under this RLock).
            if self._bootstrapped or self._bootstrapping:
                return
            self._bootstrapping = True
            try:
                import repro_torch.core.backends  # noqa: F401 — registers built-ins
                self.load_entry_points()
            finally:
                self._bootstrapping = False
            self._bootstrapped = True

    def load_entry_points(self) -> None:
        """Discover installed plug-in engines (``repro_torch.engines`` group).
        Each entry point resolves to a zero-arg callable that registers
        itself.  A broken plug-in warns; it never breaks the host."""
        if self._entry_points_loaded:
            return
        self._entry_points_loaded = True
        try:
            from importlib.metadata import entry_points
            eps = entry_points()
            group = (eps.select(group="repro_torch.engines")
                     if hasattr(eps, "select")
                     else eps.get("repro_torch.engines", []))
        except Exception:  # noqa: BLE001 — discovery is best-effort
            return
        self._loading_entry_points = True
        try:
            for ep in group:
                try:
                    hook = ep.load()
                    if callable(hook):
                        hook()
                except Exception as e:  # noqa: BLE001 — plug-in bug, not ours
                    warnings.warn(
                        f"failed to load engine plug-in {ep.name!r}: "
                        f"{type(e).__name__}: {e}", RuntimeWarning)
        finally:
            self._loading_entry_points = False

    # -- lookup -------------------------------------------------------------

    def names(self) -> tuple[str, ...]:
        self._bootstrap()
        return tuple(self._specs)

    def spec(self, name) -> EngineSpec:
        self._bootstrap()
        name = normalize_engine(name)
        try:
            return self._specs[name]
        except KeyError:
            raise UnknownEngineError(
                f"unknown engine {name!r}; registered engines: "
                f"{list(self._specs)}") from None

    def capability_of(self, name) -> BackendCapability:
        self._bootstrap()
        name = normalize_engine(name)
        try:
            return self.capabilities[name]
        except KeyError:
            raise UnknownEngineError(
                f"unknown engine {name!r}; registered engines: "
                f"{list(self.capabilities)}") from None

    def create(self, name, options: dict | None = None):
        """Instantiate an engine, passing only the options its factory
        accepts (session ``backend_options`` mix per-engine knobs with
        planner-level ones — a factory must neither crash on foreign keys
        nor lose its own)."""
        name = normalize_engine(name)
        if name == AUTO:
            raise ValueError(
                f"{AUTO!r} is resolved by the planner at force points "
                "(repro_torch.core.planner.select.plan_placement); it is not a "
                "physical engine")
        spec = self.spec(name)
        factory = spec.factory
        options = options or {}
        if not options:
            return factory()
        target = factory.__init__ if inspect.isclass(factory) else factory
        try:
            params = inspect.signature(target).parameters
        except (TypeError, ValueError):      # C callables without signatures
            return factory()
        if any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
            return factory(**options)
        return factory(**{k: v for k, v in options.items() if k in params})


_REGISTRY = EngineRegistry()


def default_registry() -> EngineRegistry:
    return _REGISTRY


# -- module-level convenience API (re-exported as ``repro_torch.register_engine``
# and from ``repro_torch.pandas``) -------------------------------------------------


def register_engine(name: str, factory: Callable[..., Any],
                    capability: BackendCapability, *,
                    replace: bool = False) -> EngineSpec:
    """Register a new execution engine under ``name``.

        repro_torch.register_engine(
            "pool", PoolEngine,
            BackendCapability(name="pool", native_ops=..., ...))

    After registration the engine is addressable everywhere an engine name
    is accepted — ``pd.session(engine="pool")``, ``pd.BACKEND_ENGINE =
    "pool"`` — and it becomes an AUTO candidate priced (and runtime-
    calibrated) like the built-ins."""
    return _REGISTRY.register(name, factory, capability, replace=replace)


def unregister_engine(name: str) -> None:
    _REGISTRY.unregister(name)


def engine_names() -> tuple[str, ...]:
    """Registered engine names, in registration order."""
    return _REGISTRY.names()


def get_capability(name) -> BackendCapability:
    return _REGISTRY.capability_of(name)


def create_engine(name, options: dict | None = None):
    return _REGISTRY.create(name, options)
