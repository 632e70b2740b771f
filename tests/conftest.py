import numpy as np
import pytest

from repro.core.context import LaFPContext, pop_session, push_session


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's hand-written kernels); "
        "skips where torch finds none")


@pytest.fixture(autouse=True)
def fresh_context():
    """Each test runs inside its own pushed session — the one place test
    isolation happens (no scattered get_context().reset() calls).  The
    process-global plan cache is cleared for the same reason: a warm hit
    from another test's same-shaped plan would skip the optimization a
    test means to observe."""
    from repro.core.planner.plancache import default_plan_cache
    default_plan_cache().clear()
    ctx = push_session(LaFPContext(name="test"))
    yield ctx
    pop_session()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_taxi_arrays(rng, n=20_000):
    """Taxi-like frame used across tests (paper's running example)."""
    return {
        "fare_amount": rng.uniform(-5, 100, n),
        "passenger_count": rng.integers(0, 7, n).astype(np.int64),
        "pickup_datetime": rng.integers(1_600_000_000, 1_610_000_000, n),
        "trip_miles": rng.uniform(0, 30, n),
        "unused_a": rng.uniform(0, 1, n),
        "unused_b": rng.integers(0, 9, n).astype(np.int64),
    }


@pytest.fixture
def taxi_arrays(rng):
    return make_taxi_arrays(rng)
