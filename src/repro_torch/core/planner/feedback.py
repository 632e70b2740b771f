"""Feedback loop: record actual cardinalities after execution and feed them
back into estimation (the paper's "runtime optimization" leg).

Observations are keyed by each node's *structural* key, so a re-built plan
with the same shape (the common case for scripted/repeated workloads) hits
the store even though node ids differ.  ``estimate_plan`` consults the
store and overrides a-priori estimates with observed row counts.

The store is JSON-persistable (``save``/``load``): cardinalities are keyed
by the ``repr`` of the structural key — deterministic across processes for
disk-backed sources (``Source.cache_token``) — and runtime/peak calibration
samples are keyed by backend name, so AUTO calibration survives restarts
(``LaFPContext.stats_path`` / ``REPRO_STATS_CACHE_DIR``).

Persistence is **process-safe**: ``save`` appends only the *delta* recorded
since the last flush as one JSON line to ``<path>.log`` under an ``fcntl``
file lock (``<path>.lock``), and compacts base + log into a fresh base file
(atomic ``os.replace``) when the log grows — so concurrent sessions and
processes sharing one stats path interleave appends instead of overwriting
each other, and a reader never sees a torn file.  In-memory mutation is
lock-guarded for multi-threaded serving.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from typing import Any

from .. import graph as G

try:
    import fcntl
    _HAVE_FLOCK = True
except ImportError:                      # non-POSIX: best-effort, no lock
    _HAVE_FLOCK = False

# compact <path>.log into the base file once it passes this size
_COMPACT_LOG_BYTES = 1 << 18


@contextlib.contextmanager
def _file_lock(lock_path: str, shared: bool = False):
    """Advisory inter-process lock (``flock``).  Writers take it exclusive
    (append + compaction are serialized); readers take it shared (a read
    never overlaps a compaction's replace/truncate pair)."""
    if not _HAVE_FLOCK:
        yield None
        return
    f = open(lock_path, "a+")
    try:
        fcntl.flock(f, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        yield f
    finally:
        fcntl.flock(f, fcntl.LOCK_UN)
        f.close()


# a backend's cost scale is trusted only after this many observed runs —
# a single noisy measurement must not flip placement
MIN_RUNTIME_SAMPLES = 3
_MAX_RUNTIME_SAMPLES = 64
# same floor for peak-estimate calibration (observed vs estimated peaks)
MIN_PEAK_SAMPLES = MIN_RUNTIME_SAMPLES
_MAX_PEAK_SAMPLES = 64


def _least_squares_scale(samples) -> float | None:
    """Regression through the origin: observed = scale * estimated."""
    num = sum(e * o for e, o in samples)
    den = sum(e * e for e, _o in samples)
    if den <= 0 or num <= 0:
        return None
    return num / den


class StatsStore:
    """Bounded store of observed per-node cardinalities, backend peaks, and
    per-backend (estimated, observed) samples used to calibrate the cost
    model's ``BackendCapability`` constants — both *work* (estimated work →
    wall seconds) and *peak* (estimated peak bytes → metered peak bytes)."""

    def __init__(self, max_entries: int = 4096):
        # keyed by repr(structural key): deterministic, JSON-serializable,
        # and stable across processes for path-token sources
        self.observed: dict[str, dict[str, float]] = {}
        self.backend_peaks: dict[str, int] = {}
        self.runtime_samples: dict[str, list[tuple[float, float]]] = {}
        self.peak_samples: dict[str, list[tuple[float, float]]] = {}
        self.max_entries = max_entries
        # concurrency: mutation and aggregate reads are lock-guarded so
        # multi-threaded sessions sharing a store (serving) never tear it
        self._lock = threading.RLock()
        # delta recorded since the last save() — what gets appended to the
        # on-disk log.  Data merged *from* disk (load) must not re-enter
        # the pending delta or every process would re-append what it read.
        self._pending = _empty_delta()
        self._suspend_pending = False

    @staticmethod
    def _k(key) -> str:
        return key if isinstance(key, str) else repr(key)

    def record(self, key, rows: int, nbytes: int) -> None:
        k = self._k(key)
        with self._lock:
            if (len(self.observed) >= self.max_entries
                    and k not in self.observed):
                # drop the oldest insertion (dict preserves order)
                self.observed.pop(next(iter(self.observed)))
            entry = {"rows": float(rows), "nbytes": float(nbytes)}
            self.observed[k] = entry
            if not self._suspend_pending:
                self._pending["observed"][k] = dict(entry)

    def lookup(self, key) -> dict[str, float] | None:
        return self.observed.get(self._k(key))

    def record_peak(self, backend: str, peak_bytes: int,
                    est_peak: float | None = None) -> None:
        """One observed peak.  With ``est_peak`` (the cost model's a-priori
        estimate for the same run) it also becomes a calibration sample."""
        with self._lock:
            self.backend_peaks[backend] = max(
                self.backend_peaks.get(backend, 0), int(peak_bytes))
            if not self._suspend_pending:
                self._pending["backend_peaks"][backend] = \
                    self.backend_peaks[backend]
            if est_peak is not None and est_peak > 0 and peak_bytes > 0:
                samples = self.peak_samples.setdefault(backend, [])
                samples.append((float(est_peak), float(peak_bytes)))
                if len(samples) > _MAX_PEAK_SAMPLES:
                    del samples[0]
                if not self._suspend_pending:
                    self._pending["peak_samples"].setdefault(
                        backend, []).append([float(est_peak),
                                             float(peak_bytes)])

    # -- runtime calibration (measured, not guessed, cost constants) --------

    def record_runtime(self, backend: str, est_work: float,
                       seconds: float) -> None:
        """One observed execution: the plan's estimated (uncalibrated) work
        on ``backend`` and the wall seconds it actually took."""
        if est_work <= 0 or seconds < 0:
            return
        with self._lock:
            samples = self.runtime_samples.setdefault(backend, [])
            samples.append((float(est_work), float(seconds)))
            if len(samples) > _MAX_RUNTIME_SAMPLES:
                del samples[0]
            if not self._suspend_pending:
                self._pending["runtime_samples"].setdefault(
                    backend, []).append([float(est_work), float(seconds)])

    def cost_scale(self, backend: str) -> float | None:
        """Calibrated seconds-per-work-unit for ``backend``: least-squares
        regression through the origin over the recorded (work, seconds)
        samples.  None until ``MIN_RUNTIME_SAMPLES`` runs were observed."""
        with self._lock:
            samples = self.runtime_samples.get(backend, ())
            if len(samples) < MIN_RUNTIME_SAMPLES:
                return None
            return _least_squares_scale(samples)

    def calibration(self) -> dict[str, float]:
        """All backends with a trusted calibrated scale."""
        out = {}
        with self._lock:
            for backend in tuple(self.runtime_samples):
                scale = self.cost_scale(backend)
                if scale is not None:
                    out[backend] = scale
        return out

    # -- peak calibration (observed peaks recalibrate peak estimates) -------

    def peak_scale(self, backend: str) -> float | None:
        """Calibrated observed-per-estimated-peak ratio, regressed the same
        way runtimes calibrate work constants.  None until
        ``MIN_PEAK_SAMPLES`` metered runs were observed."""
        with self._lock:
            samples = self.peak_samples.get(backend, ())
            if len(samples) < MIN_PEAK_SAMPLES:
                return None
            return _least_squares_scale(samples)

    def peak_calibration(self) -> dict[str, float]:
        out = {}
        with self._lock:
            for backend in tuple(self.peak_samples):
                scale = self.peak_scale(backend)
                if scale is not None:
                    out[backend] = scale
        return out

    def __len__(self):
        return len(self.observed)

    # -- persistence (AUTO calibration survives process restarts) -----------

    def to_json(self) -> dict:
        with self._lock:
            return {
                "observed": {k: dict(v) for k, v in self.observed.items()},
                "backend_peaks": dict(self.backend_peaks),
                "runtime_samples": {
                    b: [list(s) for s in ss]
                    for b, ss in self.runtime_samples.items()},
                "peak_samples": {
                    b: [list(s) for s in ss]
                    for b, ss in self.peak_samples.items()},
            }

    def merge_json(self, data: dict) -> None:
        for k, v in data.get("observed", {}).items():
            self.record(k, v.get("rows", 0.0), v.get("nbytes", 0.0))
        for b, p in data.get("backend_peaks", {}).items():
            with self._lock:
                self.backend_peaks[b] = max(self.backend_peaks.get(b, 0),
                                            int(p))
        for b, ss in data.get("runtime_samples", {}).items():
            for est, sec in ss:
                self.record_runtime(b, est, sec)
        for b, ss in data.get("peak_samples", {}).items():
            for est, obs in ss:
                self.record_peak(b, obs, est_peak=est)

    def _take_pending(self) -> dict | None:
        with self._lock:
            if not any(self._pending.values()):
                return None
            delta, self._pending = self._pending, _empty_delta()
            return delta

    def _requeue(self, delta: dict) -> None:
        """Put an unflushed delta back (save failed) so the next save
        retries it instead of silently dropping it from disk."""
        with self._lock:
            self._pending["observed"] = {**delta["observed"],
                                         **self._pending["observed"]}
            for b, p in delta["backend_peaks"].items():
                cur = self._pending["backend_peaks"].get(b, 0)
                self._pending["backend_peaks"][b] = max(cur, p)
            for field in ("runtime_samples", "peak_samples"):
                for b, ss in delta[field].items():
                    self._pending[field][b] = \
                        ss + self._pending[field].get(b, [])

    def save(self, path: str) -> None:
        """Append the delta since the last save as one JSON line to
        ``<path>.log`` under the file lock; compact into the base file when
        the log grows.  Best-effort (a read-only cache dir never breaks
        execution)."""
        delta = self._take_pending()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            log = path + ".log"
            with _file_lock(path + ".lock"):
                if delta is not None:
                    with open(log, "a") as f:
                        f.write(json.dumps(delta) + "\n")
                    delta = None
                try:
                    log_size = os.path.getsize(log)
                except OSError:
                    log_size = 0
                if log_size > _COMPACT_LOG_BYTES or not os.path.exists(path):
                    _compact_locked(path, self.max_entries)
        except OSError:
            if delta is not None:
                self._requeue(delta)

    def compact(self, path: str) -> None:
        """Merge base + append-log into a fresh base file (atomic replace)
        and truncate the log, under the exclusive file lock."""
        try:
            with _file_lock(path + ".lock"):
                _compact_locked(path, self.max_entries)
        except OSError:
            pass

    def load(self, path: str) -> bool:
        """Merge the persisted base file plus any not-yet-compacted log
        lines.  Takes the file lock shared, so a load never observes a
        compaction's replace/truncate mid-flight.  Loaded data does not
        re-enter the pending delta (it is already on disk)."""
        found = False
        try:
            with _file_lock(path + ".lock", shared=True):
                with self._lock:
                    self._suspend_pending = True
                    try:
                        try:
                            with open(path) as f:
                                self.merge_json(json.load(f))
                            found = True
                        except (OSError, ValueError):
                            pass
                        try:
                            with open(path + ".log") as f:
                                for line in f:
                                    line = line.strip()
                                    if not line:
                                        continue
                                    try:
                                        self.merge_json(json.loads(line))
                                    except ValueError:
                                        continue  # torn tail (lockless writer)
                                    found = True
                        except OSError:
                            pass
                    finally:
                        self._suspend_pending = False
        except OSError:
            return False
        return found


def _empty_delta() -> dict:
    return {"observed": {}, "backend_peaks": {},
            "runtime_samples": {}, "peak_samples": {}}


def _compact_locked(path: str, max_entries: int) -> None:
    """Merge base + log → fresh base (atomic replace), truncate log.
    Caller holds the exclusive file lock."""
    merged = StatsStore(max_entries=max_entries)
    merged._suspend_pending = True
    try:
        with open(path) as f:
            merged.merge_json(json.load(f))
    except (OSError, ValueError):
        pass
    log = path + ".log"
    try:
        with open(log) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    merged.merge_json(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".stats-", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(merged.to_json(), f)
    os.replace(tmp, path)
    with open(log, "w"):
        pass


def _rows_nbytes(value: Any) -> tuple[int, int] | None:
    """(rows, nbytes) of a materialized table value; None for scalars."""
    gather = getattr(value, "rows", None)
    if callable(gather) and hasattr(value, "valid"):     # ShardedTable
        return value.rows(), value.nbytes()
    if not isinstance(value, dict):
        return None
    rows = 0
    nbytes = 0
    for v in value.values():
        shape = getattr(v, "shape", None)
        if shape:
            rows = int(shape[0])
        nbytes += int(getattr(v, "nbytes", 0))
    return rows, nbytes


def record_execution(roots: list[G.Node], results: dict[int, Any],
                     ctx, backend_name: str | None = None) -> int:
    """Write actual cardinalities of materialized results (and any persisted
    intermediates) into ``ctx.stats_store``.  Returns entries recorded."""
    store = getattr(ctx, "stats_store", None)
    if store is None:
        return 0
    recorded = 0
    for n in G.walk(roots):
        val = results.get(n.id)
        if val is None and n.persist:
            key = getattr(n, "cache_key", None) or n.key()
            val = ctx.persist_cache.get(key)
        if val is None:
            continue
        rn = _rows_nbytes(val)
        if rn is None:
            continue
        if isinstance(n, (G.SinkPrint, G.Materialized, G.Handoff)):
            continue
        store.record(n.key(), rn[0], rn[1])
        recorded += 1
    if recorded:
        metrics = getattr(ctx, "metrics", None)
        if metrics is not None:
            metrics.inc("stats.cardinalities", recorded)
    # engines that meter their own peak (MemoryMeter, device-buffer
    # accounting) announce it via ctx.last_run_peak_engine — record *this
    # run's* peak under that engine's namespace (the session-cumulative
    # ctx.last_peak_bytes may belong to a different engine's earlier run)
    peak_engine = getattr(ctx, "last_run_peak_engine", None)
    run_peak = getattr(ctx, "last_run_peak_bytes", 0)
    if peak_engine and run_peak and backend_name \
            and peak_engine in str(backend_name).split("+"):
        store.record_peak(peak_engine, run_peak)
    return recorded
