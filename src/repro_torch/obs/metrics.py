"""Counters and gauges registry — one per session context.

Counters are monotonically increasing event counts (cache hits, fallback
events, calibration samples, shard exchanges); gauges are last-written
values (peak bytes).  ``Profile`` reports the counter *delta* over the
profiled block, so long-lived sessions don't leak history into a profile.

Counter glossary (what the built-in layers emit):

==============================  =============================================
``persist.hits``/``.misses``    §3.5 reuse-cache lookups (from persist_stats)
``plan_cache.hits``             force points served by the plan cache (warm
                                bind, optimize/rewrite/segment-DP skipped)
``plan_cache.misses``           cacheable plans planned cold and stored
``plan_cache.uncacheable``      plans the fingerprint refuses (UDF/MapRows,
                                sinks, materialized/handoff payloads)
``fallback.served``             facade ops served by the fallback protocol
``fallback.failed``             facade ops with no registered kernel
``calibration.runtime_samples`` (work, seconds) samples fed to StatsStore
``calibration.peak_samples``    (est, observed) peak samples fed to StatsStore
``stats.cardinalities``         observed-cardinality records after a run
``exchange.shuffles``           distributed shuffle exchanges (join/sort/…)
``exchange.shards``             shard partitions moved across those shuffles
``distributed.native_fallbacks`` sharded native paths that fell back to eager
``spans.dropped``               spans discarded by a full profile ring
``io.partitions_loaded``        source partitions actually decoded from disk
``io.partitions_pruned``        partitions skipped via zone-map/pushdown
                                pruning (never read)
``io.partitions_prefetched``    partitions decoded ahead of the consumer by
                                the async prefetcher (streaming backend)
``io.bytes_read``               decoded bytes of loaded partitions (the
                                pushdown benchmark's figure of merit)
``io.pushdown_rows_in``/
``io.pushdown_rows_out``        rows entering / surviving pushed-down
                                predicates at the scan layer
==============================  =============================================
"""
from __future__ import annotations

import threading


class MetricsRegistry:
    """Thread-safe named counters + gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        """Copy of all counters (for delta computation)."""
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    @staticmethod
    def delta(before: dict[str, int], after: dict[str, int]
              ) -> dict[str, int]:
        """Nonzero counter increments between two snapshots."""
        out = {}
        for name, value in after.items():
            d = value - before.get(name, 0)
            if d:
                out[name] = d
        return out
