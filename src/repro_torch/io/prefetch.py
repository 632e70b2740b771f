"""Bounded async partition prefetcher.

``prefetch_iter`` runs a loader on a background thread, keeping at most
``depth`` decoded partitions in flight, so partition decode (disk read,
parquet decompression, dict-code mapping) overlaps with downstream
compute.  It is the IO half of the streaming backend's
partition-at-a-time pipeline; the compute half pulls from the queue.

The consumer contract matches plain generators, including the abandoned
case: the streaming ``Head`` operator early-exits its upstream generators
(``GeneratorExit``), so ``close()`` must stop a worker that may be blocked
on a full queue — the worker uses timed puts and re-checks a stop event,
and the generator's ``finally`` drains the queue and joins the thread.
Loader exceptions are re-raised in the consumer at the failing partition's
position in the stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

_DONE = object()


def prefetch_iter(indices: Sequence[int], load: Callable[[int], object],
                  depth: int = 2,
                  on_prefetch: Callable[[int], None] | None = None
                  ) -> Iterator[object]:
    """Yield ``load(i)`` for each ``i`` in order, loading up to ``depth``
    items ahead on a background thread.

    ``on_prefetch(i)`` (if given) fires on the worker thread only for
    partitions whose decode completed *before the consumer requested
    them* — i.e. genuinely decoded ahead of the consumer, not merely
    routed through the prefetch thread — the hook for
    ``io.partitions_prefetched`` accounting.  A partition the consumer is
    already blocked waiting for is demand-loaded, not prefetched.  Falls
    back to plain sequential loading when ``depth`` < 1 or there is ≤ 1
    item (nothing to overlap)."""
    indices = list(indices)
    if depth < 1 or len(indices) <= 1:
        for i in indices:
            yield load(i)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    # number of q.get() calls the consumer has started; the k-th item was
    # decoded ahead of the consumer iff the consumer had not yet begun its
    # (k+1)-th get when the decode finished (int-in-list: GIL-atomic)
    requested = [0]

    def worker():
        try:
            for k, i in enumerate(indices):
                if stop.is_set():
                    return
                try:
                    item = (i, load(i), None)
                    if on_prefetch is not None and requested[0] <= k:
                        on_prefetch(i)
                except BaseException as exc:  # noqa: BLE001 — re-raised consumer-side
                    item = (i, None, exc)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if item[2] is not None:
                    return
        finally:
            while not stop.is_set():
                try:
                    q.put(_DONE, timeout=0.05)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, name="repro_torch-io-prefetch", daemon=True)
    t.start()
    try:
        while True:
            requested[0] += 1
            item = q.get()
            if item is _DONE:
                return
            _, value, exc = item
            if exc is not None:
                raise exc
            yield value
    finally:
        stop.set()
        while True:                      # unblock a worker stuck on put()
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
