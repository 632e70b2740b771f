"""JSON zone-map/row-count sidecars for on-disk columnar sources.

A sidecar (``_stats.json`` inside a source directory, ``<file>.stats.json``
next to a single-file source) persists everything the planner needs from a
source *without touching data*: per-partition row counts and zone maps,
the column schema, dictionary vocabularies, and datetime markers.  It is
written once at ingest; reopening the source reads the sidecar instead of
rescanning partitions.

Staleness is detected by recording each data file's ``(size, mtime_ns)``
at write time: a sidecar whose recorded file set or states no longer
match the files on disk — including a recorded file that was deleted —
is ignored (the source rebuilds stats and rewrites it).  The
sidecar file's own mtime participates in the source ``cache_token`` so a
rewritten directory — or a hand-edited sidecar — never serves stale
plan-key consumers (persist cache, stats feedback).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping, Sequence

SIDECAR_NAME = "_stats.json"
SIDECAR_VERSION = 1


def sidecar_path(base: str) -> str:
    """Sidecar location for a source rooted at ``base`` (directory or
    single data file)."""
    if os.path.isdir(base):
        return os.path.join(base, SIDECAR_NAME)
    return base + ".stats.json"


def file_state(path: str) -> list[int]:
    """``[size, mtime_ns]`` — the staleness fingerprint of one data file."""
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def sidecar_mtime_ns(base: str) -> int:
    """mtime of the sidecar file itself (0 when absent) — folded into the
    source ``cache_token`` so token consumers see sidecar rewrites."""
    try:
        return int(os.stat(sidecar_path(base)).st_mtime_ns)
    except OSError:
        return 0


def _json_safe(v):
    """Coerce numpy scalars / tuples to JSON-serializable values."""
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item) and getattr(v, "ndim", 0) == 0:
        return v.item()
    return v


def write_sidecar(base: str, partitions: Sequence[dict],
                  columns: Mapping[str, dict] | None = None,
                  dicts: Mapping[str, Sequence[str]] | None = None,
                  datetimes: Sequence[str] = (),
                  data_files: Sequence[str] | None = None,
                  ingest: Mapping[str, object] | None = None) -> dict:
    """Persist stats for a source rooted at ``base``.

    ``partitions`` — one ``{"file": name, "rows": int, "zonemap": {...}}``
    per partition (``file`` optional for row-group partitions).
    ``data_files`` — absolute paths of the data files the stats describe
    (their states are recorded for staleness checks).  ``ingest`` —
    optional upstream-file states (e.g. the CSV a cache was built from).
    Written atomically (tmp + rename).  Returns the payload.
    """
    payload = {
        "version": SIDECAR_VERSION,
        "partitions": _json_safe(list(partitions)),
        "columns": _json_safe(dict(columns or {})),
        "dicts": _json_safe({k: list(v) for k, v in (dicts or {}).items()}),
        "datetimes": list(datetimes),
        "files": {os.path.basename(f): file_state(f)
                  for f in (data_files or ())},
    }
    if ingest:
        payload["ingest"] = _json_safe(dict(ingest))
    path = sidecar_path(base)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return payload


def read_sidecar(base: str,
                 data_files: Sequence[str] | None = None) -> dict | None:
    """Load the sidecar for ``base``; ``None`` when absent, unparseable, a
    different version, or stale.  Stale means the recorded data-file set
    differs from ``data_files`` in EITHER direction — a current file not
    recorded, or a recorded file deleted from disk (whose partitions would
    reference a missing file) — or any recorded ``(size, mtime_ns)`` state
    mismatches the file on disk."""
    path = sidecar_path(base)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if payload.get("version") != SIDECAR_VERSION:
        return None
    states = payload.get("files", {})
    if data_files is not None:
        if set(states) != {os.path.basename(f) for f in data_files}:
            return None
        for f in data_files:
            try:
                if list(states[os.path.basename(f)]) != file_state(f):
                    return None
            except OSError:
                return None
    return payload


def fingerprint(payload: Mapping) -> str:
    """Content digest of a sidecar payload (part of disk-source tokens)."""
    blob = json.dumps(_json_safe(dict(payload)), sort_keys=True).encode()
    return hashlib.md5(blob).hexdigest()[:16]
