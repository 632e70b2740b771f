"""Live-DataFrame-driven persist planning (paper §3.5).

At a force point, frames live *after* the point (known from JIT static
analysis, or passed explicitly as ``live_df=[...]``) identify shared
subexpressions between the forced task graph and future computations; those
nodes are marked ``persist`` and cached across force points.  Cache entries
are evicted once no longer a subexpression of any live frame (paper's
last-use discard rule).
"""
from __future__ import annotations

from . import graph as G
from .context import LaFPContext


def plan_persists(roots: list[G.Node], live_nodes: list[G.Node]) -> set[int]:
    """Mark shared subexpressions: nodes that (a) define a live frame or are
    maximal shared nodes between the forced graph and a live frame's graph."""
    forced = {n.id for n in G.walk(roots)}
    persist: set[int] = set()
    for ln in live_nodes:
        live_reach = G.walk([ln])
        shared = [n for n in live_reach if n.id in forced]
        if not shared:
            continue
        shared_ids = {n.id for n in shared}
        if ln.id in forced:
            persist.add(ln.id)
            continue
        # maximal shared nodes: shared nodes none of whose parents (within the
        # live frame's graph) are shared
        pmap = G.parents_map([ln])
        for n in shared:
            ps = pmap.get(n.id, [])
            if not any(p.id in shared_ids for p in ps):
                persist.add(n.id)
    return persist


def apply_persist_marks(roots: list[G.Node], persist_ids: set[int]) -> None:
    for n in G.walk(roots):
        if n.id in persist_ids:
            n.persist = True


def evict_dead_entries(ctx: LaFPContext, live_nodes: list[G.Node]) -> int:
    """Drop cache entries that are no longer subexpressions of live frames
    (paper: 'discarded after their last use')."""
    if not ctx.persist_cache:
        return 0
    live_keys = set()
    for n in G.walk(live_nodes):
        live_keys.add(n.key())
    dead = [k for k in ctx.persist_cache if k not in live_keys]
    for k in dead:
        del ctx.persist_cache[k]
    return len(dead)
