"""Lazy print (paper §3.3).

``repro_torch.core.func.print`` builds a SinkPrint node instead of printing.  Parts
are either literal strings (possibly containing the f-string escape marker
``\\x00LAFP:<node_id>\\x00`` produced by ``LazyScalar.__format__``) or direct
frame/scalar references.  An ordering edge to the previous sink preserves
output order; execution renders parts, substituting computed values.
"""
from __future__ import annotations

import re
from typing import Any

from . import graph as G
from .context import LaFPContext, get_context

_ESC_RE = re.compile("\x00LAFP:(\\d+)\x00")


def make_print(args: tuple, ctx: LaFPContext | None = None) -> G.SinkPrint:
    """Build a lazy print node from print() args."""
    from .lazyframe import LazyColumn, LazyFrame, LazyScalar
    ctx = ctx or get_context()
    parts: list[Any] = []
    data_inputs: list[G.Node] = []

    def add_node(node: G.Node):
        parts.append(("node", len(data_inputs)))
        data_inputs.append(node)

    for a in args:
        if isinstance(a, LazyFrame):
            add_node(a._node)
        elif isinstance(a, LazyColumn):
            bound = a.frame._node_for_expr_column(a.expr)
            add_node(G.Project(bound._inner, [bound._col_name]))
        elif isinstance(a, LazyScalar):
            add_node(a.node)
        elif isinstance(a, str):
            # resolve f-string escapes to node references
            pieces: list[Any] = []
            pos = 0
            for m in _ESC_RE.finditer(a):
                if m.start() > pos:
                    pieces.append(("str", a[pos:m.start()]))
                node = ctx.scalar_registry.get(int(m.group(1)))
                if node is None:
                    pieces.append(("str", "<stale-lazy-ref>"))
                else:
                    pieces.append(("node", len(data_inputs)))
                    data_inputs.append(node)
                pos = m.end()
            if pos < len(a):
                pieces.append(("str", a[pos:]))
            parts.extend(pieces)
        else:
            parts.append(("str", str(a)))
    sink = G.SinkPrint(parts, data_inputs, ctx.last_sink)
    ctx.sink_chain_add(sink)
    return sink


def render_sink(n: G.SinkPrint, data_vals: list[Any], ctx: LaFPContext):
    from .lazyframe import Result
    pieces = []
    for part in n.parts:
        kind, v = part
        if kind == "str":
            pieces.append(v)
        else:
            val = data_vals[v]
            if isinstance(val, dict):
                val = Result(val)
            elif getattr(val, "ndim", None) == 0:
                val = val.item()           # device scalar → python number
            pieces.append(str(val))
    ctx.print_fn(" ".join(pieces) if len(pieces) > 1 else
                 (pieces[0] if pieces else ""))
