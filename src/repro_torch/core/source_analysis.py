"""JIT static analysis (paper §2.2–§2.4, §3.1, §3.5), on Python `ast`.

The paper converts source → SCIRPy (a Soot IR) and runs dataflow analyses.
The analyses themselves are IR-agnostic; we build a statement-level CFG from
`ast` and run the same backward Gen/Kill fixpoint:

* **Live Attribute Analysis (LAA)** — per (frame, column) liveness with the
  paper's rules: whole-frame use gens ALL, frame (re)definition kills ALL,
  derived-frame liveness flows to sources, aggregates kill all but key/agg
  columns, `head/info/describe` ignored (paper's heuristic).
* **Live DataFrame Analysis (LDA)** — which frame vars are live after each
  program point; consumed at force points for persist planning (`live_df`).
* **read-site usecols** — live columns at each `read_*` call (column
  selection, Fig. 4).
* **read-only columns** — never-assigned columns, the §3.6 guard for
  category/dtype narrowing.

Results go into ``LaFPContext.analysis`` keyed by source line number; the
lazy runtime looks them up by call-site reflection (this replaces the paper's
source rewriting — semantically it is the same `usecols=[...]` /
``live_df=[...]`` injection).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

ALL = "<ALL>"

_READ_FNS = {"read_csv", "read_parquet", "read_npz", "read_source",
             "from_arrays", "read_table"}
_IGNORED_METHODS = {"head", "info", "describe"}  # paper §3.1 heuristic
_FRAME_METHODS_IDENTITY = {
    "sort_values", "drop_duplicates", "fillna", "astype", "rename", "assign",
    "head", "copy", "reset_index",
}
_FORCE_METHODS = {"compute", "materialize", "to_numpy_table"}


@dataclasses.dataclass
class StmtNode:
    stmt: ast.stmt
    succs: list[int] = dataclasses.field(default_factory=list)
    gen: set = dataclasses.field(default_factory=set)
    kill: set = dataclasses.field(default_factory=set)
    out: set = dataclasses.field(default_factory=set)
    inn: set = dataclasses.field(default_factory=set)


class AnalysisResult:
    def __init__(self):
        self.usecols: dict[int, list[str] | None] = {}   # read lineno -> cols
        self.live_at: dict[int, list[str]] = {}          # force lineno -> frame vars
        self.readonly_cols: set[str] = set()
        self.assigned_cols: set[str] = set()
        self.frame_vars: set[str] = set()
        self.all_used_cols: set[str] = set()

    def as_context_dict(self) -> dict:
        return {
            "usecols": self.usecols,
            "live_at": self.live_at,
            "readonly_cols": (self.all_used_cols - self.assigned_cols),
            "frame_vars": self.frame_vars,
            "scan_extra_cols": {},
        }


# ---------------------------------------------------------------------------
# CFG construction


def _build_cfg(body: list[ast.stmt]) -> list[StmtNode]:
    nodes: list[StmtNode] = []

    def add(stmt) -> int:
        nodes.append(StmtNode(stmt))
        return len(nodes) - 1

    def seq(stmts: list[ast.stmt], preds: list[int]) -> list[int]:
        """Wire statements sequentially; returns exit node ids."""
        cur = preds
        for s in stmts:
            if isinstance(s, ast.If):
                i = add(s)  # condition evaluation node
                for p in cur:
                    nodes[p].succs.append(i)
                then_exits = seq(s.body, [i])
                else_exits = seq(s.orelse, [i]) if s.orelse else [i]
                cur = then_exits + else_exits
            elif isinstance(s, (ast.For, ast.While)):
                i = add(s)  # header
                for p in cur:
                    nodes[p].succs.append(i)
                body_exits = seq(s.body, [i])
                for e in body_exits:
                    nodes[e].succs.append(i)  # back edge
                cur = [i] + (seq(s.orelse, [i]) if s.orelse else [])
            elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                i = add(s)
                for p in cur:
                    nodes[p].succs.append(i)
                cur = [i]
            elif isinstance(s, ast.With):
                i = add(s)
                for p in cur:
                    nodes[p].succs.append(i)
                cur = seq(s.body, [i])
            elif isinstance(s, ast.Try):
                i = add(s)
                for p in cur:
                    nodes[p].succs.append(i)
                body_exits = seq(s.body, [i])
                handler_exits = []
                for h in s.handlers:
                    handler_exits += seq(h.body, [i] + body_exits)
                final_preds = body_exits + handler_exits
                cur = seq(s.finalbody, final_preds) if s.finalbody else final_preds
            else:
                i = add(s)
                for p in cur:
                    nodes[p].succs.append(i)
                cur = [i]
        return cur

    seq(body, [])
    return nodes


# ---------------------------------------------------------------------------
# Expression inspection


def _const_str_list(node) -> list[str] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


class _ExprUses(ast.NodeVisitor):
    """Collect (frame, col) uses from an expression (Gen set contribution),
    plus frame derivation sources."""

    _AGG_METHODS = {"sum", "mean", "min", "max", "count", "nunique", "size",
                    "agg", "groupby"}

    def __init__(self, frame_vars: set[str]):
        self.frame_vars = frame_vars
        self.uses: set[tuple[str, str]] = set()
        self.sources: set[str] = set()       # all frames this expr derives from
        # identity derivations propagate the derived frame's live columns to
        # the source 1:1; aggregation derivations cut liveness (paper §3.1:
        # "aggregates kill all columns except those used in the aggregate or
        # groupby") — their uses are recorded explicitly instead.
        self.identity_sources: set[str] = set()

    def _frame_name(self, node) -> str | None:
        if isinstance(node, ast.Name) and node.id in self.frame_vars:
            return node.id
        return None

    def visit_Name(self, node: ast.Name):
        # bare frame reference (passed around / f-string / alias): whole use
        if isinstance(node.ctx, ast.Load) and node.id in self.frame_vars:
            self.uses.add((node.id, ALL))
            self.sources.add(node.id)
            self.identity_sources.add(node.id)

    def visit_Attribute(self, node: ast.Attribute):
        f = self._frame_name(node.value)
        if f is not None:
            attr = node.attr
            if attr in _IGNORED_METHODS:
                self.sources.add(f)
                return
            if attr in ("dt", "str"):
                # accessor chains: df.col.dt.x — handled by recursion below
                self.visit(node.value)
                return
            if attr in self._AGG_METHODS:
                self.sources.add(f)
                return
            if attr in _FRAME_METHODS_IDENTITY or attr in _FORCE_METHODS \
                    or attr in ("merge", "apply", "loc", "iloc"):
                self.sources.add(f)
                self.identity_sources.add(f)
                return
            # plain column attribute access
            self.uses.add((f, attr))
            self.sources.add(f)
            self.identity_sources.add(f)
            return
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        root = self._chain_root(node.value)
        if root is not None:
            cols = _const_str_list(node.slice)
            if cols is not None:
                for c in cols:
                    self.uses.add((root, c))
            else:
                # boolean-mask / expression subscript: visit the index expr
                self.visit(node.slice)
            self.sources.add(root)
            # subscripting an aggregation chain is not identity; a direct
            # frame subscript is
            if self._frame_name(node.value) is not None:
                self.identity_sources.add(root)
            if self._frame_name(node.value) is None:
                self.visit(node.value)
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        # method chains on frames: df.groupby('k')['c'].sum(), df.merge(d2,on=)
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            # find root frame of the chain
            root = self._chain_root(base)
            if root is not None:
                if fn.attr in _IGNORED_METHODS:
                    self.sources.add(root)
                    return
                self._chain_uses(node, root)
                self.sources.add(root)
                return
        # plain call: frames passed as args are whole-frame uses
        for arg in list(node.args) + [k.value for k in node.keywords]:
            f = self._frame_name(arg)
            if f is not None:
                self.uses.add((f, ALL))
                self.sources.add(f)
            else:
                self.visit(arg)
        if isinstance(fn, ast.Attribute) and self._frame_name(fn.value) is None:
            self.visit(fn.value)

    def _chain_root(self, node) -> str | None:
        while True:
            f = self._frame_name(node)
            if f is not None:
                return f
            if isinstance(node, ast.Attribute):
                node = node.value
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and isinstance(node.func,
                                                           ast.Attribute):
                node = node.func.value
            else:
                return None

    def _chain_uses(self, call: ast.Call, root: str):
        """Extract column uses from a method-call chain rooted at a frame."""
        fn = call.func
        method = fn.attr if isinstance(fn, ast.Attribute) else None
        if method == "groupby":
            cols = _const_str_list(call.args[0]) if call.args else None
            for c in cols or []:
                self.uses.add((root, c))
        elif method == "merge":
            self.identity_sources.add(root)
            for kw in call.keywords:
                if kw.arg == "on":
                    for c in _const_str_list(kw.value) or []:
                        self.uses.add((root, c))
            for a in call.args:
                f = self._frame_name(a)
                if f is not None:
                    self.sources.add(f)
                    self.identity_sources.add(f)
        elif method in ("sort_values", "drop_duplicates"):
            self.identity_sources.add(root)
            args = list(call.args) + [k.value for k in call.keywords]
            for a in args:
                for c in _const_str_list(a) or []:
                    self.uses.add((root, c))
        elif method in ("sum", "mean", "min", "max", "count", "nunique",
                        "size", "agg"):
            pass  # uses come from the inner subscript/groupby visited below
        elif method in _FRAME_METHODS_IDENTITY or method in _FORCE_METHODS:
            self.identity_sources.add(root)
        elif method is not None:
            # unknown method on a frame: conservative whole-frame use
            self.uses.add((root, ALL))
            self.identity_sources.add(root)
        # recurse into the chain below the call and into args — but do not
        # re-visit the bare root Name (that would spuriously gen ALL)
        if isinstance(fn, ast.Attribute) and self._frame_name(fn.value) is None:
            self.visit(fn.value)
        for a in call.args:
            if _const_str_list(a) is None and self._frame_name(a) is None:
                self.visit(a)


# ---------------------------------------------------------------------------
# Main analysis


def _top_level_identity(expr, frames: set[str]) -> set[str]:
    """Frames whose live columns map 1:1 into a var assigned this expr.
    Aggregation chains (groupby/sum/mean/...) cut the mapping (paper §3.1
    aggregate-kill rule); row-preserving forms (subscript, sort, fillna,
    merge, alias) propagate it."""
    helper = _ExprUses(frames)
    if isinstance(expr, ast.Name):
        return {expr.id} if expr.id in frames else set()
    if isinstance(expr, ast.Subscript):
        f = helper._frame_name(expr.value)
        return {f} if f is not None else set()
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        method = expr.func.attr
        root = helper._chain_root(expr.func.value)
        if root is None:
            return set()
        if method in _ExprUses._AGG_METHODS:
            return set()
        out = {root} if method in (_FRAME_METHODS_IDENTITY | {"merge"}) else set()
        if method == "merge":
            for a in expr.args:
                f = helper._frame_name(a)
                if f is not None:
                    out.add(f)
        return out
    return set()


def _is_read_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    return name in _READ_FNS


def _frame_vars_pass(nodes: list[StmtNode]) -> set[str]:
    """Flow-insensitive: vars assigned from read_* or derived from frames."""
    frames: set[str] = set()
    changed = True
    while changed:
        changed = False
        for sn in nodes:
            s = sn.stmt
            if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                    and isinstance(s.targets[0], ast.Name):
                tgt = s.targets[0].id
                if tgt in frames:
                    continue
                if _is_read_call(s.value):
                    frames.add(tgt)
                    changed = True
                    continue
                u = _ExprUses(frames)
                u.visit(s.value)
                if u.sources and _produces_frame(s.value, frames):
                    frames.add(tgt)
                    changed = True
    return frames


def _produces_frame(expr, frames: set[str]) -> bool:
    """Heuristic: subscripts/method-chains on frames produce frames (scalars
    from reductions are also fine to treat as frames for liveness)."""
    if isinstance(expr, ast.Subscript):
        root = _ExprUses(frames)._chain_root(expr.value)
        return root is not None
    if isinstance(expr, ast.Call):
        root = _ExprUses(frames)._chain_root(expr)
        return root is not None
    if isinstance(expr, ast.Attribute):
        return _ExprUses(frames)._chain_root(expr) is not None
    return False


def analyze_source(source: str) -> AnalysisResult:
    tree = ast.parse(source)
    body = tree.body
    # unwrap a single function def (decorator use)
    if len(body) == 1 and isinstance(body[0], ast.FunctionDef):
        body = body[0].body
    nodes = _build_cfg(body)
    res = AnalysisResult()
    frames = _frame_vars_pass(nodes)
    res.frame_vars = frames

    # Gen/Kill per statement (paper equations (1)/(2))
    read_sites: dict[int, tuple[int, str]] = {}   # node idx -> (lineno, var)
    force_sites: list[tuple[int, int]] = []       # (node idx, lineno)
    for idx, sn in enumerate(nodes):
        s = sn.stmt
        gen: set = set()
        kill: set = set()
        if isinstance(s, ast.Assign) and len(s.targets) == 1:
            tgt = s.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id in frames:
                # frame (re)definition kills all its columns
                kill.add((tgt.id, ALL))
                if _is_read_call(s.value):
                    read_sites[idx] = (s.lineno, tgt.id)
                else:
                    u = _ExprUses(frames)
                    u.visit(s.value)
                    gen |= u.uses
                    # derived-frame rule handled in transfer; only identity
                    # derivations propagate live columns 1:1
                    sn.derives_from = _top_level_identity(s.value, frames)  # type: ignore[attr-defined]
            elif isinstance(tgt, ast.Subscript):
                f = tgt.value.id if isinstance(tgt.value, ast.Name) else None
                cols = _const_str_list(tgt.slice)
                if f in frames and cols:
                    for c in cols:
                        kill.add((f, c))
                        res.assigned_cols.add(c)
                u = _ExprUses(frames)
                u.visit(s.value)
                gen |= u.uses
            else:
                u = _ExprUses(frames)
                u.visit(s.value)
                gen |= u.uses
        else:
            for sub in ast.walk(s):
                if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                            ast.Attribute) \
                        and sub.func.attr in _FORCE_METHODS:
                    force_sites.append((idx, sub.lineno))
            u = _ExprUses(frames)
            if isinstance(s, (ast.Expr, ast.Return)) and s.value is not None:
                u.visit(s.value)
            elif isinstance(s, (ast.If, ast.While)):
                u.visit(s.test)
            elif isinstance(s, ast.For):
                u.visit(s.iter)
            elif isinstance(s, ast.AugAssign):
                u.visit(s.value)
                u.visit(s.target)
            gen |= u.uses
        sn.gen = gen
        sn.kill = kill
        for (_f, c) in gen:
            if c != ALL:
                res.all_used_cols.add(c)

    # Backward fixpoint: Out = ∪ In(succ); In = Gen ∪ (Out − Kill),
    # with the derived-frame rule: liveness of a derived frame adds liveness
    # of mapped columns on its sources (identity mapping, conservative).
    changed = True
    iters = 0
    while changed and iters < 200:
        iters += 1
        changed = False
        for sn in reversed(nodes):
            out = set()
            for succ in sn.succs:
                out |= nodes[succ].inn
            inn = set(sn.gen)
            s = sn.stmt
            # derived-frame liveness propagation
            if isinstance(s, ast.Assign) and len(s.targets) == 1 and \
                    isinstance(s.targets[0], ast.Name) and \
                    s.targets[0].id in frames and \
                    hasattr(sn, "derives_from"):
                tgt = s.targets[0].id
                tgt_live = {c for (f, c) in out if f == tgt}
                for src in sn.derives_from:  # type: ignore[attr-defined]
                    for c in tgt_live:
                        inn.add((src, c))
            kill_frames = {f for (f, c) in sn.kill if c == ALL}
            kill_cols = {(f, c) for (f, c) in sn.kill if c != ALL}
            for item in out:
                f, c = item
                if f in kill_frames or item in kill_cols:
                    continue
                inn.add(item)
            if out != sn.out or inn != sn.inn:
                sn.out = out
                sn.inn = inn
                changed = True

    # read-site usecols = live columns of the var at Out of the read stmt
    for idx, (lineno, var) in read_sites.items():
        live_cols = {c for (f, c) in nodes[idx].out if f == var}
        if ALL in live_cols:
            res.usecols[lineno] = None
        else:
            res.usecols[lineno] = sorted(live_cols)

    # force-site live frames (LDA): frames with any live column at Out
    for idx, lineno in force_sites:
        live_frames = sorted({f for (f, _c) in nodes[idx].out})
        res.live_at[lineno] = live_frames

    return res
