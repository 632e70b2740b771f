"""Pre-execution pandas linter: warn about expensive idioms before they run.

Static companion to the runtime rewrite engine (``repro_torch.core.rewrite``) and
the fallback layer (``repro_torch.pandas.fallback``): the same frame-variable
discovery that powers the §3.1 liveness analysis finds the dataframe
variables in a user program, and every method call rooted at one is
cross-referenced against

* the **rewrite rule set** — idioms the optimizer will transparently
  rewrite (``sort_values().head(n)`` → top-k, dedup-before-sort, …) get an
  informational diagnostic quoting the rule;
* the **fallback kernel tables** — calls that will leave the lazy graph
  and materialize through a pandas kernel (``df.sample``, ``s.median``, …)
  get a warning, calls served as lazy elementwise UDFs a note;
* **nothing at all** — methods with no native implementation *and* no
  fallback kernel will raise ``AttributeError`` at runtime; those are the
  regressions CI fails on (exit code 1).

Entry points: :func:`lint_source` (used by ``pd.analyze()``, which attaches
the diagnostics to ``ctx.analysis["diagnostics"]`` and thence to
``pd.explain()``), and ``python -m repro_torch.lint <file> [--json]``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import sys

LEVELS = ("info", "warn")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One line-anchored finding in the user program."""
    line: int
    col: int
    kind: str               # dotted category, e.g. "fallback.materialize"
    message: str
    symbol: str = ""        # the method/idiom the diagnostic is about
    level: str = "info"

    def __str__(self):
        return f"{self.level} L{self.line}:{self.col} [{self.kind}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tables():
    from .core.lazyframe import GroupBy, LazyColumn, LazyFrame
    from .pandas import fallback as fb
    return {
        "frame_native": frozenset(d for d in dir(LazyFrame)
                                  if not d.startswith("_")),
        "series_native": frozenset(d for d in dir(LazyColumn)
                                   if not d.startswith("_")),
        "groupby_native": frozenset(d for d in dir(GroupBy)
                                    if not d.startswith("_")),
        "frame_kernels": frozenset(fb.FRAME_KERNELS),
        "series_kernels": frozenset(fb.SERIES_KERNELS),
        "series_elementwise": frozenset(fb.SERIES_ELEMENTWISE),
        "groupby_kernels": frozenset(fb.GROUPBY_REDUCERS),
    }


def _rule_summary(rule_name: str) -> str:
    from .core.rewrite import DEFAULT_RULES
    for r in DEFAULT_RULES:
        if r.name == rule_name:
            return r.summary
    return ""


def _frame_vars(tree: ast.Module) -> set[str]:
    from .core.source_analysis import _build_cfg, _frame_vars_pass
    body = tree.body
    if len(body) == 1 and isinstance(body[0], ast.FunctionDef):
        body = body[0].body
    return _frame_vars_pass(_build_cfg(body))


def _chain_root(node, frames: set[str]) -> str | None:
    from .core.source_analysis import _ExprUses
    return _ExprUses(frames)._chain_root(node)


def _keyword(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_false(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _method_call(node, attr: str | None = None) -> ast.Call | None:
    """``node`` as a method call (optionally of a specific name)."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and (attr is None or node.func.attr == attr)):
        return node
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, frames: set[str], tables: dict):
        self.frames = frames
        self.t = tables
        self.diags: list[Diagnostic] = []
        self._claimed: set[int] = set()     # id() of calls a chain consumed

    def _emit(self, node, kind, message, symbol, level="info"):
        self.diags.append(Diagnostic(
            line=node.lineno, col=node.col_offset, kind=kind,
            message=message, symbol=symbol, level=level))

    # -- chain idioms the rewrite engine recognizes --------------------------

    def _check_rewrites(self, call: ast.Call) -> bool:
        attr = call.func.attr
        inner = _method_call(call.func.value, "sort_values")
        if inner is None or _chain_root(inner.func.value, self.frames) is None:
            return False
        if attr == "head":
            self._claimed.add(id(inner))
            self._emit(call, "rewrite.top_k",
                       "sort_values().head() — "
                       + _rule_summary("sort_head_to_top_k"),
                       symbol="sort_values().head")
            return True
        if attr == "drop_duplicates":
            asc = _keyword(inner, "ascending")
            subset = call.args or _keyword(call, "subset") is not None
            if _is_false(asc) or (len(inner.args) > 1 and
                                  _is_false(inner.args[1])) or subset:
                return False            # guarded out at runtime too
            self._claimed.add(id(inner))
            self._emit(call, "rewrite.dedup_before_sort",
                       "sort_values().drop_duplicates() — "
                       + _rule_summary("dedup_before_sort"),
                       symbol="sort_values().drop_duplicates")
            return True
        return False

    # -- single method calls -------------------------------------------------

    def _check_method(self, call: ast.Call, root: str):
        attr = call.func.attr
        base = call.func.value
        on_frame = isinstance(base, ast.Name) and base.id in self.frames
        on_series = (isinstance(base, ast.Subscript)
                     and isinstance(base.value, ast.Name)
                     and base.value.id in self.frames)
        on_groupby = (_method_call(base, "groupby") is not None
                      or (isinstance(base, ast.Subscript)
                          and _method_call(base.value, "groupby") is not None))
        if attr in ("nlargest", "nsmallest") and (on_frame or on_series):
            self._emit(call, "native.top_k",
                       f"{root}.{attr} runs as a native top-k selection "
                       "(no fallback materialization)", symbol=attr)
            return
        if attr == "apply_rows" and on_frame:
            self._emit(call, "rewrite.vectorize",
                       f"{root}.apply_rows — "
                       + _rule_summary("map_rows_vectorize"), symbol=attr)
            return
        if on_frame:
            native, kernels = self.t["frame_native"], self.t["frame_kernels"]
            what = "DataFrame"
        elif on_series:
            native, kernels = self.t["series_native"], self.t["series_kernels"]
            what = "Series"
        elif on_groupby:
            native = self.t["groupby_native"]
            kernels = self.t["groupby_kernels"]
            what = "GroupBy"
        else:
            return                      # deeper chains: skip (conservative)
        if attr in native:
            return
        if what == "Series" and attr in self.t["series_elementwise"]:
            self._emit(call, "fallback.udf",
                       f"{root}[...].{attr} stays lazy but runs as an opaque "
                       "elementwise UDF (blocks predicate pushdown through "
                       "it)", symbol=attr)
        elif attr in kernels:
            self._emit(call, "fallback.materialize",
                       f"{root}…{attr} will materialize the frame and run "
                       "via the pandas fallback kernel", symbol=attr,
                       level="warn")
        elif not on_groupby:            # unknown groupby attrs: too noisy
            self._emit(call, "fallback.failed",
                       f"{what}.{attr} has no native lazy implementation "
                       "and no fallback kernel — raises AttributeError at "
                       "runtime", symbol=attr, level="warn")

    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute) and id(node) not in self._claimed:
            root = _chain_root(node.func.value, self.frames)
            if root is not None and not self._check_rewrites(node):
                self._check_method(node, root)
        self.generic_visit(node)


def lint_source(source: str, offset: int = 0) -> list[Diagnostic]:
    """Lint a user program (or a decorated function's body).  ``offset``
    shifts reported line numbers (for function sources extracted mid-file)."""
    tree = ast.parse(source)
    linter = _Linter(_frame_vars(tree), _tables())
    linter.visit(tree)
    diags = sorted(linter.diags, key=lambda d: (d.line, d.col))
    if offset:
        diags = [dataclasses.replace(d, line=d.line + offset) for d in diags]
    return diags


def lint_file(path: str) -> list[Diagnostic]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read())


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json = "--json" in argv
    paths = [a for a in argv if a != "--json"]
    if not paths:
        print("usage: python -m repro_torch.lint <file.py> [...] [--json]",
              file=sys.stderr)
        return 2
    failed = False
    all_diags = []
    for path in paths:
        diags = lint_file(path)
        all_diags.append({"file": path,
                          "diagnostics": [d.to_dict() for d in diags]})
        if not as_json:
            for d in diags:
                print(f"{path}:{d}")
        failed |= any(d.kind == "fallback.failed" for d in diags)
    if as_json:
        print(json.dumps(all_diags, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
