"""`analyze()` — Just-in-Time static analysis entry point (paper §2.4).

Two forms, both using reflection to find the program source (paper Fig. 5):

* ``pd.analyze()`` as the first statement of a script — inspects the calling
  module's source, runs the `ast` analyses, and installs the results in the
  context.  Because our API is already lazy, no textual rewrite is needed:
  the "rewritten program" is the original program executing against hints
  (usecols at read sites, live_df at force sites) looked up by call-site
  line number — semantically identical to the paper's injected arguments.

* ``@analyze`` on a function — analyzes the function body and installs hints
  before invoking it.

(Formerly ``repro_torch.core.tracer`` — renamed because it is the static-analysis
entry point, not a tracer; ``repro_torch.obs`` is the tracing subsystem.  The old
module remains as a deprecation shim.)
"""
from __future__ import annotations

import functools
import inspect
import sys
import textwrap
import time

from .context import get_context
from .source_analysis import analyze_source

# Frames from any engine-internal package are skipped when reflecting on the
# user program: the core layers and the repro_torch.pandas facade both re-export
# analyze()/read_* entry points.
_INTERNAL_PREFIXES = ("repro_torch.core", "repro_torch.pandas")


def _is_internal(module_name: str) -> bool:
    return module_name.startswith(_INTERNAL_PREFIXES)


def _install_lazy_builtins(globs: dict):
    """The paper's program rewriter substitutes print/len with their lazy
    sink-building versions.  For a script (``__main__``) we do the same at
    analyze() time by rebinding the caller module's globals — this is what
    makes the facade a true two-line change (no third import for lazy
    print)."""
    from . import func as lazy_func
    if "print" not in globs:
        globs["print"] = lazy_func.print
    if "len" not in globs:
        globs["len"] = lazy_func.len


def analyze(fn=None):
    if fn is None:
        # script mode: reflect on the caller; analysis is installed in the
        # *current session's* context (session-scoped, not process-global)
        ctx = get_context()
        frame = sys._getframe(1)
        # skip facade/shim frames if called via repro_torch.pandas / repro_torch.core.lazy
        while frame and _is_internal(frame.f_globals.get("__name__", "")):
            frame = frame.f_back
        if frame.f_globals.get("__name__") == "__main__":
            _install_lazy_builtins(frame.f_globals)
        try:
            source = inspect.getsource(sys.modules[frame.f_globals["__name__"]])
        except Exception:
            try:
                with open(frame.f_code.co_filename) as f:
                    source = f.read()
            except Exception:
                ctx.analysis = {}
                return None
        with ctx.tracer.span("analyze", mode="script") as sp:
            t0 = time.perf_counter()
            res = analyze_source(source)
            ctx.analysis = res.as_context_dict()
            _attach_diagnostics(ctx, source)
            jit = time.perf_counter() - t0
            ctx.analysis["jit_seconds"] = jit
            sp.set(jit_seconds=jit)
        return res

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        # look up the context at call time: the function may run inside a
        # session() block created after decoration
        ctx = get_context()
        with ctx.tracer.span("analyze", mode="function") as sp:
            t0 = time.perf_counter()
            try:
                # getsourcelines (not getsource): the hints are keyed by the
                # *file* line numbers the call-site reflection reports, so a
                # function defined mid-file must have its analysis shifted by
                # its starting line; dedent handles nested/indented defs
                # (whose raw source is a SyntaxError to ast.parse).
                lines, start = inspect.getsourcelines(fn)
                source = textwrap.dedent("".join(lines))
                res = analyze_source(source)
                ctx.analysis = res.as_context_dict()
                offset = start - 1
                if offset:
                    ctx.analysis["usecols"] = {
                        ln + offset: v
                        for ln, v in ctx.analysis["usecols"].items()}
                    ctx.analysis["live_at"] = {
                        ln + offset: v
                        for ln, v in ctx.analysis["live_at"].items()}
                _attach_diagnostics(ctx, source, offset)
            except (OSError, TypeError, SyntaxError):
                ctx.analysis = {}
            jit = time.perf_counter() - t0
            ctx.analysis["jit_seconds"] = jit
            sp.set(jit_seconds=jit)
        return fn(*args, **kwargs)

    return wrapped


def _attach_diagnostics(ctx, source: str, offset: int = 0) -> None:
    """Run the pre-execution linter (repro_torch.lint) over the analyzed program
    and attach the findings — surfaced by ``pd.explain()`` and, when the
    session is verbose, printed eagerly.  Linting is advisory: any failure
    leaves the analysis usable."""
    try:
        from ..lint import lint_source
        ctx.analysis["diagnostics"] = lint_source(source, offset=offset)
    except Exception:  # noqa: BLE001 — the linter must never break analyze()
        ctx.analysis["diagnostics"] = []


def user_call_lineno() -> int | None:
    """Line number of the nearest stack frame outside repro_torch.core — the
    call-site key for static-analysis hints."""
    frame = sys._getframe(1)
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if not _is_internal(mod):
            return frame.f_lineno
        frame = frame.f_back
    return None


def user_frame_locals() -> dict:
    frame = sys._getframe(1)
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if not _is_internal(mod):
            return frame.f_locals
        frame = frame.f_back
    return {}


def usecols_hint() -> list[str] | None:
    """usecols for the read_* call currently executing, if analysis has one."""
    ctx = get_context()
    usecols = ctx.analysis.get("usecols") if ctx.analysis else None
    if not usecols:
        return None
    lineno = user_call_lineno()
    return usecols.get(lineno) if lineno is not None else None


def live_frames_hint() -> list | None:
    """live_df for the force point currently executing (paper §3.5)."""
    from .lazyframe import LazyFrame
    ctx = get_context()
    live_at = ctx.analysis.get("live_at") if ctx.analysis else None
    if not live_at:
        return None
    lineno = user_call_lineno()
    if lineno is None or lineno not in live_at:
        return None
    names = live_at[lineno]
    local = user_frame_locals()
    frames = [local[n] for n in names
              if isinstance(local.get(n), LazyFrame)]
    return frames or None
