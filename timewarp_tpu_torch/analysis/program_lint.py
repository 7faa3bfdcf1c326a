"""AST linter for effect programs (the generator authoring style; copy
of ``timewarp_tpu/analysis/program_lint.py``).

Generator programs (core/effects.py) have three classic *silent* bugs
that type checkers and the interpreters themselves cannot catch:

- **TW301 — combinator without ``yield from``**: every derived
  combinator (``wait``, ``fork``, ``timeout``, …) is itself a
  generator function; calling one as a bare statement creates the
  program object and drops it — nothing runs, no error. The same slip
  as the reference's forgotten ``void`` — except Haskell's type checker
  caught it and Python does not. A combinator under plain ``yield``
  (instead of ``yield from``) hands the interpreter a generator object
  where an Effect is expected — also flagged.
- **TW302 — ``await_io``/``AwaitIO`` reachable from a pure-emulation
  entry point**: arbitrary host IO has no deterministic virtual-time
  meaning; the pure emulator rejects it at run time (interp/ref/des.py)
  but only when that code path actually executes. Revati-style
  time-warp emulation hinges on rejecting host-time escapes up front.
- **TW303/TW304 — swallowed ``ThreadKilled``**: ``kill_thread``,
  slave-subtree teardown and ``work``'s deadline all deliver
  ``ThreadKilled`` as an async exception; a handler that catches it
  (explicitly, or via a broad ``except``) without re-raising makes the
  thread unkillable. The required idiom is the one ``repeat_forever``
  uses (core/effects.py:331-332)::

      except ThreadKilled:
          raise

  An explicit catch without re-raise is an error (TW303); a broad
  handler (bare ``except``, ``Exception``, ``BaseException``) with no
  preceding ``ThreadKilled`` re-raise arm and no ``raise`` of its own
  is a warning (TW304) — ``ThreadKilled`` deliberately subclasses
  ``Exception``-adjacent bases (core/errors.py), so broad catches do
  swallow it.

Suppression: append ``# tw-lint: ignore`` (all codes) or
``# tw-lint: ignore[TW301]`` to the offending line.

Lambda bodies are exempt from TW301: ``lambda: wait(for_(sec(1)))`` is
the ProgramFn *factory* idiom ``Fork``/``schedule`` require — creating
without running is the point there.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Iterable, List, Optional

from .report import ERROR, WARNING, Finding, LintReport

__all__ = ["lint_source", "lint_program", "lint_module_programs",
           "GENERATOR_COMBINATORS"]

#: generator combinators from core/effects.py — calling any of these
#: without ``yield from`` creates-and-drops a program object
GENERATOR_COMBINATORS = frozenset({
    "wait", "virtual_time", "my_thread_id", "fork", "fork_",
    "fork_slave", "park", "unpark", "await_io", "invoke", "schedule",
    "kill_thread", "work", "start_timer", "timeout", "modify_log_name",
    "sleep_forever", "repeat_forever",
})

#: module-ish qualifiers under which attribute calls are recognized
#: (``tw.wait(...)``); bare method names like ``conn.work()`` are not
#: flagged — too collision-prone
_MODULE_QUALIFIERS = frozenset({"tw", "timewarp_tpu", "timewarp_tpu_torch",
                                "effects"})

_BROAD = frozenset({"BaseException", "Exception"})


def _combinator_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name) and f.id in GENERATOR_COMBINATORS:
        return f.id
    if isinstance(f, ast.Attribute) and f.attr in GENERATOR_COMBINATORS \
            and isinstance(f.value, ast.Name) \
            and f.value.id in _MODULE_QUALIFIERS:
        return f.attr
    return None


def _is_name(node, names: Iterable[str]) -> bool:
    return (isinstance(node, ast.Name) and node.id in names) or \
        (isinstance(node, ast.Attribute) and node.attr in names)


def _suppressed(lines: List[str], lineno: int, code: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    line = lines[lineno - 1]
    if "tw-lint:" not in line:
        return False
    directive = line.split("tw-lint:", 1)[1].strip()
    if directive.startswith("ignore"):
        rest = directive[len("ignore"):].strip()
        if not rest:
            return True
        return code in rest.strip("[]").replace(",", " ").split()
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, name: str, filename: str, lines: List[str],
                 pure: bool, first_line: int) -> None:
        self.report = LintReport()
        self.name = name
        self.filename = filename
        self.lines = lines
        self.pure = pure
        self.first_line = first_line

    # -- plumbing --------------------------------------------------------

    def _add(self, code: str, severity: str, node: ast.AST,
             message: str) -> None:
        lineno = getattr(node, "lineno", 1)
        if _suppressed(self.lines, lineno, code):
            return
        self.report.add(Finding(
            code, severity, self.name, message,
            location=(self.filename, lineno + self.first_line - 1)))

    # -- TW301: dropped program objects ----------------------------------

    # note: the ``lambda: wait(...)`` ProgramFn-factory idiom is exempt
    # by construction — a lambda body is an expression, never an
    # ast.Expr *statement*, so neither rule below can fire inside one

    def visit_Expr(self, node: ast.Expr) -> None:
        v = node.value
        if isinstance(v, ast.Call):
            comb = _combinator_name(v)
            if comb is not None:
                self._add(
                    "TW301", ERROR, node,
                    f"'{comb}(...)' called as a bare statement: "
                    "combinators are generator functions — the program "
                    "object is created and dropped, nothing runs. Use "
                    f"'yield from {comb}(...)'")
        self.generic_visit(node)

    def visit_Yield(self, node: ast.Yield) -> None:
        v = node.value
        if isinstance(v, ast.Call):
            comb = _combinator_name(v)
            if comb is not None:
                self._add(
                    "TW301", ERROR, node,
                    f"'yield {comb}(...)' hands the interpreter a "
                    "generator object where an Effect is expected. Use "
                    f"'yield from {comb}(...)'")
        self.generic_visit(node)

    # -- TW302: host IO in a pure context --------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if self.pure:
            f = node.func
            if _is_name(f, ("await_io", "AwaitIO")):
                which = f.id if isinstance(f, ast.Name) else f.attr
                self._add(
                    "TW302", ERROR, node,
                    f"'{which}' is reachable from a pure-emulation "
                    "entry point: real host IO has no deterministic "
                    "virtual-time meaning and the pure emulator "
                    "rejects it at run time (interp/ref/des.py). Gate "
                    "it behind the real-IO interpreter or build on "
                    "timed effects only")
        self.generic_visit(node)

    # -- TW303/TW304: swallowed ThreadKilled -----------------------------

    @staticmethod
    def _handler_names(h: ast.ExceptHandler) -> List[str]:
        t = h.type
        if t is None:
            return ["<bare>"]
        nodes = t.elts if isinstance(t, ast.Tuple) else [t]
        out = []
        for x in nodes:
            if isinstance(x, ast.Name):
                out.append(x.id)
            elif isinstance(x, ast.Attribute):
                out.append(x.attr)
        return out

    @classmethod
    def _reraises(cls, body: List[ast.stmt]) -> bool:
        """Does the handler body contain a ``raise`` statement (nested
        compound statements included, nested function/class definitions
        excluded — a raise inside an inner def does not unwind this
        handler)?"""
        for stmt in body:
            if isinstance(stmt, ast.Raise):
                return True
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                if cls._reraises(getattr(stmt, field, []) or []):
                    return True
            for h in getattr(stmt, "handlers", []) or []:
                if cls._reraises(h.body):
                    return True
        return False

    def visit_Try(self, node: ast.Try) -> None:
        killed_handled = False
        for h in node.handlers:
            names = self._handler_names(h)
            reraises = self._reraises(h.body)
            if "ThreadKilled" in names:
                if not reraises:
                    self._add(
                        "TW303", ERROR, h,
                        "'except ThreadKilled' without re-raise: the "
                        "thread becomes unkillable (kill_thread, "
                        "slave teardown and work() deadlines all "
                        "deliver ThreadKilled). Re-raise it — the "
                        "repeat_forever idiom, core/effects.py:331-332")
                killed_handled = True
            elif any(nm in _BROAD or nm == "<bare>" for nm in names):
                if not killed_handled and not reraises:
                    self._add(
                        "TW304", WARNING, h,
                        f"broad 'except {'/'.join(names)}' can swallow "
                        "ThreadKilled (it is an Exception subclass); "
                        "add a preceding 'except ThreadKilled: raise' "
                        "arm or re-raise inside")
        self.generic_visit(node)


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def lint_source(src: str, *, name: str = "<program>", pure: bool = True,
                filename: str = "<string>",
                first_line: int = 1) -> LintReport:
    """Lint program source text. ``pure=True`` additionally flags
    ``await_io``/``AwaitIO`` (TW302) — pass False for code that only
    ever runs under the real-IO interpreter."""
    try:
        tree = ast.parse(textwrap.dedent(src))
    except SyntaxError as e:
        rep = LintReport()
        rep.add(Finding("TW300", WARNING, name,
                        f"source not parseable ({e}); program lints "
                        "skipped", location=(filename, first_line)))
        return rep
    linter = _Linter(name, filename, src.splitlines(), pure, first_line)
    linter.visit(tree)
    return linter.report


def lint_program(fn, *, pure: bool = True) -> LintReport:
    """Lint one program (or program-builder) function via its source.
    Nested defs are linted along with it — combinator misuse inside a
    locally-defined child program is the common case."""
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", str(fn)))
    try:
        src = inspect.getsource(fn)
        filename = inspect.getsourcefile(fn) or "<unknown>"
        first_line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError) as e:
        rep = LintReport()
        rep.add(Finding("TW300", WARNING, name,
                        f"source unavailable ({e}); program lints "
                        "skipped"))
        return rep
    return lint_source(src, name=name, pure=pure, filename=filename,
                       first_line=first_line)


def lint_module_programs(module, *, pure: bool = True) -> LintReport:
    """Lint every function defined in ``module`` (one parse of the
    module source — nested and decorated defs included)."""
    name = getattr(module, "__name__", str(module))
    try:
        src = inspect.getsource(module)
        filename = inspect.getsourcefile(module) or "<unknown>"
    except (OSError, TypeError) as e:
        rep = LintReport()
        rep.add(Finding("TW300", WARNING, name,
                        f"module source unavailable ({e}); program "
                        "lints skipped"))
        return rep
    return lint_source(src, name=name, pure=pure, filename=filename)
