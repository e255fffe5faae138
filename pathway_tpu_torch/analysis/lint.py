"""Repo lint suite: AST checks encoding rules this codebase has paid for.

Each rule is a bug class with a PR receipt (docs/static-analysis.md has
the catalog):

* ``env-hot-path`` — no ``os.environ`` / ``os.getenv`` read inside
  wave/batch/per-row hot paths (PR 9(h): ``DeviceExchanger`` paid an env
  read per batch until its mode was cached at construction). Flags env
  reads inside methods of ``*Node`` classes and inside the named
  hot-path functions; reads belong at construction or lowering time.
* ``swallowed-io-error`` — no silent ``except: pass`` on I/O paths in
  ``io/`` and ``stdlib/`` (PR 7: http read polls swallowed failures
  bare; they now route through ``io/_retry.RetryPolicy``). Flags
  handlers whose body is only ``pass``/``...`` and whose caught types
  include an I/O-shaped exception (bare, Exception, OSError family,
  timeouts); a swallow must retry, log, or count its degradation.
* ``jit-under-lock`` — no ``jax.jit`` / compile call lexically inside a
  ``with <...lock...>`` block (PR 7: ``DevicePlane.program`` built
  ``jax.jit`` while holding the plane lock; a gc finalizer re-entering
  ``drop_program`` deadlocked the thread against itself). Build outside,
  publish under the lock.
* ``outbox-bypass`` — inside ``engine/``, the sink writer callbacks
  (``write_batch`` / ``write_native`` / ``write_keyed``) may only be
  *called* from ``OutputNode._write_retrying`` (PR 12: delivery must ride
  the retry policy and, under exactly-once, the outbox fence — a direct
  call path would dodge both).

Suppression: append ``# lint: allow(<rule>)`` to the offending line for
a justified exception; the pragma is part of the diff and reviewable.

Run: ``python -m pathway_tpu_torch.analysis.lint`` (exits nonzero on any
violation — the ``lint`` CI leg in scripts/test_both_planes.py).
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable

__all__ = ["Finding", "lint_file", "lint_paths", "run", "main", "RULES"]

RULES = (
    "env-hot-path",
    "swallowed-io-error",
    "jit-under-lock",
    "outbox-bypass",
)


class Finding:
    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path = path
        self.line = line
        self.rule = rule
        self.message = message

    def __repr__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# --------------------------------------------------------------- helpers


def _pragmas(source: str) -> dict[int, set[str]]:
    """line -> set of rules allowed by a `# lint: allow(rule[,rule])`."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        marker = "# lint: allow("
        at = line.find(marker)
        if at < 0:
            continue
        inner = line[at + len(marker):]
        inner = inner.split(")", 1)[0]
        out[i] = {r.strip() for r in inner.split(",") if r.strip()}
    return out


def _is_env_read(node: ast.AST) -> bool:
    """os.environ[...] / os.environ.get(...) / os.getenv(...) /
    environ.get(...) — any spelling of an environment read."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return True
    if isinstance(node, ast.Name) and node.id == "environ":
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "getenv":
            return True
        if isinstance(f, ast.Name) and f.id == "getenv":
            return True
    return False


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted source of an expression (for lock detection)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return _dotted(node.value) + "." + node.attr
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    if isinstance(node, ast.Subscript):
        return _dotted(node.value)
    return ""


# ------------------------------------------------------- rule: env reads

# functions that run per wave / per batch / per row — the engine's inner
# loops plus the serving/exchange/sink surfaces. Methods of *Node classes
# are hot by default (below) so this list names the hot free functions
# and non-Node methods.
_HOT_FUNCTIONS = frozenset({
    "finish_time", "emit", "accept", "take_input", "take_segments",
    "pump", "_fire", "split_batch", "try_exchange", "exchange_by_key",
    "exchange_with_respill", "exchange_columns_with_respill",
    "decide", "admit", "admit_async", "current_lag",
    "stage", "deliver", "write_wave", "_write_retrying",
    "search", "search_batch", "decode_step", "step_slots",
    "_run_row", "_chunk_bodies", "_attention",
})

# *Node methods that are construction / identity / teardown time, not
# per-wave
_COLD_NODE_METHODS = frozenset({
    "__init__", "__new__", "__repr__", "__getstate__", "__setstate__",
    "describe", "persist_signature", "snapshot_state", "restore_state",
    "set_output_node", "set_columns", "close", "from_live_nodes",
})


def _check_env_hot_path(
    tree: ast.Module, path: str, findings: list[Finding]
) -> None:
    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.stack: list[tuple[str, bool]] = []  # (name, is_hot)

        def _enter(self, node, is_hot: bool) -> None:
            self.stack.append((node.name, is_hot))
            self.generic_visit(node)
            self.stack.pop()

        def visit_ClassDef(self, node: ast.ClassDef) -> None:
            self.stack.append((node.name, False))
            self.generic_visit(node)
            self.stack.pop()

        def _func(self, node) -> None:
            in_node_class = any(
                name.endswith("Node") for name, _h in self.stack
                if name[:1].isupper()
            )
            hot = node.name in _HOT_FUNCTIONS or (
                in_node_class and node.name not in _COLD_NODE_METHODS
            )
            self._enter(node, hot)

        visit_FunctionDef = _func
        visit_AsyncFunctionDef = _func

        def generic_visit(self, node: ast.AST) -> None:
            if (
                _is_env_read(node)
                and any(h for _n, h in self.stack)
            ):
                fn = next(
                    (n for n, h in reversed(self.stack) if h), "?"
                )
                findings.append(Finding(
                    path, node.lineno, "env-hot-path",
                    f"os.environ read inside hot path {fn}() — read the "
                    "flag at construction or lowering time and cache it "
                    "(PR 9(h) DeviceExchanger pattern)",
                ))
            super().generic_visit(node)

    V().visit(tree)


# ------------------------------------------- rule: swallowed I/O errors

_IO_EXC = frozenset({
    "Exception", "BaseException", "OSError", "IOError", "EnvironmentError",
    "ConnectionError", "ConnectionResetError", "ConnectionAbortedError",
    "BrokenPipeError", "TimeoutError", "socket.timeout",
})


def _handler_types(h: ast.ExceptHandler) -> list[str]:
    if h.type is None:
        return [""]  # bare except
    t = h.type
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return [_dotted(e) for e in elts]


def _check_swallowed_io(
    tree: ast.Module, path: str, findings: list[Finding]
) -> None:
    norm = path.replace("\\", "/")
    if "/io/" not in norm and "/stdlib/" not in norm:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        body_silent = all(
            isinstance(s, ast.Pass)
            or (
                isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis
            )
            for s in node.body
        )
        if not body_silent:
            continue
        caught = _handler_types(node)
        hit = [c for c in caught if c == "" or c.split(".")[-1] in
               {x.split(".")[-1] for x in _IO_EXC}]
        if not hit:
            continue
        shown = ", ".join(c or "<bare>" for c in hit)
        findings.append(Finding(
            path, node.lineno, "swallowed-io-error",
            f"except {shown}: pass swallows an I/O failure silently — "
            "route through io/_retry.RetryPolicy or log + count the "
            "degradation (PR 7 bug class)",
        ))


# ------------------------------------------------- rule: jit under lock

_LOCKISH = ("lock", "mutex")
_COMPILE_CALLS = frozenset({"jit"})


def _is_lock_ctx(expr: ast.AST) -> bool:
    d = _dotted(expr).lower()
    return any(tok in d for tok in _LOCKISH)


def _check_jit_under_lock(
    tree: ast.Module, path: str, findings: list[Finding]
) -> None:
    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.lock_depth = 0

        def visit_With(self, node: ast.With) -> None:
            locked = any(_is_lock_ctx(i.context_expr) for i in node.items)
            self.lock_depth += locked
            self.generic_visit(node)
            self.lock_depth -= locked

        visit_AsyncWith = visit_With

        def _shield(self, node) -> None:
            # a nested def under a with-lock runs LATER, not under the
            # lock — don't inherit the lock depth into its body
            saved, self.lock_depth = self.lock_depth, 0
            self.generic_visit(node)
            self.lock_depth = saved

        visit_FunctionDef = _shield
        visit_AsyncFunctionDef = _shield
        visit_Lambda = _shield

        def visit_Call(self, node: ast.Call) -> None:
            if self.lock_depth and _call_name(node) in _COMPILE_CALLS:
                findings.append(Finding(
                    path, node.lineno, "jit-under-lock",
                    "jax.jit/compile call while holding a lock — build "
                    "the program outside and publish the result under "
                    "the lock (PR 7 device-plane deadlock class)",
                ))
            self.generic_visit(node)

    V().visit(tree)


# -------------------------------------------------- rule: outbox bypass

_WRITER_CALLBACKS = frozenset({"write_batch", "write_native", "write_keyed"})


def _check_outbox_bypass(
    tree: ast.Module, path: str, findings: list[Finding]
) -> None:
    norm = path.replace("\\", "/")
    if "/engine/" not in norm:
        return

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.fn_stack: list[str] = []

        def _func(self, node) -> None:
            self.fn_stack.append(node.name)
            self.generic_visit(node)
            self.fn_stack.pop()

        visit_FunctionDef = _func
        visit_AsyncFunctionDef = _func

        def visit_Call(self, node: ast.Call) -> None:
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _WRITER_CALLBACKS
                and "_write_retrying" not in self.fn_stack
            ):
                findings.append(Finding(
                    path, node.lineno, "outbox-bypass",
                    f"direct {f.attr}() call bypasses the sink retry/"
                    "outbox path — deliver through OutputNode."
                    "_write_retrying (or stage to the outbox) so "
                    "exactly-once and the retry policy hold (PR 12 "
                    "contract)",
                ))
            self.generic_visit(node)

    V().visit(tree)


# ---------------------------------------------------------------- driver

_CHECKS = (
    _check_env_hot_path,
    _check_swallowed_io,
    _check_jit_under_lock,
    _check_outbox_bypass,
)


def lint_file(path: str, source: str | None = None) -> list[Finding]:
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "parse-error", str(e))]
    findings: list[Finding] = []
    for check in _CHECKS:
        check(tree, path, findings)
    allowed = _pragmas(source)
    return [
        f for f in findings
        if f.rule not in allowed.get(f.line, ())
    ]


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    findings: list[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            findings.extend(lint_file(root))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, name)))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def run(paths: Iterable[str] | None = None) -> list[Finding]:
    """Lint the package (default) or explicit paths; returns findings."""
    if paths is None:
        import pathway_tpu_torch

        paths = [os.path.dirname(os.path.abspath(pathway_tpu_torch.__file__))]
    return lint_paths(paths)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    findings = run(argv or None)
    for f in findings:
        print(f)
    n = len(findings)
    print(f"pathway_tpu_torch.analysis.lint: {n} violation{'s' if n != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
