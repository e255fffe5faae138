"""Metadata filtering for index queries — a JMESPath-subset evaluator.

Reference parity: the reference compiles JMESPath filter expressions with a
custom `globmatch` function over each candidate's metadata JSON
(src/external_integration/mod.rs:373, jmespath + globset crates). Neither
library is available here, so this is a small recursive-descent evaluator
covering the grammar the Document Store actually emits
(xpacks/llm/document_store.py filter merging):

    path.to.field == 'value'        comparisons: == != < <= > >=
    modified_at >= `1702840800`     backtick-quoted JSON literals
    contains(path, 'needle')
    globmatch('**/foo/*.pdf', path)
    expr && expr, expr || expr, !expr, parentheses
"""

from __future__ import annotations

import fnmatch
import json
import re
from typing import Any, Callable

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<lpar>\()|(?P<rpar>\))|(?P<and>&&)|(?P<or>\|\|)|(?P<not>!(?!=))"
    r"|(?P<cmp>==|!=|<=|>=|<|>)|(?P<lit>`[^`]*`)|(?P<str>'[^']*'|\"[^\"]*\")"
    r"|(?P<num>-?\d+(?:\.\d+)?)|(?P<comma>,)|(?P<ident>[A-Za-z_][\w.]*)"
    r")"
)


class FilterParseError(ValueError):
    pass


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise FilterParseError(f"cannot tokenize filter at: {rest[:30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind is not None:
            tokens.append((kind, m.group(kind)))
    return tokens


def _lookup(meta: Any, path: str) -> Any:
    cur = meta
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            return None
    return cur


def glob_match(pattern: str, path: Any) -> bool:
    """`globset`-style match: ** crosses directory separators, * does not."""
    if not isinstance(path, str):
        return False
    regex = _glob_to_regex(pattern)
    return re.fullmatch(regex, path) is not None


def _glob_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i : i + 3] == "**/":
                out.append("(?:[^/]+/)*")
                i += 3
                continue
            if pattern[i : i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = pattern.find("]", i)
            if j == -1:
                out.append(re.escape(c))
            else:
                out.append(pattern[i : j + 1])
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise FilterParseError("unexpected end of filter")
        self.i += 1
        return tok

    def expect(self, kind: str) -> str:
        k, v = self.next()
        if k != kind:
            raise FilterParseError(f"expected {kind}, got {v!r}")
        return v

    # expr := or_expr
    def parse(self) -> Callable[[Any], Any]:
        e = self.parse_or()
        if self.peek() is not None:
            raise FilterParseError(f"trailing tokens: {self.tokens[self.i:]}")
        return e

    def parse_or(self) -> Callable[[Any], Any]:
        left = self.parse_and()
        while self.peek() is not None and self.peek()[0] == "or":
            self.next()
            right = self.parse_and()
            left = (lambda a, b: lambda m: a(m) or b(m))(left, right)
        return left

    def parse_and(self) -> Callable[[Any], Any]:
        left = self.parse_not()
        while self.peek() is not None and self.peek()[0] == "and":
            self.next()
            right = self.parse_not()
            left = (lambda a, b: lambda m: a(m) and b(m))(left, right)
        return left

    def parse_not(self) -> Callable[[Any], Any]:
        if self.peek() is not None and self.peek()[0] == "not":
            self.next()
            inner = self.parse_not()
            return lambda m: not inner(m)
        return self.parse_cmp()

    def parse_cmp(self) -> Callable[[Any], Any]:
        left = self.parse_atom()
        tok = self.peek()
        if tok is not None and tok[0] == "cmp":
            op = self.next()[1]
            right = self.parse_atom()
            return _make_cmp(op, left, right)
        return left

    def parse_atom(self) -> Callable[[Any], Any]:
        kind, value = self.next()
        if kind == "lpar":
            inner = self.parse_or()
            self.expect("rpar")
            return inner
        if kind == "lit":
            lit = json.loads(value[1:-1])
            return lambda m: lit
        if kind == "str":
            s = value[1:-1]
            return lambda m: s
        if kind == "num":
            n = float(value) if "." in value else int(value)
            return lambda m: n
        if kind == "ident":
            if self.peek() is not None and self.peek()[0] == "lpar":
                return self.parse_call(value)
            if value == "true":
                return lambda m: True
            if value == "false":
                return lambda m: False
            if value == "null":
                return lambda m: None
            return lambda m, p=value: _lookup(m, p)
        raise FilterParseError(f"unexpected token {value!r}")

    def parse_call(self, name: str) -> Callable[[Any], Any]:
        self.expect("lpar")
        args = [self.parse_or()]
        while self.peek() is not None and self.peek()[0] == "comma":
            self.next()
            args.append(self.parse_or())
        self.expect("rpar")
        if name == "contains":
            a, b = args
            return lambda m: (lambda hay, needle: needle in hay
                              if isinstance(hay, (str, list, tuple)) else False)(
                a(m), b(m))
        if name == "globmatch":
            a, b = args
            return lambda m: glob_match(a(m), b(m))
        if name == "starts_with":
            a, b = args
            return lambda m: (lambda s, p: s.startswith(p)
                              if isinstance(s, str) and isinstance(p, str)
                              else False)(a(m), b(m))
        if name == "length":
            (a,) = args
            return lambda m: (lambda v: len(v) if hasattr(v, "__len__") else None)(a(m))
        if name == "to_number":
            (a,) = args
            return lambda m: (lambda v: float(v) if v is not None else None)(a(m))
        raise FilterParseError(f"unknown function {name!r}")


def _make_cmp(op: str, a: Callable, b: Callable) -> Callable[[Any], bool]:
    def cmp(m: Any) -> bool:
        va, vb = a(m), b(m)
        if op == "==":
            return va == vb
        if op == "!=":
            return va != vb
        if va is None or vb is None:
            return False
        try:
            if op == "<":
                return va < vb
            if op == "<=":
                return va <= vb
            if op == ">":
                return va > vb
            return va >= vb
        except TypeError:
            return False

    return cmp


def compile_filter(expression: str) -> Callable[[Any], bool]:
    """Compile a filter string into metadata -> bool."""
    fn = _Parser(_tokenize(expression)).parse()

    def run(meta: Any) -> bool:
        if isinstance(meta, str):
            try:
                meta = json.loads(meta)
            except (ValueError, TypeError):
                meta = {}
        try:
            return bool(fn(meta))
        except Exception:  # noqa: BLE001 — a failing filter excludes the doc
            return False

    return run
