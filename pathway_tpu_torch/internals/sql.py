"""pw.sql: SQL -> dataflow translation (reference: internals/sql.py:613).

Covers the reference's documented subset: SELECT (exprs, aliases), FROM
(tables and subqueries), WHERE, GROUP BY, HAVING, JOIN ... ON, UNION /
UNION ALL, INTERSECT, WITH (CTEs). Ordering operations (ORDER BY, LIMIT)
are unsupported exactly as in the reference — a streaming dataflow has
no output order. Parsing is hand-rolled (no sqlglot in the image);
expressions support the usual arithmetic/comparison/boolean operators,
literals and function calls mapped to reducers.
"""

from __future__ import annotations

import re
from typing import Any

from pathway_tpu_torch.internals import expression as ex
from pathway_tpu_torch.internals import reducers as red
from pathway_tpu_torch.internals.table import Table

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<str>'[^']*')|(?P<id>[A-Za-z_][A-Za-z_0-9.]*)"
    r"|(?P<op><=|>=|<>|!=|==|[-+*/%(),<>=]))"
)

_AGGS = {
    "count": red.count,
    "sum": red.sum,
    "avg": red.avg,
    "min": red.min,
    "max": red.max,
}


def _tokenize(s: str) -> list[str]:
    out = []
    i = 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m:
            if s[i].isspace():
                i += 1
                continue
            raise ValueError(f"cannot tokenize SQL at {s[i:]!r}")
        out.append(m.group(0).strip())
        i = m.end()
    return out


class _Parser:
    def __init__(self, tokens: list[str], tables: dict[str, Table]):
        self.toks = tokens
        self.i = 0
        self.tables = tables
        self.aggs_used: bool = False

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got.lower() != tok.lower():
            raise ValueError(f"expected {tok!r}, got {got!r}")

    # precedence-climbing expression parser
    def parse_expr(self, table: Table, min_prec: int = 0) -> Any:
        left = self.parse_atom(table)
        PRECS = {
            "or": 1, "and": 2,
            "=": 3, "==": 3, "!=": 3, "<>": 3, "<": 3, "<=": 3, ">": 3, ">=": 3,
            "+": 4, "-": 4, "*": 5, "/": 5, "%": 5,
        }
        while True:
            tok = self.peek()
            if tok is None:
                break
            op = tok.lower()
            if op not in PRECS or PRECS[op] < min_prec:
                break
            self.next()
            right = self.parse_expr(table, PRECS[op] + 1)
            if op == "and":
                left = ex.wrap_arg(left) & ex.wrap_arg(right)
            elif op == "or":
                left = ex.wrap_arg(left) | ex.wrap_arg(right)
            elif op in ("=", "=="):
                left = ex.wrap_arg(left) == right
            elif op in ("!=", "<>"):
                left = ex.wrap_arg(left) != right
            else:
                left = ex.BinaryOpExpression(
                    op, ex.wrap_arg(left), ex.wrap_arg(right)
                )
        return left

    def parse_atom(self, table: Table) -> Any:
        tok = self.next()
        if tok == "(":
            e = self.parse_expr(table)
            self.expect(")")
            return e
        if tok == "-":
            return -ex.wrap_arg(self.parse_atom(table))
        if re.fullmatch(r"\d+", tok):
            return int(tok)
        if re.fullmatch(r"\d+\.\d+", tok):
            return float(tok)
        if tok.startswith("'"):
            return tok[1:-1]
        low = tok.lower()
        if low in _AGGS and self.peek() == "(":
            self.next()
            self.aggs_used = True
            if self.peek() == "*":
                self.next()
                self.expect(")")
                return red.count()
            arg = self.parse_expr(table)
            self.expect(")")
            return _AGGS[low](arg)
        if low in ("true", "false"):
            return low == "true"
        if low == "null":
            return None
        # identifier (possibly tab.col)
        if "." in tok:
            tname, col = tok.split(".", 1)
            return self.tables[tname][col]
        return table[tok]


def _distinct(table: Table) -> Table:
    cols = table._column_names()
    return table.groupby(*[table[c] for c in cols]).reduce(
        **{c: table[c] for c in cols}
    )


def _toplevel_keyword_last(toks: list[str], words: tuple[str, ...]) -> int:
    """Index of the LAST depth-0 occurrence of any keyword, or -1 —
    set operations are left-associative, so the split point is the last
    operator of the precedence level."""
    depth = 0
    found = -1
    for i, t in enumerate(toks):
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        elif depth == 0 and t.lower() in words:
            found = i
    return found


def _balanced(toks: list[str], start: int) -> int:
    """Index just past the ')' matching the '(' at `start`."""
    assert toks[start] == "("
    depth = 0
    for i in range(start, len(toks)):
        if toks[i] == "(":
            depth += 1
        elif toks[i] == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    raise ValueError("unbalanced parentheses in SQL")


def sql(query: str, **tables: Table) -> Table:
    """Translate a SQL query over the given tables into a dataflow Table."""
    toks = _tokenize(query.replace("\n", " "))
    tables = dict(tables)

    # WITH name AS ( ... ) [, name AS ( ... )] — CTEs become tables
    if toks and toks[0].lower() == "with":
        i = 1
        while True:
            name = toks[i]
            if toks[i + 1].lower() != "as" or toks[i + 2] != "(":
                raise ValueError("WITH requires `name AS ( SELECT ... )`")
            end = _balanced(toks, i + 2)
            tables[name] = sql(" ".join(toks[i + 3 : end - 1]), **tables)
            i = end
            if i < len(toks) and toks[i] == ",":
                i += 1
                continue
            break
        toks = toks[i:]

    # Set operations, standard SQL precedence: UNION/EXCEPT are the outer
    # (left-associative) level, INTERSECT binds tighter. Splitting at the
    # LAST top-level keyword of each level yields left association.
    idx = _toplevel_keyword_last(toks, ("union", "except"))
    if idx < 0:
        idx = _toplevel_keyword_last(toks, ("intersect",))
    if idx >= 0:
        op = toks[idx].lower()
        left_q = " ".join(toks[:idx])
        rest = toks[idx + 1 :]
        if op == "union" and rest and rest[0].lower() == "all":
            right_q = " ".join(rest[1:])
            return sql(left_q, **tables).concat_reindex(sql(right_q, **tables))
        right_q = " ".join(rest)
        left_t = sql(left_q, **tables)
        right_t = sql(right_q, **tables)
        if op == "union":
            return _distinct(left_t.concat_reindex(right_t))
        # INTERSECT / EXCEPT by row content: _distinct keys rows by their
        # column values (groupby keys are content-addressed), so key-level
        # set ops implement value-level semantics
        lk, rk = _distinct(left_t), _distinct(right_t)
        if op == "intersect":
            return lk.restrict(rk)
        return lk.difference(rk)

    p = _Parser(toks, tables)
    p.expect("select")
    # collect select list tokens until FROM
    select_items: list[tuple[str | None, list[str]]] = []
    cur: list[str] = []
    depth = 0
    while True:
        tok = p.peek()
        if tok is None:
            raise ValueError("missing FROM")
        if tok.lower() == "from" and depth == 0:
            p.next()
            break
        p.next()
        if tok == "(":
            depth += 1
        elif tok == ")":
            depth -= 1
        if tok == "," and depth == 0:
            select_items.append((None, cur))
            cur = []
        else:
            cur.append(tok)
    if cur:
        select_items.append((None, cur))

    _RESERVED = {
        "where", "group", "having", "join", "inner", "left", "right",
        "outer", "on", "union", "intersect", "except", "as", ",",
    }
    if p.peek() == "(":
        # FROM ( SELECT ... ) [AS] [alias] — subquery as a table
        end = _balanced(p.toks, p.i)
        sub_table = sql(" ".join(p.toks[p.i + 1 : end - 1]), **tables)
        p.i = end
        if p.peek() and p.peek().lower() == "as":
            p.next()
        nxt = p.peek()
        tname = (
            p.next() if nxt is not None and nxt.lower() not in _RESERVED
            else "_subquery"
        )
        tables[tname] = sub_table
        table = sub_table
    else:
        tname = p.next()
        if tname not in tables:
            raise ValueError(f"unknown table {tname!r}")
        table = tables[tname]

    # JOIN
    while p.peek() and p.peek().lower() in ("join", "inner", "left", "right", "outer"):
        how = "inner"
        tok = p.next().lower()
        if tok in ("left", "right", "outer"):
            how = tok
            if p.peek() and p.peek().lower() == "outer":
                p.next()
            p.expect("join")
        other_name = p.next()
        other = tables[other_name]
        p.expect("on")
        cond = p.parse_expr(table)
        jr = table.join(other, cond, how=how)
        table = jr.select_all()
        tables[tname] = table
        tables[other_name] = table

    where_cond = None
    if p.peek() and p.peek().lower() == "where":
        p.next()
        where_cond = p.parse_expr(table)
    group_cols: list[str] = []
    if p.peek() and p.peek().lower() == "group":
        p.next()
        p.expect("by")
        while True:
            group_cols.append(p.next())
            if p.peek() == ",":
                p.next()
            else:
                break
    having_toks: Any = None
    if p.peek() and p.peek().lower() == "having":
        p.next()
        having_toks = p.parse_expr  # parsed later against reduced table

    if where_cond is not None:
        table = table.filter(ex.wrap_arg(where_cond))

    # build select expressions
    def parse_item(item_toks: list[str], tab: Table) -> tuple[str, Any]:
        # [expr..., AS, alias] | [expr...]
        alias = None
        lows = [t.lower() for t in item_toks]
        if "as" in lows:
            ai = lows.index("as")
            alias = item_toks[ai + 1]
            item_toks = item_toks[:ai]
        if item_toks == ["*"]:
            return ("*", "*")
        sub = _Parser(item_toks, tables)
        e = sub.parse_expr(tab)
        if sub.aggs_used:
            p.aggs_used = True
        if alias is None:
            alias = item_toks[0].split(".")[-1] if len(item_toks) == 1 else "expr"
        return (alias, e)

    items = [parse_item(toks_, table) for _, toks_ in select_items]

    if group_cols:
        g_refs = [table[c.split(".")[-1]] for c in group_cols]
        kwargs = {}
        for alias, e in items:
            if alias == "*":
                raise ValueError("SELECT * not allowed with GROUP BY")
            kwargs[alias] = e
        result = table.groupby(*g_refs).reduce(**kwargs)
        if having_toks is not None:
            hp = _Parser(
                toks[p.i:], {tname: result}
            )
            cond = having_toks(result)
            result = result.filter(ex.wrap_arg(cond))
        return result
    if any(alias == "*" for alias, _ in items):
        return table if where_cond is None else table
    kwargs = {alias: e for alias, e in items}
    if p.aggs_used:
        return table.reduce(**kwargs)
    return table.select(**kwargs)
