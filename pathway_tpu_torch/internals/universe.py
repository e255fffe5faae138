"""Universes: static reasoning about table key sets.

Reference parity: internals/universe.py + universe_solver.py — the solver
tracks which tables share a key set (equality via union-find), which are
subsets of which (a DAG with transitive closure), and which are PAIRWISE
DISJOINT, so same-universe operations (select across tables,
update_cells, with_universe_of) and overlap-sensitive ones (concat)
validate at graph build time instead of failing — or silently double
counting — at runtime.

Public promises (pw.universes.*): promise_are_equal,
promise_is_subset_of, promise_are_pairwise_disjoint.
"""

from __future__ import annotations

import itertools
from typing import Any

_ids = itertools.count()


class Universe:
    def __init__(self) -> None:
        self.id = next(_ids)
        self._parent: Universe | None = None

    def root(self) -> "Universe":
        u = self
        while u._parent is not None:
            u = u._parent
        # path compression
        v: Universe | None = self
        while v is not None and v._parent is not None and v._parent is not u:
            nxt = v._parent
            v._parent = u
            v = nxt
        return u

    def __repr__(self) -> str:
        return f"Universe({self.root().id})"


class UniverseSolver:
    """Equality (union-find) + subset DAG + disjointness relation."""

    def __init__(self) -> None:
        # root id -> set of root ids it is a DIRECT subset of
        self.subset_of: dict[int, set[int]] = {}
        # unordered root-id pairs promised disjoint
        self.disjoint: set[frozenset[int]] = set()
        # merged-away root id -> surviving root id (edges recorded under
        # or toward an old root resolve through this chain)
        self.redirect: dict[int, int] = {}

    def reset(self) -> None:
        """Drop every recorded relation (tests / long-lived processes;
        each table contributes O(1) entries, so growth is slow but
        unbounded without this)."""
        self.subset_of.clear()
        self.disjoint.clear()
        self.redirect.clear()

    def _resolve(self, uid: int) -> int:
        while uid in self.redirect:
            uid = self.redirect[uid]
        return uid

    # ------------------------------------------------------------ equality

    def register_as_equal(self, *universes: Universe) -> None:
        roots = [u.root() for u in universes]
        target = roots[0]
        for other in roots[1:]:
            if other is target:
                continue
            if frozenset(
                {self._resolve(target.id), self._resolve(other.id)}
            ) in self.disjoint:
                raise ValueError(
                    "universes promised pairwise disjoint cannot be "
                    "promised equal"
                )
            other._parent = target
            self.redirect[other.id] = target.id
            # merge the relation edges onto the surviving root
            self.subset_of.setdefault(target.id, set()).update(
                self.subset_of.pop(other.id, set())
            )
            for pair in [p for p in self.disjoint if other.id in p]:
                self.disjoint.discard(pair)
                rest = next(iter(pair - {other.id}), None)
                if rest is not None:
                    self.disjoint.add(frozenset({target.id, rest}))

    def are_equal(self, a: Universe, b: Universe) -> bool:
        return a.root() is b.root()

    # ------------------------------------------------------------- subsets

    def register_as_subset(self, sub: Universe, sup: Universe) -> None:
        self.subset_of.setdefault(sub.root().id, set()).add(sup.root().id)

    def is_subset(self, sub: Universe, sup: Universe) -> bool:
        if self.are_equal(sub, sup):
            return True
        target = self._resolve(sup.root().id)
        return target in self._ancestors(sub.root().id)

    # --------------------------------------------------------- disjointness

    def register_as_disjoint(self, *universes: Universe) -> None:
        roots = [self._resolve(u.root().id) for u in universes]
        for i, a in enumerate(roots):
            for b in roots[i + 1 :]:
                if a != b:
                    self.disjoint.add(frozenset({a, b}))

    def are_disjoint(self, a: Universe, b: Universe) -> bool:
        """True when a and b are PROVABLY disjoint: promised directly, or
        each is a subset of a pair promised disjoint."""
        ra, rb = self._resolve(a.root().id), self._resolve(b.root().id)
        if ra == rb:
            return False
        ups_a = self._ancestors(ra)
        ups_b = self._ancestors(rb)
        return any(
            x != y and frozenset({x, y}) in self.disjoint
            for x in ups_a
            for y in ups_b
        )

    def _ancestors(self, uid: int) -> set[int]:
        """All root ids `uid` is (transitively) a subset of, with merged
        roots resolved through the redirect chain."""
        seen: set[int] = set()
        frontier = [self._resolve(uid)]
        while frontier:
            u = frontier.pop()
            if u in seen:
                continue
            seen.add(u)
            frontier.extend(
                self._resolve(x) for x in self.subset_of.get(u, ())
            )
        return seen

    # -------------------------------------------------- derived universes

    def register_as_difference(
        self, result: Universe, minuend: Universe, subtrahend: Universe
    ) -> None:
        self.register_as_subset(result, minuend)
        self.register_as_disjoint(result, subtrahend)

    def register_as_intersection(self, result: Universe, *parts: Universe) -> None:
        for p in parts:
            self.register_as_subset(result, p)

    def register_as_union(self, result: Universe, *parts: Universe) -> None:
        for p in parts:
            self.register_as_subset(p, result)


_SOLVER = UniverseSolver()


def get_solver() -> UniverseSolver:
    return _SOLVER


# ------------------------------------------------------ module-level API
# (kept for existing call sites; tables delegate here)


def promise_are_equal(*universes: Any) -> None:
    """Promise the given tables/universes share exactly the same keys."""
    _SOLVER.register_as_equal(*[_u(x) for x in universes])


def promise_is_subset_of(sub: Any, sup: Any) -> None:
    """Promise `sub`'s keys are all present in `sup`."""
    _SOLVER.register_as_subset(_u(sub), _u(sup))


def promise_are_pairwise_disjoint(*universes: Any) -> None:
    """Promise the given tables/universes share NO keys — concat of
    disjoint tables is statically safe."""
    _SOLVER.register_as_disjoint(*[_u(x) for x in universes])


def register_subset(sub: Universe, sup: Universe) -> None:
    _SOLVER.register_as_subset(sub, sup)


def are_equal(a: Universe, b: Universe) -> bool:
    return _SOLVER.are_equal(a, b)


def is_subset(sub: Universe, sup: Universe) -> bool:
    return _SOLVER.is_subset(sub, sup)


def are_disjoint(a: Universe, b: Universe) -> bool:
    return _SOLVER.are_disjoint(a, b)


def _u(x: Any) -> Universe:
    return x._universe if hasattr(x, "_universe") else x


__all__ = [
    "Universe",
    "UniverseSolver",
    "get_solver",
    "promise_are_equal",
    "promise_is_subset_of",
    "promise_are_pairwise_disjoint",
    "register_subset",
    "are_equal",
    "is_subset",
    "are_disjoint",
]
