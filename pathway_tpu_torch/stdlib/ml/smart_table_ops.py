"""Fuzzy joins: match rows across tables by shared weighted features.

Reference parity: stdlib/ml/smart_table_ops/_fuzzy_join.py
(fuzzy_match_tables :106, smart_fuzzy_match :199, fuzzy_self_match :249,
fuzzy_match :265, fuzzy_match_with_hint :282). Same model: rows project
to features (word tokens or letters), features weigh inversely to their
frequency, candidate pairs score by summed shared-feature weight, and a
one-to-one matching keeps, per round, the pairs that are the heaviest
for BOTH endpoints — here the rounds run in the engine's incremental
iterate loop, so streaming updates re-match only the affected rows.
"""

from __future__ import annotations

import math
import re
from enum import IntEnum
from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = 0
    TOKENIZE = 1
    LETTERS = 2

    def generate(self) -> Callable[[Any], list[str]]:
        if self in (FuzzyJoinFeatureGeneration.AUTO, FuzzyJoinFeatureGeneration.TOKENIZE):
            return lambda text: _TOKEN_RE.findall(str(text).lower())
        return lambda text: [c for c in str(text).lower() if not c.isspace()]


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = 1
    LOGWEIGHT = 2
    NONE = 3

    def normalize(self) -> Callable[[float], float]:
        if self is FuzzyJoinNormalization.WEIGHT:
            return lambda cnt: 1.0 / cnt if cnt else 0.0
        if self is FuzzyJoinNormalization.LOGWEIGHT:
            return lambda cnt: 1.0 / math.log(1.0 + cnt) if cnt else 0.0
        return lambda cnt: 1.0


def _features(table: Table, projection: dict[str, str] | None, gen: Callable) -> Table:
    import pathway_tpu_torch as pw

    names = [
        n for n in table._column_names()
        if projection is None or projection.get(n, "") != "skip"
    ]

    @pw.udf(deterministic=True)
    def to_features(*vals) -> list:
        out: list[str] = []
        for v in vals:
            if v is not None:
                out.extend(gen(v))
        return out

    feats = table.select(
        node=table.id, fs=to_features(*[table[n] for n in names])
    ).flatten(pw.this.fs)
    return feats.select(feats.node, feature=feats.fs)


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    by_hand_match: Table | None = None,
    left_projection: dict[str, str] | None = None,
    right_projection: dict[str, str] | None = None,
    feature_generation: FuzzyJoinFeatureGeneration = FuzzyJoinFeatureGeneration.AUTO,
    normalization: FuzzyJoinNormalization = FuzzyJoinNormalization.WEIGHT,
    _exclude_same_id: bool = False,
) -> Table:
    """One-to-one fuzzy matching between two tables.

    Returns Table(left: Pointer, right: Pointer, weight: float). With
    `by_hand_match` (Table(left, right, weight)), those pairs are forced
    and their endpoints excluded from automatic matching (reference
    fuzzy_match_with_hint :282).
    """
    import pathway_tpu_torch as pw

    gen = feature_generation.generate()
    norm = normalization.normalize()
    lfeat = _features(left_table, left_projection, gen)
    rfeat = _features(right_table, right_projection, gen)

    # inverse-frequency feature weights over both sides
    both = lfeat.select(lfeat.feature).concat_reindex(rfeat.select(rfeat.feature))
    counts = both.groupby(both.feature).reduce(
        both.feature, cnt=pw.reducers.count()
    )

    @pw.udf(deterministic=True)
    def weigh(cnt: int) -> float:
        return norm(float(cnt))

    weighted = counts.select(counts.feature, w=weigh(counts.cnt))

    pairs = lfeat.join(rfeat, lfeat.feature == rfeat.feature).select(
        left=pw.left.node, right=pw.right.node, feature=pw.left.feature
    )
    scored = (
        pairs.join(weighted, pairs.feature == weighted.feature)
        .select(left=pw.left.left, right=pw.left.right, w=pw.right.w)
        .groupby(pw.this.left, pw.this.right)
        .reduce(pw.this.left, pw.this.right, weight=pw.reducers.sum(pw.this.w))
        .with_id_from(pw.this.left, pw.this.right)
    )
    if _exclude_same_id:
        # self-matching: a row is trivially its own best match and would
        # consume both endpoints — drop identity pairs BEFORE matching
        scored = scored.filter(pw.this.left != pw.this.right)

    seed = None
    if by_hand_match is not None:
        seed = by_hand_match.select(
            by_hand_match.left, by_hand_match.right, by_hand_match.weight
        ).with_id_from(pw.this.left, pw.this.right)
        # hinted endpoints are spoken for: exclude their candidate pairs
        # so the one-to-one contract holds from round 1
        sl = seed.groupby(pw.this.left).reduce(pw.this.left).with_id_from(pw.this.left)
        sr = seed.groupby(pw.this.right).reduce(pw.this.right).with_id_from(pw.this.right)
        scored = scored.filter(
            sl.ix(pw.cast(pw.Pointer, pw.this.left), optional=True).left.is_none()
            & sr.ix(pw.cast(pw.Pointer, pw.this.right), optional=True).right.is_none()
        )

    def matching_round(cands: Table, matched: Table) -> dict[str, Table]:
        # heaviest pair per endpoint; keep pairs best for BOTH sides
        best_l = cands.groupby(cands.left).reduce(
            pick=pw.reducers.argmax(cands.weight)
        )
        best_r = cands.groupby(cands.right).reduce(
            pick=pw.reducers.argmax(cands.weight)
        )
        bl = best_l.with_id(best_l.pick).select(flag_l=True)
        br = best_r.with_id(best_r.pick).select(flag_r=True)
        mutual = cands.intersect(bl).intersect(br)
        new_matched = matched.update_rows(
            mutual.select(mutual.left, mutual.right, mutual.weight)
        )
        ml = new_matched.groupby(pw.this.left).reduce(pw.this.left).with_id_from(pw.this.left)
        mr = new_matched.groupby(pw.this.right).reduce(pw.this.right).with_id_from(pw.this.right)
        remaining = cands.filter(
            ml.ix(pw.cast(pw.Pointer, pw.this.left), optional=True).left.is_none()
            & mr.ix(pw.cast(pw.Pointer, pw.this.right), optional=True).right.is_none()
        )
        return {"cands": remaining, "matched": new_matched}

    init_matched = (
        seed
        if seed is not None
        else scored.filter(pw.this.weight < -1.0)  # empty, same schema
    )
    result = pw.iterate(matching_round, cands=scored, matched=init_matched)
    return result.matched


def smart_fuzzy_match(
    left_col: Any, right_col: Any, **kwargs: Any
) -> Table:
    """Column-pair convenience wrapper (reference :199): match the rows of
    the two columns' tables by the columns' contents."""
    left = left_col.table.select(data=left_col)
    right = right_col.table.select(data=right_col)
    out = fuzzy_match_tables(left, right, **kwargs)
    return out


def fuzzy_self_match(table: Table, projection: dict[str, str] | None = None, **kwargs: Any) -> Table:
    """Match a table against itself, excluding trivial self-pairs
    (reference :249)."""
    return fuzzy_match_tables(
        table, table, left_projection=projection, right_projection=projection,
        _exclude_same_id=True,
        **kwargs,
    )


def fuzzy_match(left_col: Any, right_col: Any, **kwargs: Any) -> Table:
    """Alias of smart_fuzzy_match over explicit columns (reference :265)."""
    return smart_fuzzy_match(left_col, right_col, **kwargs)


def fuzzy_match_with_hint(
    left_col: Any, right_col: Any, by_hand_match: Table, **kwargs: Any
) -> Table:
    """Fuzzy match with hand-forced pairs (reference :282)."""
    return smart_fuzzy_match(
        left_col, right_col, by_hand_match=by_hand_match, **kwargs
    )


__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "fuzzy_match_tables",
    "smart_fuzzy_match",
    "fuzzy_self_match",
    "fuzzy_match",
    "fuzzy_match_with_hint",
]
