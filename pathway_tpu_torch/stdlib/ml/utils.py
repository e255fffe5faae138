"""ML utilities.

Reference parity: stdlib/ml/utils.py (classifier_accuracy :13,
_predict_asof_now :34). The reference's asof-now prediction trick
(forget-immediately query passthrough) is built into this framework's
index layer — `DataIndex.query_as_of_now` / the external-index operator's
asof_now mode — so prediction functions here use those directly.
"""

from __future__ import annotations

from typing import Any


def classifier_accuracy(predicted_labels: Any, exact_labels: Any) -> Any:
    """Counts matching / non-matching predictions.

    `predicted_labels` must carry `predicted_label` keyed like
    `exact_labels`' rows carry `label`. Returns Table(cnt, value) with one
    row per match-boolean (reference :13).
    """
    import pathway_tpu_torch as pw

    comparative = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.ix(predicted_labels.id).label,
    )
    flagged = comparative.select(
        match=comparative.label == comparative.predicted_label
    )
    return flagged.groupby(flagged.match).reduce(
        cnt=pw.reducers.count(),
        value=flagged.match,
    )


__all__ = ["classifier_accuracy"]
