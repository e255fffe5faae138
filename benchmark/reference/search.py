"""Exact search: the k rows of a slab most similar to each query by
inner product, ties broken by the lower row index, in NumPy f64. The
plain counterpart of the port's exact search
(``pathway_tpu_torch/ops/topk.py:32`` ``knn_search`` at commit a5f5f3e,
by inner product) for a retrieval cell; no cell compares with it yet."""

from __future__ import annotations

import numpy as np


def exact_topk(queries: np.ndarray, docs: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(scores, indices), each [q, k], best first."""
    scores = np.asarray(queries, np.float64) @ np.asarray(docs, np.float64).T
    order = np.lexsort((np.broadcast_to(np.arange(scores.shape[1]), scores.shape), -scores), axis=-1)[:, :k]
    return np.take_along_axis(scores, order, axis=-1), order
