"""pathway_tpu_torch.indexing — approximate-nearest-neighbor indexes
maintained incrementally.

Counterpart of ``pathway_tpu/indexing/__init__.py``: the IVF-PQ index
(`ann.py`, over `pathway_tpu_torch/ops/ivf.py`) with its hot/warm/cold
list tiers (`tiers.py`) and the reranked two-stage wrapper, beside the
port's stdlib index layer, which this package re-exports.

Kill switch: ``PATHWAY_ANN=0`` forces every ANN-configured call site back
to the exact slab search; ``PATHWAY_ANN=1`` also flips opt-in call sites
(``make_knn_searcher``) whose default is exact.
"""

from __future__ import annotations

import os

from pathway_tpu_torch.stdlib.indexing import *  # noqa: F401,F403
from pathway_tpu_torch.stdlib.indexing import __all__ as _stdlib_all

from pathway_tpu_torch.indexing.ann import IvfPqIndex
from pathway_tpu_torch.indexing.tiers import (  # noqa: F401
    TIER_COLD,
    TIER_HOT,
    TIER_NAMES,
    TIER_WARM,
    TierState,
    tiered_enabled,
    verify_tier_state,
)

__all__ = [
    "IvfPqIndex",
    "ann_enabled",
    "tiered_enabled",
    "TierState",
    "TIER_HOT",
    "TIER_WARM",
    "TIER_COLD",
    "TIER_NAMES",
    "verify_tier_state",
    *_stdlib_all,
]


def ann_enabled(default: bool = True) -> bool:
    """The PATHWAY_ANN kill switch. `default` is what the call site
    wants when the env var is unset: an explicitly ANN-configured
    retriever passes True (env can only veto), an exact-by-default path
    like `make_knn_searcher` passes False (env can opt in)."""
    v = os.environ.get("PATHWAY_ANN")
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "")
