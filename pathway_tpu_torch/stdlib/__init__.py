"""pw standard library (reference: python/pathway/stdlib/).

Counterpart of ``pathway_tpu/stdlib/__init__.py``. ``graphs``, ``ml``,
``stateful``, ``statistical`` and ``viz`` wait for a later slice of the
port (ROADMAP.md).
"""

from pathway_tpu_torch.stdlib import (
    indexing,
    ordered,
    temporal,
    utils,
)

__all__ = [
    "indexing", "ordered", "temporal", "utils",
]
