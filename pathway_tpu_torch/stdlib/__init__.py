"""pw standard library (reference: python/pathway/stdlib/).

Counterpart of ``pathway_tpu/stdlib/__init__.py``, with the same
subpackages; ``viz`` is imported on its own, as in the reference.
"""

from pathway_tpu_torch.stdlib import (
    graphs,
    indexing,
    ml,
    ordered,
    stateful,
    statistical,
    temporal,
    utils,
)

__all__ = [
    "graphs", "indexing", "ml", "ordered", "stateful", "statistical",
    "temporal", "utils",
]
