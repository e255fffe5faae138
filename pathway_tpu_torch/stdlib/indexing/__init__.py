"""Vector indexes of the port."""

from pathway_tpu_torch.stdlib.indexing.host_indexes import HostIndex, VectorSlabIndex
from pathway_tpu_torch.stdlib.indexing.reranking import RerankedSlabIndex

__all__ = ["HostIndex", "RerankedSlabIndex", "VectorSlabIndex"]
