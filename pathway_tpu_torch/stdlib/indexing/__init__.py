"""Vector indexes of the port."""

from pathway_tpu_torch.stdlib.indexing.host_indexes import HostIndex, VectorSlabIndex

__all__ = ["HostIndex", "VectorSlabIndex"]
