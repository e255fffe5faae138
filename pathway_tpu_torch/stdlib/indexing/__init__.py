"""pw.indexing — the index layer: KNN / BM25 / hybrid retrieval + sorting.

Counterpart of ``pathway_tpu/stdlib/indexing/__init__.py`` (reference
parity: python/pathway/stdlib/indexing/__init__.py). The vector backends
are the port's: the bf16 slab mirror with a masked matmul + top-k on the
CUDA card (host_indexes.py), the incremental IVF-PQ index
(``pathway_tpu_torch/indexing/ann.py``) and its reranked wrapper.
"""

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25, TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.colnames import (
    _INDEX_REPLY,
    _INDEX_REPLY_ID,
    _INDEX_REPLY_SCORE,
    _MATCHED_ID,
    _SCORE,
)
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex
from pathway_tpu_torch.stdlib.indexing.full_text_document_index import (
    default_full_text_document_index,
)
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex, HybridIndexFactory
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    IvfPqKnn,
    IvfPqKnnFactory,
    LshKnn,
    LshKnnFactory,
    USearchMetricKind,
    UsearchKnn,
    UsearchKnnFactory,
)
from pathway_tpu_torch.stdlib.indexing.reranking import RerankedSlabIndex
from pathway_tpu_torch.stdlib.indexing.retrievers import (
    InnerIndex,
    InnerIndexFactory,
    build_index_query,
)
from pathway_tpu_torch.stdlib.indexing.sorting import (
    build_sorted_index,
    retrieve_prev_next_values,
    sort_from_index,
)
from pathway_tpu_torch.stdlib.indexing.vector_document_index import (
    VectorDocumentIndex,
    default_brute_force_knn_document_index,
    default_ivf_pq_knn_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

# reference-compat alias (reference class is named USearchKnn)
USearchKnn = UsearchKnn

__all__ = [
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "UsearchKnn",
    "USearchKnn",
    "UsearchKnnFactory",
    "USearchMetricKind",
    "IvfPqKnn",
    "IvfPqKnnFactory",
    "RerankedSlabIndex",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "VectorDocumentIndex",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_ivf_pq_knn_document_index",
    "default_usearch_knn_document_index",
    "default_lsh_knn_document_index",
    "default_full_text_document_index",
    "build_index_query",
    "build_sorted_index",
    "sort_from_index",
    "retrieve_prev_next_values",
]
