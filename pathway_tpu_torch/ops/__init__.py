"""The port's numeric plane: attention, distances, top-k, the IVF-PQ
search (`ivf`) and the batched reranker (`rerank`)."""

from pathway_tpu_torch.ops.attention import fused_qkv_attention, reference_attention
from pathway_tpu_torch.ops.distances import (
    cosine_distances,
    dot_products,
    l2_distances,
    normalize,
)
from pathway_tpu_torch.ops.topk import (
    QuantizedDocs,
    TopKResult,
    knn_search,
    knn_search_masked,
    knn_search_quantized,
    make_knn_searcher,
    quantize_docs,
    update_quantized_docs,
)

__all__ = [
    "QuantizedDocs",
    "TopKResult",
    "cosine_distances",
    "dot_products",
    "fused_qkv_attention",
    "knn_search",
    "knn_search_masked",
    "knn_search_quantized",
    "l2_distances",
    "make_knn_searcher",
    "normalize",
    "quantize_docs",
    "reference_attention",
    "update_quantized_docs",
]
