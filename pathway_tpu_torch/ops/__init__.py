"""The port's numeric plane: attention, distances, top-k (sharded over a
mesh too), segment reductions, the IVF-PQ search (`ivf`) and the batched
reranker (`rerank`)."""

from pathway_tpu_torch.ops.attention import fused_qkv_attention, reference_attention
from pathway_tpu_torch.ops.distances import (
    cosine_distances,
    dot_products,
    l2_distances,
    normalize,
)
from pathway_tpu_torch.ops.ivf import (
    IvfPqArrays,
    build_ivf_pq,
    ivf_pq_search,
)
from pathway_tpu_torch.ops.segment import segment_reduce
from pathway_tpu_torch.ops.topk import (
    QuantizedDocs,
    TopKResult,
    knn_search,
    knn_search_masked,
    knn_search_quantized,
    knn_search_sharded,
    make_knn_searcher,
    quantize_docs,
    update_quantized_docs,
)

__all__ = [
    "IvfPqArrays",
    "QuantizedDocs",
    "TopKResult",
    "build_ivf_pq",
    "cosine_distances",
    "dot_products",
    "fused_qkv_attention",
    "ivf_pq_search",
    "knn_search",
    "knn_search_masked",
    "knn_search_quantized",
    "knn_search_sharded",
    "l2_distances",
    "make_knn_searcher",
    "normalize",
    "quantize_docs",
    "reference_attention",
    "segment_reduce",
    "update_quantized_docs",
]
