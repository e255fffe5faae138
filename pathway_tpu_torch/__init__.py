"""PyTorch/CUDA port of pathway_tpu's numeric plane, for NVIDIA Hopper.

The JAX package ``pathway_tpu`` is the reference this package is held
against; this package imports neither it nor JAX. Its slices so far are
the live-RAG embed-and-retrieve path (the hash tokenizer, the flagship
encoder with its fused attention kernel ``csrc/attention.cu``, the KNN
slab index and the embedder that feeds it), answer generation (the
causal LM with its KV cache, continuous batching and the chat model) and
the approximate tier (``pathway_tpu_torch.indexing``: the incremental
IVF-PQ index and the reranked two-stage wrapper).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

from pathway_tpu_torch.engine.device_plane import get_device_plane, resolve_device
from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat
from pathway_tpu_torch.models.transformer import TransformerEncoder, TransformerLM

__all__ = [
    "TorchEmbedder",
    "TorchLMChat",
    "TransformerEncoder",
    "TransformerLM",
    "VectorSlabIndex",
    "get_device_plane",
    "resolve_device",
]
