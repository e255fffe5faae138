"""LLM extension pack of the port: the text embedder and the chat model."""

from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder, bucket_len, pad_left_rows
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

__all__ = ["TorchEmbedder", "TorchLMChat", "bucket_len", "pad_left_rows"]
