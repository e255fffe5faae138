"""LLM extension pack of the port: the text embedder."""

from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder, bucket_len, pad_left_rows

__all__ = ["TorchEmbedder", "bucket_len", "pad_left_rows"]
