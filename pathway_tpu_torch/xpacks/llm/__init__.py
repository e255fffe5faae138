"""pw.xpacks.llm — the RAG stack: embedders, chats, splitters, parsers,
DocumentStore, QA pipelines, REST servers.

Counterpart of ``pathway_tpu/xpacks/llm/``. The model paths (the
embedder and the chat) run on the CUDA card through the port's own
models. ``rerankers`` and ``vector_store`` wait for a later slice.
"""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    question_answering,
    servers,
    splitters,
)
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore, SlidesDocumentStore
from pathway_tpu_torch.xpacks.llm.embedders import TorchEmbedder, bucket_len, pad_left_rows
from pathway_tpu_torch.xpacks.llm.llms import TorchLMChat

__all__ = [
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "question_answering",
    "servers",
    "splitters",
    "DocumentStore",
    "SlidesDocumentStore",
    "TorchEmbedder",
    "TorchLMChat",
    "bucket_len",
    "pad_left_rows",
]
