"""pw.xpacks.llm — the RAG stack: embedders, chats, splitters, parsers,
DocumentStore, QA pipelines, REST servers.

Counterpart of ``pathway_tpu/xpacks/llm/``. The model paths (the
embedder and the chat, the encoder reranker and the vector store's
default embedder) run on the CUDA card through the port's own models.
"""

from pathway_tpu_torch.xpacks.llm import (
    embedders,
    llms,
    parsers,
    prompts,
    question_answering,
    rerankers,
    servers,
    splitters,
    vector_store,
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
    "rerankers",
    "servers",
    "splitters",
    "vector_store",
    "DocumentStore",
    "SlidesDocumentStore",
    "TorchEmbedder",
    "TorchLMChat",
    "bucket_len",
    "pad_left_rows",
]
