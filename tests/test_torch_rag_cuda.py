"""The live-RAG pipeline through the port's engine on the card, held to the
same pipeline on the CPU.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_rag_cuda.py -q

Without a card every test skips. Both runs embed with the same random
weights (seed 0); on the card each embed dispatch launches the attention
kernel, on the CPU the encoder runs its plain attention. The bf16
encoder rounds at other points on the two devices, so a chunk's score may
move by a few bf16 ulps: scores agree within 2^-6, and two chunks may swap
ranks only where their scores lie within that of each other.
"""

import asyncio

import numpy as np
import pytest
import torch

import pathway_tpu_torch as pw
from pathway_tpu_torch import TorchEmbedder, TorchLMChat
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.models.transformer import embedder_config, lm_config
from pathway_tpu_torch.ops import _build
from pathway_tpu_torch.ops.attention import KERNEL
from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

pytestmark = pytest.mark.cuda
# head_dim 32: a width the attention kernel takes
EMB = dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32, embed_dim=32)
LM = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64)
SCORE_ATOL = 2.0**-6


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: these tests run the attention kernel inside the engine")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clear_graph():
    G.clear()
    yield
    G.clear()


def _corpus(n_docs: int, n_q: int, seed: int = 4):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
    docs = [((" ".join(rng.choice(words, 24))).encode(), {"path": f"d{i}.txt"}) for i in range(n_docs)]
    questions = [" ".join(rng.choice(words, 6)) for _ in range(n_q)]
    return docs, questions


def _retrieve(device, docs, questions, k: int = 4):
    emb = TorchEmbedder(embedder_config(**EMB), device=device)
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), docs)
    store = DocumentStore(table, retriever_factory=BruteForceKnnFactory(
        dimensions=EMB["embed_dim"], embedder=emb, device=device))
    rq = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema, [(q, k, None, None, 2, 1) for q in questions], is_stream=True,
    )
    retrieved = rq.select(query=rq.query).with_columns(result=store.retrieve_query(rq).result)
    out: dict = {}
    pw.io.subscribe(retrieved, on_change=lambda key, row, time, is_addition: out.__setitem__(
        row["query"], sorted((float(d["dist"]), d["metadata"]["path"]) for d in row["result"].value)))
    _build.reset_launch_counts()
    d0 = emb.dispatches
    pw.run()
    G.clear()
    return out, _build.LAUNCHES.get(KERNEL, 0), emb.dispatches - d0


def test_rag_retrieval_on_the_card_matches_the_cpu(cuda_device):
    docs, questions = _corpus(256, 24)
    got, launches, dispatches = _retrieve(cuda_device, docs, questions)
    want, cpu_launches, _ = _retrieve(torch.device("cpu"), docs, questions)
    assert launches > 0 and launches == EMB["n_layers"] * dispatches and cpu_launches == 0
    assert set(got) == set(want) == set(questions)
    for q in questions:
        g, w = got[q], want[q]
        assert len(g) == len(w) == 4
        # rank by rank: where the chunks differ, their scores lie within
        # SCORE_ATOL of each other (a near-tie), as everywhere else
        for (gd, _gp), (wd, _wp) in zip(g, w):
            assert abs(gd - wd) <= SCORE_ATOL, (q, g, w)


def test_rag_answers_on_the_card(cuda_device):
    """The whole pipeline on the card: every question gets one answer,
    each answer is the chat's own output for its prompt, and the embeds
    went through the kernel."""
    docs, questions = _corpus(64, 16, seed=7)
    emb = TorchEmbedder(embedder_config(**EMB), device=cuda_device)
    chat = TorchLMChat(lm_config(dtype=torch.float32, **LM), max_new_tokens=8, device=cuda_device)
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), docs)
    store = DocumentStore(table, retriever_factory=BruteForceKnnFactory(
        dimensions=EMB["embed_dim"], embedder=emb, device=cuda_device))
    answerer = BaseRAGQuestionAnswerer(chat, store, search_topk=3)
    q_rows = [(q, None, False, 2 * (i // 4) + 2, 1) for i, q in enumerate(questions)]
    queries = pw.debug.table_from_rows(answerer.AnswerQuerySchema, q_rows, is_stream=True)
    answers = answerer.answer_query(queries)
    got: list = []
    pw.io.subscribe(answers, on_change=lambda key, row, time, is_addition: got.append(row["result"].value["response"]))
    prompts: list = []
    submit = chat._cb.submit
    chat._cb.submit = lambda p: prompts.append(p) or submit(p)
    _build.reset_launch_counts()
    pw.run()
    chat._cb.submit = submit
    assert len(got) == len(questions) == len(prompts)
    assert _build.LAUNCHES.get(KERNEL, 0) > 0

    async def direct():
        return await asyncio.gather(*(chat.__wrapped__(p) for p in prompts))

    assert sorted(asyncio.run(direct())) == sorted(got)
    chat._cb.drain()
