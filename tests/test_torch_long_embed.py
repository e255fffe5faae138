"""Long-chunk RAG ingest on the port against the JAX package, on the CPU.

The JAX package's default encoder width (``TransformerConfig()``: vocab
32768, d_model 512, 8 heads, d_ff 2048, max_len 512), cut to 2 layers,
encodes sequences at the s 256 and s 512 buckets that 500-token chunks
fill; then a ``DocumentStore`` with the default ``TokenCountSplitter()``
(50 to 500 tokens; word counts, since tiktoken would fetch its encoding
over the network) and a ``max_len 512`` embedder ingests long and short
documents in both packages. Parameters are drawn by ``jax.random`` and
carried across with ``params_from_numpy``. On the card the same path runs
through the attention kernel (``chip_smoke.py``'s ``long_embed``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu.models import transformer as jtfm
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm
from tests.test_torch_parity import align_row_ids

REPO = Path(__file__).resolve().parent.parent
# TransformerConfig()'s widths, 2 layers
DEFAULT_WIDTH = dict(vocab_size=32768, d_model=512, n_heads=8, n_layers=2, d_ff=2048, max_len=512)
# a narrow embedder at the same context, for the pipelines
STORE_EMB = dict(vocab_size=1024, d_model=64, n_heads=2, n_layers=1, d_ff=128, max_len=512, embed_dim=32)
DIST_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    align_row_ids()
    yield
    JAX_G.clear()
    PORT_G.clear()


def test_default_config_is_the_jax_packages():
    """The port's TransformerConfig() is the JAX package's, field by
    field: the width this file runs."""
    j, t = jtfm.TransformerConfig(), ttfm.TransformerConfig()
    for field in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_len", "embed_dim"):
        assert getattr(j, field) == getattr(t, field)
    assert {k: getattr(t, k) for k in DEFAULT_WIDTH if k != "n_layers"} == {
        k: v for k, v in DEFAULT_WIDTH.items() if k != "n_layers"
    }


@pytest.mark.parametrize("s", [256, 512])
def test_default_width_encoder_matches_jax_at_long_buckets(s):
    """f32 at the default width: the port's encoder (its attention the
    plain version on the CPU, the kernel on the card) against the JAX
    encoder, rows of every length up to s with one full row; f32 sums in
    another order, within 1e-5 on unit-norm embeddings."""
    jcfg = jtfm.embedder_config(dtype=jnp.float32, **DEFAULT_WIDTH)
    tcfg = ttfm.embedder_config(dtype=torch.float32, **DEFAULT_WIDTH)
    jp = jtfm.init_params(jax.random.PRNGKey(9), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(s)
    ids = rng.integers(2, DEFAULT_WIDTH["vocab_size"], (3, s)).astype(np.int32)
    lens = np.array([s, s // 2 + 1, 7])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    ref = np.asarray(jtfm.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    got = ttfm.encode(tp, torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg).numpy()
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _documents(n: int, seed: int = 0) -> list[str]:
    """Windows of the repo's own prose: half short (one chunk), half
    long (chunks of up to 500 words), each with an id token of its own."""
    words = []
    for name in ("PAPER.md", "SURVEY.md"):
        words += (REPO / name).read_text(encoding="utf-8").split()
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        length = int(rng.integers(40, 121) if i % 2 == 0 else rng.integers(300, 901))
        start = int(rng.integers(0, len(words) - length))
        docs.append(" ".join(words[start:start + length]) + f" doc{i:04d}")
    return docs


def _store(pkg: str, docs: list[str], questions: list[str], k: int):
    """The ingest on `pkg`: the chunks the store holds and each
    question's top-k as (distance, text) after the re-sort."""
    import importlib

    pw = importlib.import_module(pkg)
    DocumentStore = importlib.import_module(f"{pkg}.xpacks.llm.document_store").DocumentStore
    splitters = importlib.import_module(f"{pkg}.xpacks.llm.splitters")
    knn = importlib.import_module(f"{pkg}.stdlib.indexing").BruteForceKnnFactory
    jcfg = jtfm.embedder_config(dtype=jnp.float32, **STORE_EMB)
    jp = jtfm.init_params(jax.random.PRNGKey(11), jcfg)
    if pkg == "pathway_tpu":
        from pathway_tpu.xpacks.llm.embedders import JaxEmbedder

        embedder, factory_kw = JaxEmbedder(config=jcfg, params=jp), {}
    else:
        tcfg = ttfm.embedder_config(dtype=torch.float32, **STORE_EMB)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        embedder, factory_kw = pw.TorchEmbedder(tcfg, tp, device="cpu"), {"device": "cpu"}
    rows = [(d.encode(), {"path": f"doc{i}.txt"}) for i, d in enumerate(docs)]
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), rows)
    store = DocumentStore(
        table,
        retriever_factory=knn(dimensions=STORE_EMB["embed_dim"], embedder=embedder, **factory_kw),
        splitter=splitters.TokenCountSplitter(tokenize_fn=str.split),
    )
    rq = pw.debug.table_from_rows(DocumentStore.RetrieveQuerySchema, [(q, k, None, None) for q in questions])
    retrieved = rq.select(query=rq.query).with_columns(result=store.retrieve_query(rq).result)
    chunks: dict = {}
    results: dict = {}

    def on_chunk(key, row, time, is_addition):
        chunks[row["text"]] = chunks.get(row["text"], 0) + (1 if is_addition else -1)

    def on_result(key, row, time, is_addition):
        if is_addition:
            items = row["result"].value
            results[row["query"]] = sorted((float(d["dist"]), d["text"]) for d in items)

    pw.io.subscribe(store.chunked_docs, on_change=on_chunk)
    pw.io.subscribe(retrieved, on_change=on_result)
    pw.run()
    return {c: n for c, n in chunks.items() if n}, results


def test_document_store_with_500_token_chunks_matches_jax():
    """Both packages split the same documents into the same chunks, some
    past 256 tokens (the s 512 bucket), and return the same top-4 chunks
    for 8 questions, distances within 1e-4 (f32 embeddings, sums in
    another order)."""
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    docs = _documents(12)
    rng = np.random.default_rng(1)
    questions = []
    for i in rng.choice(len(docs), 8, replace=False):
        words = docs[i].split()
        start = int(rng.integers(0, len(words) - 12))
        questions.append(" ".join(words[start:start + 12]))
    port_chunks, port = _store("pathway_tpu_torch", docs, questions, 4)
    jax_chunks, ref = _store("pathway_tpu", docs, questions, 4)
    assert port_chunks == jax_chunks
    tok = HashTokenizer(vocab_size=STORE_EMB["vocab_size"], max_len=512)
    assert max(len(tok.tokenize(c)) for c in port_chunks) > 256
    assert sorted(port) == sorted(ref) == sorted(questions)
    for q in questions:
        assert [t for _, t in port[q]] == [t for _, t in ref[q]], q
        np.testing.assert_allclose([d for d, _ in port[q]], [d for d, _ in ref[q]], atol=DIST_ATOL)
