"""The port's vector-store server, rerankers and encoder routes against the
JAX package's.

* ``VectorStoreServer`` / ``SlidesVectorStoreServer`` / ``VectorStoreClient``
  (``xpacks/llm/vector_store.py``): the cases of
  ``tests/test_vector_store.py`` on the port, each retrieval also run
  through the JAX package's server on the same mock embeddings and held
  to it (the same texts and metadata in the same order, distances within
  2^-7: both search a bf16 mirror of the slab). The server's index lives
  where the port's entry points put it, on the CUDA card; here a fixture
  resolves that default to the CPU, as a caller with no card asks.
* ``xpacks/llm/rerankers.py``: the reranker rows of
  ``tests/test_llm_components_matrix.py``, and ``EncoderReranker`` on the
  JAX package's carried f32 parameters, scores within 1e-5.
* The encoder's attention route (ROADMAP C1): ``TransformerConfig``'s
  fields against the JAX package's, and ``fused_attention=False`` encodes
  through ``reference_attention`` as the JAX package's config does.
* ``VectorSlabIndex(approx=True)`` (ROADMAP C2) on the corpus of
  ``tests/test_indexing.py::test_quantized_knn_recall``.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as pw
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu.models import transformer as jtfm
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm
from pathway_tpu_torch.stdlib.indexing import host_indexes
from pathway_tpu_torch.xpacks.llm.mocks import fake_embeddings_model
from tests.test_torch_parity import align_row_ids
from pathway_tpu_torch.xpacks.llm.vector_store import (
    SlidesVectorStoreServer,
    VectorStoreClient,
    VectorStoreServer,
)

DIM = 12
DIST_ATOL = 2.0**-7
EMB = dict(vocab_size=512, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=32, embed_dim=32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    JAX_G.clear()
    PORT_G.clear()
    align_row_ids()
    real = host_indexes.resolve_device
    # the caller here has no card: the index's default device is the CPU
    monkeypatch.setattr(host_indexes, "resolve_device", lambda d=None: real("cpu" if d is None else d))
    yield
    JAX_G.clear()
    PORT_G.clear()


def _docs(pkg=pw):
    return pkg.debug.table_from_rows(
        pkg.schema_from_types(data=bytes, _metadata=object),
        [
            (b"quick brown fox", {"path": "a.txt", "b64_image": "XXXX"}),
            (b"stream processing engine", {"path": "b.txt", "b64_image": "YYYY"}),
        ],
    )


def _retrieve(server, query="quick brown fox", k=1, pkg=pw):
    queries = pkg.debug.table_from_rows(server.RetrieveQuerySchema, [(query, k, None, None)])
    df = pkg.debug.table_to_pandas(server.retrieve_query(queries), include_id=False)
    (res,) = [r.result.value if hasattr(r.result, "value") else r.result for r in df.itertuples()]
    return res


def _jax_server(make):
    """The same server built on the JAX package's classes."""
    from pathway_tpu.xpacks.llm import vector_store as jvs

    return make(jvs)


def _assert_same_results(got, want):
    assert [(d["text"], d["metadata"]) for d in got] == [(d["text"], d["metadata"]) for d in want]
    np.testing.assert_allclose([d["dist"] for d in got], [d["dist"] for d in want], atol=DIST_ATOL)


def _check_against_jax(make, query, k=2):
    got = _retrieve(make(None), query, k)
    PORT_G.clear()
    want = _retrieve(_jax_server(make), query, k, pkg=jpw)
    _assert_same_results(got, want)
    return got


def test_plain_sync_callable_embedder():
    def make(vs):
        cls, docs = (VectorStoreServer, _docs()) if vs is None else (vs.VectorStoreServer, _docs(jpw))
        return cls(docs, embedder=lambda x: fake_embeddings_model(x, DIM))

    top = _check_against_jax(make, "quick brown fox")
    assert top[0]["text"] == "quick brown fox"


def test_plain_async_callable_embedder():
    async def embed(x: str):
        return fake_embeddings_model(x, DIM)

    def make(vs):
        cls, docs = (VectorStoreServer, _docs()) if vs is None else (vs.VectorStoreServer, _docs(jpw))
        return cls(docs, embedder=embed)

    top = _check_against_jax(make, "stream processing engine")
    assert top[0]["text"] == "stream processing engine"


class _FakeLangchainEmbedder:
    """Duck-typed langchain Embeddings: aembed_documents(list) -> list."""

    async def aembed_documents(self, texts):
        return [fake_embeddings_model(t, DIM).tolist() for t in texts]


def test_from_langchain_components_embedding_only():
    def make(vs):
        cls, docs = (VectorStoreServer, _docs()) if vs is None else (vs.VectorStoreServer, _docs(jpw))
        return cls.from_langchain_components(docs, embedder=_FakeLangchainEmbedder())

    top = _check_against_jax(make, "quick brown fox")
    assert top[0]["text"] == "quick brown fox"


class _FakeLlamaEmbedding:
    async def aget_text_embedding(self, text):
        return fake_embeddings_model(text, DIM).tolist()


def test_from_llamaindex_components_embedding_only():
    def make(vs):
        cls, docs = (VectorStoreServer, _docs()) if vs is None else (vs.VectorStoreServer, _docs(jpw))
        return cls.from_llamaindex_components(docs, transformations=[_FakeLlamaEmbedding()])

    top = _check_against_jax(make, "stream processing engine")
    assert top[0]["text"] == "stream processing engine"


def test_from_llamaindex_rejects_non_embedder_tail():
    with pytest.raises(ValueError, match="embedding"):
        VectorStoreServer.from_llamaindex_components(_docs(), transformations=[object()])
    with pytest.raises(ValueError, match="empty"):
        VectorStoreServer.from_llamaindex_components(_docs(), transformations=[])


def _inputs(server, query_fn="inputs_query", base=None):
    queries = pw.debug.table_from_rows(VectorStoreServer.InputsQuerySchema, [(None, None)])
    target = base if base is not None else server
    df = pw.debug.table_to_pandas(getattr(target, query_fn)(queries), include_id=False)
    return [r.result.value if hasattr(r.result, "value") else r.result for r in df.itertuples()]


def test_slides_server_redacts_metadata():
    server = SlidesVectorStoreServer(_docs(), embedder=lambda x: fake_embeddings_model(x, DIM))
    (res,) = _inputs(server)
    assert {m["path"] for m in res} == {"a.txt", "b.txt"}
    assert all("b64_image" not in m for m in res)
    assert len(_inputs(server, "parsed_documents_query")) == 1


def test_slides_redaction_does_not_mutate_store():
    server = SlidesVectorStoreServer(_docs(), embedder=lambda x: fake_embeddings_model(x, DIM))
    _inputs(server)
    (res,) = _inputs(server, base=server.document_store)
    assert all("b64_image" in m for m in res)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_slides_redaction_served_over_rest():
    """run_server registers the subclass's endpoints: the redacted inputs
    listing is what REST clients get."""
    port = _free_port()
    server = SlidesVectorStoreServer(_docs(), embedder=lambda x: fake_embeddings_model(x, DIM))
    threading.Thread(
        target=lambda: server.run_server(host="127.0.0.1", port=port, with_cache=False),
        daemon=True,
    ).start()
    client = VectorStoreClient(host="127.0.0.1", port=port, timeout=5)
    files = None
    for _ in range(60):
        time.sleep(0.25)
        try:
            files = client.get_input_files()
            break
        except Exception:
            continue
    assert files is not None, "server did not come up"
    assert {m["path"] for m in files} == {"a.txt", "b.txt"}
    assert all("b64_image" not in m for m in files)
    hits = client.query("quick brown fox", k=1)
    assert hits[0]["text"] == "quick brown fox"
    from pathway_tpu_torch.internals import run as run_mod

    run_mod.stop_current_run()


def test_async_splitter_rejected_early():
    async def split(text):
        return [(text, {})]

    with pytest.raises(ValueError, match="synchronous"):
        VectorStoreServer(_docs(), embedder=lambda x: fake_embeddings_model(x, DIM), splitter=split)


def test_embedding_dimension_probe():
    server = VectorStoreServer(_docs(), embedder=lambda x: np.zeros(7, np.float32))
    assert server.embedder.get_embedding_dimension() == 7


def test_client_arg_validation():
    with pytest.raises(ValueError):
        VectorStoreClient(host="h", port=1, url="http://x")
    with pytest.raises(ValueError):
        VectorStoreClient()
    c = VectorStoreClient(url="http://example:123", additional_headers={"X-K": "v"})
    assert c.url == "http://example:123"
    assert c.additional_headers == {"X-K": "v"}
    assert VectorStoreClient(host="h").url == "http://h:8000"


def test_default_embedder_is_the_torch_embedder(monkeypatch):
    """With neither an embedder nor an index factory, the server embeds
    with TorchEmbedder (the seam); `ann=True` routes to the port's
    IvfPqKnnFactory."""
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import IvfPqKnnFactory
    from pathway_tpu_torch.xpacks.llm import embedders
    from pathway_tpu_torch.xpacks.llm import vector_store as tvs

    made = []

    class SmallTorchEmbedder(embedders.TorchEmbedder):
        def __init__(self):
            made.append(self)
            super().__init__(ttfm.embedder_config(**EMB), device="cpu")

    monkeypatch.setattr(embedders, "TorchEmbedder", SmallTorchEmbedder)
    server = tvs.VectorStoreServer(_docs())
    assert len(made) == 1 and server.embedder is made[0]
    top = _retrieve(server, "quick brown fox", 2)
    assert {d["text"] for d in top} == {"quick brown fox", "stream processing engine"}
    ann = tvs.VectorStoreServer(_docs(), embedder=lambda x: fake_embeddings_model(x, DIM), ann=True)
    assert isinstance(ann.document_store.retriever_factory, IvfPqKnnFactory)


# ------------------------------------------------------------- rerankers


def _carried_embedders(dtype_t=torch.float32, dtype_j=jnp.float32, **cfg):
    """JaxEmbedder and TorchEmbedder (CPU) on the same parameters."""
    from pathway_tpu.xpacks.llm.embedders import JaxEmbedder

    jcfg = jtfm.embedder_config(dtype=dtype_j, **{**EMB, **cfg})
    tcfg = ttfm.embedder_config(dtype=dtype_t, **{**EMB, **cfg})
    jp = jtfm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return JaxEmbedder(config=jcfg, params=jp), pw.TorchEmbedder(tcfg, tp, device="cpu")


def _rerank_scores(pkg, reranker, rows):
    t = pkg.debug.table_from_rows(pkg.schema_from_types(doc=str, q=str), rows)
    res = t.select(doc=t.doc, score=reranker(t.doc, t.q))
    _ids, cols = pkg.debug.table_to_dicts(res)
    return {cols["doc"][k]: cols["score"][k] for k in cols["doc"]}


RERANK_ROWS = [
    ("alpha beta gamma", "alpha beta gamma"),
    ("totally unrelated words xyz", "alpha beta gamma"),
    ("alpha beta", "alpha beta gamma"),
]


def test_encoder_reranker_prefers_similar_docs():
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    _jemb, temb = _carried_embedders()
    by_doc = _rerank_scores(pw, EncoderReranker(embedder=temb), RERANK_ROWS[:2])
    assert by_doc["alpha beta gamma"] > by_doc["totally unrelated words xyz"]


def test_encoder_reranker_scores_match_the_jax_package():
    from pathway_tpu.xpacks.llm.rerankers import EncoderReranker as JaxEncoderReranker
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    jemb, temb = _carried_embedders()
    want = _rerank_scores(jpw, JaxEncoderReranker(embedder=jemb), RERANK_ROWS)
    got = _rerank_scores(pw, EncoderReranker(embedder=temb), RERANK_ROWS)
    assert got.keys() == want.keys()
    for doc in want:
        np.testing.assert_allclose(got[doc], want[doc], atol=1e-5)


def test_encoder_reranker_default_embedder_is_the_torch_embedder(monkeypatch):
    from pathway_tpu_torch.xpacks.llm import embedders
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncoderReranker()  # the default TorchEmbedder asks for the card
    monkeypatch.setattr(
        embedders, "TorchEmbedder", lambda: embedders.BaseEmbedder.__new__(embedders.BaseEmbedder)
    )
    assert isinstance(EncoderReranker().embedder, embedders.BaseEmbedder)


def test_rerank_topk_filter_and_llm_reranker_match_the_jax_package():
    from pathway_tpu.xpacks.llm import rerankers as jrr
    from pathway_tpu_torch.xpacks.llm import rerankers as trr

    args = (["a", "b", "c"], [1.0, 3.0, 2.0], 2)
    assert trr.rerank_topk_filter.__wrapped__(*args) == jrr.rerank_topk_filter.__wrapped__(*args) == (
        ["b", "c"], [3.0, 2.0],
    )
    assert trr.rerank_topk_filter.__wrapped__([], [], 2) == ([], [])

    def rating_chat(pkg):
        class Rate(pkg.UDF):
            def __wrapped__(self, messages, **kwargs):
                prompt = messages.value[-1]["content"]
                doc = prompt.split("Document: ")[1].split("\n")[0]
                return "5" if "alpha" in doc else "1"

        return Rate()

    want = _rerank_scores(jpw, jrr.LLMReranker(rating_chat(jpw)), RERANK_ROWS)
    got = _rerank_scores(pw, trr.LLMReranker(rating_chat(pw)), RERANK_ROWS)
    assert got == want == {"alpha beta gamma": 5.0, "totally unrelated words xyz": 1.0, "alpha beta": 5.0}


def test_optional_rerankers_stay_behind_their_imports():
    import importlib.util

    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, FlashRankReranker

    if importlib.util.find_spec("sentence_transformers") is None:
        with pytest.raises(ImportError, match="sentence_transformers"):
            CrossEncoderReranker("any-model")
    if importlib.util.find_spec("flashrank") is None:
        with pytest.raises(ImportError, match="flashrank"):
            FlashRankReranker()


# ------------------------------------------------- C1: the attention route


def test_transformer_config_fields_match_the_jax_package():
    jf = [(f.name, f.default) for f in dataclasses.fields(jtfm.TransformerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttfm.TransformerConfig)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    # every default but the dtype's (a jax against a torch dtype) is equal
    assert [d for n, d in tf if n != "dtype"] == [d for n, d in jf if n != "dtype"]
    cfg = ttfm.embedder_config(fused_attention=False)
    assert cfg.fused_attention is False and cfg.seq_axis is None
    assert dataclasses.replace(cfg, fused_attention=True).fused_attention
    # sequence parallelism is ported (tests/test_torch_train.py runs it)
    assert ttfm.embedder_config(seq_axis="seq").seq_axis == "seq"


@pytest.mark.parametrize("fused", [True, False])
def test_encoder_routes_match_the_jax_package(fused, monkeypatch):
    """The same carried f32 parameters and tokens through both encoders
    with fused_attention on and off: embeddings within 1e-5. On the CPU
    the port's fused route runs the plain version as well; which
    function the config picks is what changes."""
    from pathway_tpu_torch.models import transformer as mod

    jcfg = jtfm.embedder_config(dtype=jnp.float32, fused_attention=fused, **EMB)
    tcfg = ttfm.embedder_config(dtype=torch.float32, fused_attention=fused, **EMB)
    jp = jtfm.init_params(jax.random.PRNGKey(7), jcfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, EMB["vocab_size"], (6, 32))
    mask = (np.arange(32)[None, :] < rng.integers(3, 33, 6)[:, None]).astype(np.int32)
    want = np.asarray(jtfm.encode(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    called = []
    for name in ("fused_qkv_attention", "reference_attention"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: called.append(_n) or _r(*a))
    got = ttfm.encode(tp, torch.as_tensor(ids), torch.as_tensor(mask), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert set(called) == {"fused_qkv_attention" if fused else "reference_attention"}
    assert len(called) == EMB["n_layers"]


def test_unfused_encoder_takes_sequences_past_the_kernel(monkeypatch):
    """max_len 512 with fused_attention=False: a 200-token text encodes
    through the plain route in both packages (the kernel takes s <= 128)."""
    jemb, temb = _carried_embedders(max_len=512, fused_attention=False)
    text = " ".join(f"w{i}" for i in range(200))
    got, want = temb.encode_many([text])[0], jemb.encode_many([text])[0]
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------- C2: approx slabs


def test_approx_slab_is_served_exact_on_the_quantized_recall_corpus():
    """tests/test_indexing.py::test_quantized_knn_recall's corpus: the
    port's approx=True slab returns the exact top-10 (recall 1.0, at least
    the JAX package's approx_max_k), and the same ranking as its exact
    slab."""
    from pathway_tpu.stdlib.indexing.host_indexes import VectorSlabIndex as JaxSlab
    from pathway_tpu_torch.stdlib.indexing.host_indexes import VectorSlabIndex

    rng = np.random.default_rng(7)
    docs = rng.normal(size=(5000, 64)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    approx = VectorSlabIndex(dimensions=64, device="cpu", approx=True)
    exact = VectorSlabIndex(dimensions=64, device="cpu")
    ref = JaxSlab(dimensions=64, approx=True)
    from pathway_tpu.internals.keys import Key

    for i, v in enumerate(docs):
        for index in (approx, exact, ref):
            index.add(Key(i), v)
    items = [(q[i], 10, None) for i in range(8)]
    got, plain, want = approx.search_batch(items), exact.search_batch(items), ref.search_batch(items)
    assert got == plain
    truth = np.argsort(-(q @ docs.T), axis=1, kind="stable")[:, :10]

    def recall(res):
        return np.mean([len({k.value for k, _ in r} & set(truth[i].tolist())) / 10 for i, r in enumerate(res)])

    assert recall(got) >= recall(want) and recall(got) >= 0.9


def test_usearch_knn_builds_an_approx_slab():
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import UsearchKnn

    t = pw.debug.table_from_rows(pw.schema_from_types(v=object), [((1.0, 0.0),)])
    index = UsearchKnn(data_column=t.v, dimensions=2, device="cpu")._host_index_factory()()
    assert isinstance(index, host_indexes.VectorSlabIndex) and index.approx
