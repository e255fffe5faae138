"""The live-RAG pipeline on the port against the same pipeline on the JAX
package.

bench.py's config-4 rung (``bench.py:713-785``: ``DocumentStore`` over
``BruteForceKnnFactory`` with the model embedder, ``BaseRAGQuestionAnswerer``
over the model chat, questions streamed in waves) and the app of
``examples/adaptive_rag/app.py``, at a small size on the CPU:
``embedder_config(vocab 512, d_model 32, ...)`` and ``lm_config(vocab 256,
d_model 16, ...)``, the same parameters in both packages (drawn by
``jax.random``, carried across with ``params_from_numpy``).

Retrieval is compared at the (score, key) re-sort seam: each result list
is sorted by (distance, document path), and the distances agree within
1e-4 (both packages score the same f32 embeddings against a bf16 mirror
with f32 sums). At f32 the answers are equal strings; with the mocks the
answer tables are equal bytes.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JAX_G
from pathway_tpu.models import transformer as jtfm
from pathway_tpu_torch.internals.parse_graph import G as PORT_G
from pathway_tpu_torch.models import convert
from pathway_tpu_torch.models import transformer as ttfm

REPO = Path(__file__).resolve().parent.parent
EMB = dict(vocab_size=512, d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=32, embed_dim=32)
LM = dict(vocab_size=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64)
DIST_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clear_graphs():
    JAX_G.clear()
    PORT_G.clear()
    yield
    JAX_G.clear()
    PORT_G.clear()


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _models(pkg: str):
    """(embedder, chat) of `pkg` at f32 on the same parameters."""
    jecfg = jtfm.embedder_config(dtype=jnp.float32, **EMB)
    jlcfg = jtfm.lm_config(dtype=jnp.float32, **LM)
    jep = jtfm.init_params(jax.random.PRNGKey(4), jecfg)
    jlp = jtfm.init_params(jax.random.PRNGKey(5), jlcfg)
    if pkg == "pathway_tpu":
        from pathway_tpu.xpacks.llm.embedders import JaxEmbedder
        from pathway_tpu.xpacks.llm.llms import JaxLMChat

        return JaxEmbedder(config=jecfg, params=jep), JaxLMChat(config=jlcfg, params=jlp, max_new_tokens=8)
    tecfg = ttfm.embedder_config(dtype=torch.float32, **EMB)
    tlcfg = ttfm.lm_config(dtype=torch.float32, **LM)
    tep = convert.params_from_numpy(jax.tree.map(np.asarray, jep), tecfg, device="cpu")
    tlp = convert.params_from_numpy(jax.tree.map(np.asarray, jlp), tlcfg, device="cpu")
    return (
        tpw.TorchEmbedder(tecfg, tep, device="cpu"),
        tpw.TorchLMChat(tlcfg, tlp, max_new_tokens=8, device="cpu"),
    )


def _corpus(n_docs: int, n_q: int, waves: int, seed: int = 4):
    """bench.py's config-4 documents and streamed questions (seed 4)."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    docs = [((" ".join(rng.choice(words, 24))).encode(), {"path": f"d{i}.txt", "n": i}) for i in range(n_docs)]
    per_wave = n_q // waves
    questions = [" ".join(rng.choice(words, 6)) for _ in range(n_q)]
    q_rows = [(q, None, False, 2 * (i // per_wave) + 2, 1) for i, q in enumerate(questions)]
    return docs, questions, q_rows


def _resorted(result) -> list[tuple[float, str]]:
    items = result.value if hasattr(result, "value") else result
    return sorted((float(d["dist"]), d["metadata"]["path"]) for d in items)


def _assert_same_ranking(got, want):
    """Rank by rank after the (distance, path) re-sort: distances within
    DIST_ATOL, so two documents may swap only where their distances lie
    within DIST_ATOL of each other (a near-tie); and at most one swap in
    ten ranks."""
    assert len(got) == len(want)
    for (gd, _gp), (wd, _wp) in zip(got, want):
        assert abs(gd - wd) <= DIST_ATOL, (got, want)
    assert sum(gp != wp for (_gd, gp), (_wd, wp) in zip(got, want)) <= len(got) // 10, (got, want)


def _run_rag(pkg: str, embedder, chat, docs, questions, q_rows, *, k: int = 4):
    """The config-4 pipeline on `pkg`: answers per question and the
    store's top-k per question."""
    pw = importlib.import_module(pkg)
    DocumentStore = _mod(pkg, "xpacks.llm.document_store").DocumentStore
    qa = _mod(pkg, "xpacks.llm.question_answering")
    knn = _mod(pkg, "stdlib.indexing").BruteForceKnnFactory
    factory_kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), docs)
    store = DocumentStore(table, retriever_factory=knn(dimensions=EMB["embed_dim"], embedder=embedder, **factory_kw))
    answerer = qa.BaseRAGQuestionAnswerer(chat, store, search_topk=k)
    queries = pw.debug.table_from_rows(answerer.AnswerQuerySchema, q_rows, is_stream=True)
    answers = answerer.answer_query(queries)
    rq = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema, [(q, k, None, None) for q in questions]
    )
    retrieved = rq.select(query=rq.query).with_columns(result=store.retrieve_query(rq).result)
    got_answers: dict = {}
    got_docs: dict = {}
    pw.io.subscribe(
        queries.join(answers, queries.id == answers.id).select(q=queries.prompt, a=answers.result),
        on_change=lambda key, row, time, is_addition: got_answers.setdefault(row["q"], []).append(row["a"]),
    )
    pw.io.subscribe(
        retrieved,
        on_change=lambda key, row, time, is_addition: got_docs.setdefault(row["query"], _resorted(row["result"])),
    )
    pw.run()
    return got_answers, got_docs


def test_rag_pipeline_matches_the_jax_package_at_f32():
    """bench.py's config-4 rung at a small size (64 documents, 16
    questions in 4 waves): every question gets one answer, the answers
    are equal strings, and each question's top-4 documents agree at the
    (score, key) re-sort seam."""
    docs, questions, q_rows = _corpus(64, 16, 4)
    want_a, want_d = _run_rag("pathway_tpu", *_models("pathway_tpu"), docs, questions, q_rows)
    emb, chat = _models("pathway_tpu_torch")
    got_a, got_d = _run_rag("pathway_tpu_torch", emb, chat, docs, questions, q_rows)
    assert set(got_a) == set(questions)
    assert all(len(v) == 1 for v in got_a.values())
    for q in questions:
        assert [a.value["response"] for a in got_a[q]] == [a.value["response"] for a in want_a[q]]
        assert len(got_d[q]) == 4
        _assert_same_ranking(got_d[q], want_d[q])
    # the wave's texts went through the port's coalescer, not row by row
    assert emb._batcher.flushes < len(docs) + len(questions)


def _mock_pipeline(pkg: str, docs, q_rows, out: Path, filters: list[str]):
    pw = importlib.import_module(pkg)
    DocumentStore = _mod(pkg, "xpacks.llm.document_store").DocumentStore
    qa = _mod(pkg, "xpacks.llm.question_answering")
    mocks = _mod(pkg, "xpacks.llm.mocks")
    knn = _mod(pkg, "stdlib.indexing").BruteForceKnnFactory
    factory_kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    table = pw.debug.table_from_rows(pw.schema_from_types(data=bytes, _metadata=object), docs)
    store = DocumentStore(table, retriever_factory=knn(dimensions=16, embedder=mocks.FakeEmbedder(dim=16), **factory_kw))
    answerer = qa.BaseRAGQuestionAnswerer(mocks.IdentityMockChat(), store, search_topk=3)
    queries = pw.debug.table_from_rows(answerer.AnswerQuerySchema, q_rows, is_stream=True)
    pw.io.jsonlines.write(answerer.answer_query(queries), str(out / "answers.jsonl"))
    rq = pw.debug.table_from_rows(
        DocumentStore.RetrieveQuerySchema, [("alpha beta", 5, f, None) for f in filters]
    )
    filtered = rq.select(f=rq.metadata_filter).with_columns(result=store.retrieve_query(rq).result)
    pw.io.jsonlines.write(filtered, str(out / "filtered.jsonl"))
    pw.run()
    return (out / "answers.jsonl").read_bytes(), (out / "filtered.jsonl").read_bytes()


FILTERS = ["n < `10`", "path == 'd3.txt'", "globmatch('d1*', path)", "n >= `15` && n < `18`", 'contains(path, `"d2"`)']


def test_mock_answer_tables_and_filtered_retrieval_are_byte_equal(tmp_path):
    """With the mocks (`FakeEmbedder`, `IdentityMockChat`) both packages
    write the same answer table and the same metadata-filtered retrieval
    (filters go through `filters.compile_filter`), byte for byte."""
    docs, _questions, q_rows = _corpus(40, 12, 3, seed=9)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _mock_pipeline("pathway_tpu", docs, q_rows, tmp_path / "jax", FILTERS)
    got = _mock_pipeline("pathway_tpu_torch", docs, q_rows, tmp_path / "port", FILTERS)
    assert got == want
    answers, filtered = (b.decode().splitlines() for b in got)
    assert len(answers) == 12 and len(filtered) == len(FILTERS)
    # each filter's rows are the top of the documents its compiled
    # predicate keeps
    from pathway_tpu_torch.stdlib.indexing.filters import compile_filter

    for ln in filtered:
        row = json.loads(ln)
        pred = compile_filter(row["f"])
        keep = {d[1]["path"] for d in docs if pred(d[1])}
        paths = [d["metadata"]["path"] for d in row["result"]]
        assert set(paths) <= keep and len(paths) == min(5, len(keep)) > 0, (row["f"], paths)


def _clustered(n: int, seed: int = 0, dim: int = 32, n_clusters: int = 40) -> np.ndarray:
    """tests/test_ann_index.py's corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim))
    return (centers[rng.integers(0, n_clusters, n)] + 0.15 * rng.normal(size=(n, dim))).astype(np.float32)


def _ivf_rankings(pkg: str, vecs: np.ndarray, queries: np.ndarray):
    pw = importlib.import_module(pkg)
    factory_cls = _mod(pkg, "stdlib.indexing").IvfPqKnnFactory
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    factory = factory_cls(dimensions=vecs.shape[1], background_retrain=False, **kw)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(vec=object, name=str), [(tuple(map(float, v)), f"doc{i}") for i, v in enumerate(vecs)]
    )
    qs = pw.debug.table_from_rows(pw.schema_from_types(qvec=object, qid=int), [(tuple(map(float, q)), i) for i, q in enumerate(queries)])
    res = factory.build_index(docs.vec, docs).query_as_of_now(qs.qvec, number_of_matches=10, with_distances=True)
    out: dict = {}
    pw.io.subscribe(
        res,
        on_change=lambda key, row, time, is_addition: out.__setitem__(
            row["qid"], sorted(zip(map(float, row["_pw_index_reply_score"]), row["name"]))
        ),
    )
    pw.run()
    return out


def test_ivf_pq_knn_factory_rankings_match_the_jax_package():
    """`IvfPqKnnFactory` through the engine over tests/test_ann_index.py's
    corpus, past `train_min` so the IVF-PQ search (not the exact slab)
    answers: the same top-10 after the re-sort, distances within 1e-4."""
    vecs = _clustered(600, seed=0)
    queries = vecs[:12] + 0.01
    want = _ivf_rankings("pathway_tpu", vecs, queries)
    got = _ivf_rankings("pathway_tpu_torch", vecs, queries)
    assert sorted(got) == sorted(want) == list(range(12))
    for q in want:
        assert len(got[q]) == 10
        _assert_same_ranking(got[q], want[q])


def test_embedder_and_chat_are_udfs():
    """`TorchEmbedder` and `TorchLMChat` are `pw.UDF`s with async bodies,
    like `JaxEmbedder` and `JaxLMChat`."""
    import asyncio

    from pathway_tpu_torch.xpacks.llm.embedders import BaseEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import BaseChat

    emb, chat = _models("pathway_tpu_torch")
    assert isinstance(emb, BaseEmbedder) and isinstance(emb, tpw.UDF)
    assert isinstance(chat, BaseChat) and isinstance(chat, tpw.UDF)
    assert emb.get_embedding_dimension() == EMB["embed_dim"]
    vec = asyncio.run(emb.__wrapped__("the same text"))
    np.testing.assert_allclose(vec, emb.encode_many(["the same text"])[0], atol=1e-6)
    jemb, jchat = _models("pathway_tpu")
    np.testing.assert_allclose(vec, jemb.encode_many(["the same text"])[0], atol=1e-4)
    msgs = [{"role": "user", "content": "a question"}]
    assert asyncio.run(chat.__wrapped__(msgs)) == asyncio.run(jchat.__wrapped__(msgs))


# ------------------------------------------------------------------- app

_APP = r"""
import sys
sys.modules["tiktoken"] = None  # tiktoken fetches its encoding over the network on first use
pkg, corpus, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
pw = __import__(pkg)
import importlib
DocumentStore = importlib.import_module(pkg + ".xpacks.llm.document_store").DocumentStore
qa = importlib.import_module(pkg + ".xpacks.llm.question_answering")
mocks = importlib.import_module(pkg + ".xpacks.llm.mocks")
splitters = importlib.import_module(pkg + ".xpacks.llm.splitters")
knn = importlib.import_module(pkg + ".stdlib.indexing").BruteForceKnnFactory

# examples/adaptive_rag/app.py with --mock
docs = pw.io.fs.read(corpus, format="binary", with_metadata=True, mode="streaming", autocommit_duration_ms=200)
embedder = mocks.FakeEmbedder(dim=32)
llm = mocks.FakeChatModel()
store = DocumentStore(
    docs,
    # the port's index lives on the card unless the caller names the CPU
    retriever_factory=knn(dimensions=embedder.get_embedding_dimension(), embedder=embedder,
                          **({"device": "cpu"} if pkg == "pathway_tpu_torch" else {})),
    splitter=splitters.TokenCountSplitter(min_tokens=50, max_tokens=250),
)
answerer = qa.AdaptiveRAGQuestionAnswerer(llm, store)
answerer.run_server(host="127.0.0.1", port=port, with_cache=False)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, route: str, payload: dict, deadline: float, proc=None):
    last = None
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the app exited with {proc.returncode}: {proc.stderr.read()[-3000:]}")
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=10) as r:
                return json.loads(r.read().decode())
        except OSError as e:  # the server is still starting
            last = e
            time.sleep(0.25)
    raise AssertionError(f"no answer from 127.0.0.1:{port}{route}: {last}")


def _ask_app(pkg: str, corpus: Path, n_files: int) -> tuple:
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _APP, pkg, str(corpus), str(port)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:  # the streaming read indexes the corpus within a few commits
            stats = _post(port, "/v1/statistics", {}, deadline, proc)
            if isinstance(stats, dict) and stats.get("file_count", 0) >= n_files:
                break
            assert time.monotonic() < deadline, stats
            time.sleep(0.2)
        answer = _post(port, "/v1/pw_ai_answer", {"prompt": "what does the moon orbit"}, deadline)
        retrieved = _post(port, "/v1/retrieve", {"query": "moon orbit earth", "k": 2}, deadline)
        return answer, retrieved
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_app_answers_the_same_over_rest(tmp_path):
    """The app's pipeline (streaming fs read, TokenCountSplitter(50, 250),
    DocumentStore, AdaptiveRAGQuestionAnswerer, run_server) with the
    mocks, in a subprocess for each package: the same answer to one POST
    to /v1/pw_ai_answer, and the same chunks from /v1/retrieve."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    texts = {
        "moon.txt": "The moon orbits the earth. It takes about a month.",
        "fish.txt": "Fish live in water. Most breathe through gills.",
        "sun.txt": "The earth orbits the sun once a year.",
    }
    for name, text in texts.items():
        (corpus / name).write_text(text)
    want = _ask_app("pathway_tpu", corpus, len(texts))
    got = _ask_app("pathway_tpu_torch", corpus, len(texts))
    # `seen_at` is the wall-clock second each run read the file
    for _answer, retrieved in (want, got):
        for doc in retrieved:
            doc["metadata"].pop("seen_at")
    assert got == want
    assert "moon orbits the earth" in json.dumps(got[1])
